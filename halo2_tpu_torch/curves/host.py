"""Host-side (Python int) curve arithmetic: golden reference + small host ops.

Used for kernel golden tests, SRS generation helpers, and verifier-side scalar
work where device dispatch isn't worth it.  Points are (x, y) int tuples or
None for the identity.
"""

from __future__ import annotations

from .spec import CurveSpec


def on_curve(spec: CurveSpec, pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    p = spec.base.p
    return (y * y - x * x * x - spec.b) % p == 0


def neg(spec: CurveSpec, pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % spec.base.p)


def add(spec: CurveSpec, a, b):
    p = spec.base.p
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def double(spec: CurveSpec, a):
    return add(spec, a, a)


def mul(spec: CurveSpec, pt, k: int):
    k %= spec.scalar.p
    acc = None
    while k:
        if k & 1:
            acc = add(spec, acc, pt)
        pt = add(spec, pt, pt)
        k >>= 1
    return acc


def generator(spec: CurveSpec):
    return (spec.gx, spec.gy)


# ---------------------------------------------------------------------------
# Jacobian fast path (no per-add inversion) for bulk host work (SRS setup)
# ---------------------------------------------------------------------------

JAC_IDENTITY = (0, 0, 0)


def jac_double(spec: CurveSpec, pt):
    """Double a Jacobian (X, Y, Z) point (a=0 curves: dbl-2009-l)."""
    p = spec.base.p
    X1, Y1, Z1 = pt
    if Z1 == 0 or Y1 == 0:
        return JAC_IDENTITY
    A = X1 * X1 % p
    B = Y1 * Y1 % p
    C = B * B % p
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % p
    E = 3 * A % p
    F = E * E % p
    X3 = (F - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * C) % p
    Z3 = 2 * Y1 * Z1 % p
    return (X3, Y3, Z3)


def jac_add_mixed(spec: CurveSpec, pt, aff):
    """Jacobian += affine (madd-2007-bl); ``aff`` is an (x, y) tuple or None."""
    p = spec.base.p
    if aff is None:
        return pt
    X1, Y1, Z1 = pt
    x2, y2 = aff
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % p
    U2 = x2 * Z1Z1 % p
    S2 = y2 * Z1 % p * Z1Z1 % p
    H = (U2 - X1) % p
    if H == 0:
        if (S2 - Y1) % p != 0:
            return JAC_IDENTITY
        return jac_double(spec, pt)
    HH = H * H % p
    I = 4 * HH % p
    J = H * I % p
    r = 2 * (S2 - Y1) % p
    V = X1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * Y1 * J) % p
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
    return (X3, Y3, Z3)


def jac_batch_to_affine(spec: CurveSpec, pts):
    """Jacobian list -> affine (x, y)/None list with ONE modular inversion
    (Montgomery's trick over the z coordinates)."""
    p = spec.base.p
    zs = [pt[2] for pt in pts]
    prefix = [1] * (len(zs) + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * (z if z else 1) % p
    inv_total = pow(prefix[-1], -1, p)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        X, Y, Z = pts[i]
        if Z == 0:
            continue
        zinv = inv_total * prefix[i] % p
        inv_total = inv_total * Z % p
        zi2 = zinv * zinv % p
        out[i] = (X * zi2 % p, Y * zi2 % p * zinv % p)
    return out


def msm(spec: CurveSpec, scalars, points):
    """Naive host MSM (golden reference for the device Pippenger kernel)."""
    acc = None
    for k, pt in zip(scalars, points):
        acc = add(spec, acc, mul(spec, pt, k))
    return acc
