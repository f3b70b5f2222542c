"""Derive the SSWU 3-isogeny constants for the Pasta curves from scratch.

The reference repo never ships these constants (they live in the upstream
pasta_curves crate); this module re-derives them with Velu's formulas so the
pinned values in ``sswu.py`` are *checked mathematics*, not transcription:

1. The iso curve is a curve ``(a, b=1265)`` that is 3-isogenous to the target
   ``(0, 5)``.  Candidates are found by pushing the target through each of its
   rational order-3 subgroups (Velu), matching j-invariants, and taking cube
   roots — which yields exactly three iso-a values per target.
2. The published choice (verified bit-for-bit against the reference's
   SINSEMILLA_S table for Pallas) is then pinned by two canonical facts that
   hold for both curves: the Velu map is composed with the curve isomorphism
   ``u = 1/3`` (so the codomain of the raw Velu step is ``(0, 5 * 3^6)``),
   and the kernel is the unique psi_3 root of the iso curve whose Velu
   codomain has a = 0.

``derive_iso(spec, iso_a)`` reconstructs the 13 isogeny-map constants from
those choices; tests/test_sswu.py asserts they equal the pinned tables.
"""

from __future__ import annotations

import random

from .spec import CurveSpec


def cube_roots(v: int, p: int) -> list[int]:
    """All cube roots of v mod p (p = 1 mod 3), ascending."""
    v %= p
    if v == 0:
        return [0]
    if pow(v, (p - 1) // 3, p) != 1:
        return []
    t, m = 0, p - 1
    while m % 3 == 0:
        m //= 3
        t += 1
    rng = random.Random(1)
    while True:
        u = rng.randrange(2, p)
        if pow(u, (p - 1) // 3, p) != 1:
            break
    g3 = pow(u, m, p)  # generator of the 3-Sylow subgroup (order 3^t)
    x = pow(v, pow(3, -1, m), p)  # cube root up to a 3-Sylow element
    rem = v * pow(x, -3, p) % p
    # discrete log of rem in <g3> (t is tiny for the pasta fields)
    sub, cur = {}, 1
    for k in range(3**t):
        sub[cur] = k
        cur = cur * g3 % p
    k = sub[rem]
    assert k % 3 == 0 or t == 0
    r0 = x * pow(g3, k // 3 if t else 0, p) % p
    w = pow(g3, 3 ** (t - 1), p) if t else 1  # primitive cube root of unity
    roots = sorted({r0, r0 * w % p, r0 * w % p * w % p})
    assert all(pow(r, 3, p) == v for r in roots)
    return roots


def poly_roots(coeffs: list[int], p: int) -> list[int]:
    """Roots in Fp of a polynomial (coeffs low-to-high), via gcd(x^p - x, f)
    and Cantor–Zassenhaus equal-degree splitting."""
    rng = random.Random(7)

    def pmod(a, m):
        a = a[:]
        while len(a) >= len(m):
            c = a[-1] * pow(m[-1], -1, p) % p
            off = len(a) - len(m)
            for i in range(len(m)):
                a[off + i] = (a[off + i] - c * m[i]) % p
            while a and a[-1] == 0:
                a.pop()
        return a

    def pmul(a, b, m=None):
        r = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    r[i + j] = (r[i + j] + ai * bj) % p
        return pmod(r, m) if m else r

    def ppow(a, e, m):
        r = [1]
        a = pmod(a, m)
        while e:
            if e & 1:
                r = pmul(r, a, m)
            a = pmul(a, a, m)
            e >>= 1
        return r

    def pgcd(a, b):
        while b:
            a, b = b, pmod(a, b)
        if a:
            inv = pow(a[-1], -1, p)
            a = [c * inv % p for c in a]
        return a

    def pdiv(a, b):
        a, q = a[:], [0] * (len(a) - len(b) + 1)
        while len(a) >= len(b):
            c = a[-1] * pow(b[-1], -1, p) % p
            q[len(a) - len(b)] = c
            for i in range(len(b)):
                a[len(a) - len(b) + i] = (a[len(a) - len(b) + i] - c * b[i]) % p
            while a and a[-1] == 0:
                a.pop()
        return q

    f = [c % p for c in coeffs]
    while f and f[-1] == 0:
        f.pop()
    xp = ppow([0, 1], p, f)
    xp = xp + [0] * (2 - len(xp))
    g = pgcd(f, pmod([(c - (1 if i == 1 else 0)) % p for i, c in enumerate(xp)], f))
    roots: list[int] = []

    def split(h):
        d = len(h) - 1
        if d <= 0:
            return
        if d == 1:
            roots.append((-h[0]) * pow(h[1], -1, p) % p)
            return
        while True:
            t = ppow([rng.randrange(p), 1], (p - 1) // 2, h)
            t = [(c - (1 if i == 0 else 0)) % p for i, c in enumerate(t + [0])]
            while t and t[-1] == 0:
                t.pop()
            d1 = pgcd(h, t) if t else []
            if d1 and 0 < len(d1) - 1 < d:
                split(d1)
                split(pdiv(h, d1))
                return

    if g:
        split(g)
    return sorted(roots)


def velu3(p: int, a: int, b: int, x0: int) -> tuple[int, int]:
    """Codomain (a2, b2) of the Velu 3-isogeny from (a, b) with kernel x0."""
    v = 2 * (3 * x0 * x0 + a) % p
    u = 4 * ((x0 * x0 % p * x0 + a * x0 + b) % p) % p
    w = (u + x0 * v) % p
    return (a - 5 * v) % p, (b - 7 * w) % p


def iso_a_candidates(spec: CurveSpec, iso_b: int = 1265) -> list[int]:
    """The three iso-a values for curves (a, iso_b) 3-isogenous to spec."""
    p, b = spec.base.p, spec.b
    # psi_3 of (0, b) is 3x(x^3 + 4b)
    kernel_xs = [0] + cube_roots((-4 * b) % p, p)
    out: set[int] = set()
    for x0 in kernel_xs:
        a2, b2 = velu3(p, 0, b, x0)
        num = 6912 * pow(a2, 3, p) % p
        den = (4 * pow(a2, 3, p) + 27 * b2 * b2) % p
        j = num * pow(den, -1, p) % p
        if (6912 - 4 * j) % p == 0:
            continue
        a3 = 27 * iso_b * iso_b % p * j % p * pow((6912 - 4 * j) % p, -1, p) % p
        out.update(cube_roots(a3, p))
    return sorted(out)


def derive_iso(spec: CurveSpec, iso_a: int, iso_b: int = 1265) -> list[int]:
    """The 13 isogeny-map constants for (iso_a, iso_b) -> spec with u = 1/3."""
    p = spec.base.p
    u = pow(3, -1, p)
    # kernel: psi_3 root of the iso curve whose Velu codomain has a = 0
    psi3 = [(-iso_a * iso_a) % p, 12 * iso_b % p, 6 * iso_a % p, 0, 3]
    for x0 in poly_roots(psi3, p):
        a2, b2 = velu3(p, iso_a, iso_b, x0)
        if a2 == 0 and pow(u, 6, p) * b2 % p == spec.b % p:
            break
    else:
        raise ValueError("no valid kernel found — wrong iso_a?")
    v = 2 * (3 * x0 * x0 + iso_a) % p
    uu = 4 * ((x0**3 + iso_a * x0 + iso_b) % p) % p
    u2, u3 = u * u % p, u * u % p * u % p
    # X(x) = N(x)/(x-x0)^2, N = x(x-x0)^2 + v(x-x0) + uu; final X' = u^2 X
    nx = [(uu - v * x0) % p, (x0 * x0 + v) % p, (-2 * x0) % p, 1]
    # Y(x, y) = y * M(x)/(x-x0)^3, M = N'(x)*(x-x0) - 2N; final Y' = u^3 Y
    np_ = [(x0 * x0 + v) % p, (-4 * x0) % p, 3]
    m = [0, 0, 0, 0]
    for i, c in enumerate(np_):
        m[i + 1] = (m[i + 1] + c) % p
        m[i] = (m[i] - c * x0) % p
    for i, c in enumerate(nx):
        m[i] = (m[i] - 2 * c) % p
    return [
        u2 * nx[3] % p, u2 * nx[2] % p, u2 * nx[1] % p, u2 * nx[0] % p,
        (-2 * x0) % p, x0 * x0 % p,
        u3 * m[3] % p, u3 * m[2] % p, u3 * m[1] % p, u3 * m[0] % p,
        (-3 * x0) % p, 3 * x0 * x0 % p, (-(x0**3)) % p,
    ]
