"""K2 / K3: complete EC add and double on (16, n) int32 coordinate arrays,
and K3's two chain entries.

``ec_add`` and ``ec_double`` wrap the CUDA kernels of ``csrc/ec.cu``, which
replace the JAX package's Pallas kernels ``curves/pallas_ec.py``
``_ec_add_pallas`` and ``_ec_double_pallas`` (bodies ``ec_add_body`` and
``ec_double_body``: Renes–Costello–Batina 2016 Algorithms 7 and 9, a = 0).
A point batch is a triple (x, y, z) of (16, n) Montgomery limb arrays in
homogeneous projective form; the identity is (0, 1, 0).

Tensors on the CPU take ``ec_add_plain`` / ``ec_double_plain``: the same
formulas over plain torch field ops, with independent products and sums
batched as in the JAX package's ``curves/point.py``.  Every intermediate is
the same field value as in the kernel, so kernel and plain outputs agree limb
for limb, projective coordinates included.  A CUDA tensor launches the kernel
or raises.

The chain entries run a whole chain of K3 (with K2's body) in one launch,
each point's chain in one thread's registers, where the JAX package runs one
``fori_loop`` in one jitted program:

- ``ec_scalar_mul``: k_i * P_i per lane by double-and-add over the 256 bits
  of k_i, low bit first (the loop of ``ops/scalar_mul.py``
  ``batch_scalar_mul``);
- ``ec_horner``: the window fold of ``ops/msm.py`` ``msm_many``, c doublings
  and one add per window.

Their plain versions, ``ec_scalar_mul_plain`` and ``ec_horner_plain``, are the
same loops over ``ec_add_plain`` / ``ec_double_plain``.
"""

from __future__ import annotations

import functools

import torch

from .. import _cuda
from ..fields import limb
from ..fields.mont_mul import mont_mul_plain
from ..fields.spec import LIMB_BITS, NLIMBS, int_to_limbs
from .spec import CurveSpec


def _mul(f, a, b):
    """Broadcasting Montgomery product through the plain K1 version only."""
    a, b = torch.broadcast_tensors(a, b)
    out = mont_mul_plain(f, a.reshape(NLIMBS, -1), b.reshape(NLIMBS, -1))
    return out.reshape(a.shape)


def _stk(*xs):
    return torch.stack(xs, dim=1)  # (16, m, n) batched field elements


def _b3(curve: CurveSpec, like):
    return limb.const(int_to_limbs(curve.base.to_mont(3 * curve.b)), like.dim(), like.device)


def ec_add_plain(curve: CurveSpec, p, q):
    """Complete projective addition (RCB Algorithm 7, a = 0) in torch ops.

    Independent additions are stacked into one batched ``fadd``/``fsub``
    (each costs the same ~130 small ops whatever its width).
    """
    f = curve.base
    add = lambda a, b: limb.fadd(f, a, b)
    sub = lambda a, b: limb.fsub(f, a, b)
    x1, y1, z1 = p
    x2, y2, z2 = q

    s = add(_stk(x1, y1, x1, x2, y2, x2), _stk(y1, z1, z1, y2, z2, z2))
    m = _mul(f, torch.cat([_stk(x1, y1, z1), s[:, :3]], dim=1),
             torch.cat([_stk(x2, y2, z2), s[:, 3:]], dim=1))
    # [x1x2, y1y2, z1z2, (x1+y1)(x2+y2), (y1+z1)(y2+z2), (x1+z1)(x2+z2)]
    t0, t1, t2 = m[:, 0], m[:, 1], m[:, 2]
    pairs = add(_stk(t0, t1, t0, t0), _stk(t1, t2, t2, t0))  # [.., .., .., 2*t0]
    d = sub(m[:, 3:6], pairs[:, :3])
    t3, t4, y3 = d[:, 0], d[:, 1], d[:, 2]  # x1y2+x2y1, y1z2+y2z1, x1z2+x2z1

    mb = _mul(f, _stk(t2, y3), _b3(curve, _stk(t2, y3)))
    t2b, y3b = mb[:, 0], mb[:, 1]
    e = add(_stk(pairs[:, 3], t1), _stk(t0, t2b))
    t0x3, z3 = e[:, 0], e[:, 1]  # 3*t0, t1 + 3b*t2
    t1m = sub(t1, t2b)

    m2 = _mul(f, _stk(t3, t4, y3b, t1m, z3, t0x3), _stk(t1m, y3b, t0x3, z3, t4, t3))
    # [t3*t1m, t4*y3b, y3b*t0x3, t1m*z3, z3*t4, t0x3*t3]
    x3 = sub(m2[:, 0], m2[:, 1])
    fin = add(_stk(m2[:, 2], m2[:, 4]), _stk(m2[:, 3], m2[:, 5]))
    return x3, fin[:, 0], fin[:, 1]


def ec_double_plain(curve: CurveSpec, p):
    """Complete projective doubling (RCB Algorithm 9, a = 0) in torch ops."""
    f = curve.base
    add = lambda a, b: limb.fadd(f, a, b)
    x, y, z = p
    m = _mul(f, _stk(y, y, z, x), _stk(y, z, z, y))  # [y^2, yz, z^2, xy]
    t0, t1, zz, xy = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    t2 = _mul(f, zz, _b3(curve, zz))

    a1 = add(_stk(t0, t2, t0), _stk(t0, t2, t2))  # [2t0, 2t2, y3 = t0 + t2]
    a2 = add(_stk(a1[:, 0], a1[:, 1]), _stk(a1[:, 0], t2))  # [4t0, 3t2]
    z3 = add(a2[:, 0], a2[:, 0])  # 8y^2
    t0m = limb.fsub(f, t0, a2[:, 1])

    m2 = _mul(f, _stk(t2, t1, t0m, t0m), _stk(z3, z3, a1[:, 2], xy))
    # [t2*z3, t1*z3, t0m*y3, t0m*xy]
    fin = add(_stk(m2[:, 0], m2[:, 3]), _stk(m2[:, 2], m2[:, 3]))
    return fin[:, 1], fin[:, 0], m2[:, 1]


@functools.lru_cache(maxsize=None)
def launch_args(curve: CurveSpec):
    """(p words, n0, 3b, R mod p words) for the base field, built once per curve."""
    words, n0 = _cuda.modulus_args(curve.base)
    return words, n0, 3 * curve.b, _cuda.words_arg(curve.base.r)


def ec_add(curve: CurveSpec, p, q):
    """Complete EC add of two (x, y, z) triples of (16, n) int32 arrays (K2)."""
    coords = tuple(p) + tuple(q)
    if all(c.device.type == "cpu" for c in coords):
        return ec_add_plain(curve, p, q)
    n = _cuda.check_operands("ec_add", *coords)
    out = tuple(torch.empty_like(coords[0]) for _ in range(3))
    if n == 0:
        return out
    lib = _cuda.library()
    words, n0, b3, _ = launch_args(curve)
    with torch.cuda.device(coords[0].device):
        rc = lib.h2_ec_add(
            *[c.data_ptr() for c in coords + out], n, words, n0, b3,
            _cuda.stream_ptr(coords[0]),
        )
    _cuda.check(rc, "ec_add")
    ec_add.launches += 1
    return out


def ec_double(curve: CurveSpec, p):
    """Complete EC double of an (x, y, z) triple of (16, n) int32 arrays (K3)."""
    coords = tuple(p)
    if all(c.device.type == "cpu" for c in coords):
        return ec_double_plain(curve, p)
    n = _cuda.check_operands("ec_double", *coords)
    out = tuple(torch.empty_like(coords[0]) for _ in range(3))
    if n == 0:
        return out
    lib = _cuda.library()
    words, n0, b3, _ = launch_args(curve)
    with torch.cuda.device(coords[0].device):
        rc = lib.h2_ec_double(
            *[c.data_ptr() for c in coords + out], n, words, n0, b3,
            _cuda.stream_ptr(coords[0]),
        )
    _cuda.check(rc, "ec_double")
    ec_double.launches += 1
    return out


ec_add.launches = 0
ec_double.launches = 0


def _identity_like(curve: CurveSpec, x):
    one = limb.const(curve.base.r_limbs, x.dim(), x.device)
    return torch.zeros_like(x), one.expand(x.shape).clone(), torch.zeros_like(x)


def ec_scalar_mul_plain(curve: CurveSpec, scalars, p):
    """k_i * P_i by double-and-add over the 256 bits of k_i, low bit first:
    acc = bit ? acc + base : acc; base = 2 base.  ``scalars`` are canonical
    (16, n) scalar-field limbs (not Montgomery form), non-negative int32, so
    no shift meets a negative value."""
    shifts = torch.arange(LIMB_BITS, dtype=scalars.dtype, device=scalars.device)
    bits = (scalars.unsqueeze(1) >> shifts.reshape(1, LIMB_BITS, 1)) & 1
    bits = bits.reshape(NLIMBS * LIMB_BITS, -1).bool()
    acc = _identity_like(curve, p[0])
    base = tuple(p)
    for i in range(NLIMBS * LIMB_BITS):
        added = ec_add_plain(curve, acc, base)
        acc = tuple(torch.where(bits[i].unsqueeze(0), a, b) for a, b in zip(added, acc))
        base = ec_double_plain(curve, base)
    return acc


def ec_scalar_mul(curve: CurveSpec, scalars, p):
    """k_i * P_i for canonical (16, n) scalar limbs and an (x, y, z) triple of
    (16, n) int32 arrays (K3's chain entry, with K2's body): one launch."""
    coords = (scalars,) + tuple(p)
    if all(c.device.type == "cpu" for c in coords):
        return ec_scalar_mul_plain(curve, scalars, p)
    n = _cuda.check_operands("ec_scalar_mul", *coords)
    out = tuple(torch.empty_like(coords[1]) for _ in range(3))
    if n == 0:
        return out
    lib = _cuda.library()
    words, n0, b3, one = launch_args(curve)
    with torch.cuda.device(scalars.device):
        rc = lib.h2_ec_scalar_mul(
            *[c.data_ptr() for c in coords + out], n, words, n0, b3, one,
            _cuda.stream_ptr(scalars),
        )
    _cuda.check(rc, "ec_scalar_mul")
    ec_scalar_mul.launches += 1
    return out


ec_scalar_mul.launches = 0


def ec_horner_plain(curve: CurveSpec, sums, c: int):
    """The window fold of ``msm_many``: ``sums`` is an (x, y, z) triple of
    (16, m, W) window sums; acc = S[W-1], then for each earlier window w, c
    doublings and acc + S[w].  Returns an (x, y, z) triple of (16, m)."""
    w = sums[0].shape[2]
    acc = tuple(s[:, :, w - 1].contiguous() for s in sums)
    for wi in range(w - 2, -1, -1):
        for _ in range(c):
            acc = ec_double_plain(curve, acc)
        acc = ec_add_plain(curve, acc, tuple(s[:, :, wi].contiguous() for s in sums))
    return acc


def ec_horner(curve: CurveSpec, sums, c: int):
    """``ec_horner_plain``'s fold (K3's chain entry, with K2's body): one launch,
    one thread per column."""
    if c < 1:
        raise ValueError(f"ec_horner: the window width must be >= 1, got {c}")
    if all(s.device.type == "cpu" for s in sums):
        return ec_horner_plain(curve, sums, c)
    shapes = {tuple(s.shape) for s in sums}
    if len(shapes) != 1 or len(sums[0].shape) != 3 or sums[0].shape[2] < 1:
        raise ValueError(f"ec_horner: sums must share one (16, m, W) shape, W >= 1, got {shapes}")
    _, m, w = sums[0].shape
    flat = tuple(s.contiguous().reshape(NLIMBS, m * w) for s in sums)
    _cuda.check_operands("ec_horner", *flat)
    out = tuple(torch.empty((NLIMBS, m), dtype=torch.int32, device=flat[0].device)
                for _ in range(3))
    if m == 0:
        return out
    lib = _cuda.library()
    words, n0, b3, _ = launch_args(curve)
    with torch.cuda.device(flat[0].device):
        rc = lib.h2_ec_horner(
            *[t.data_ptr() for t in flat + out], m, w, c, words, n0, b3,
            _cuda.stream_ptr(flat[0]),
        )
    _cuda.check(rc, "ec_horner")
    ec_horner.launches += 1
    return out


ec_horner.launches = 0
