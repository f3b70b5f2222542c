"""K2 / K3: complete EC add and double on (16, n) int32 coordinate arrays.

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
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..fields import limb
from ..fields.mont_mul import mont_mul_plain
from ..fields.spec import NLIMBS, int_to_limbs
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


def _launch_args(curve: CurveSpec):
    words, n0 = _cuda.modulus_args(curve.base)
    return words, n0, 3 * curve.b


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
    words, n0, b3 = _launch_args(curve)
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
    words, n0, b3 = _launch_args(curve)
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
