"""Branch-free elliptic-curve point operations over limb arrays.

Port of the JAX package's ``curves/point.py``.  Points are homogeneous
projective triples ``(x, y, z)`` of Montgomery-form limb tensors (shape
``(16, ...)`` each); the identity is ``(0, 1, 0)``.  ``ec_add`` and
``ec_double`` are the complete Renes–Costello–Batina formulas (a = 0),
through the K2 / K3 wrappers of ``curves/ec_kernels.py``.

Compare points in affine form (``to_affine_ints``): two algorithms that reach
the same point may leave different projective Z.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import limb
from ..fields.spec import NLIMBS, int_to_limbs
from . import ec_kernels
from .spec import CurveSpec


class Point(NamedTuple):
    """Projective point batch: three (16, ...) int32 limb tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[1:]


def identity(spec: CurveSpec, shape=(), device=None) -> Point:
    shape = tuple(shape)
    one = limb.const(int_to_limbs(spec.base.to_mont(1)), 1 + len(shape), device)
    zero = limb.zeros(shape, device)
    return Point(zero, one.expand((NLIMBS,) + shape).clone(), zero.clone())


def generator(spec: CurveSpec, device=None) -> Point:
    """The curve's generator as three unbatched (16,) limb vectors, z = 1."""
    f = spec.base
    return Point(
        limb.from_int(f, spec.gx, device), limb.from_int(f, spec.gy, device),
        limb.from_int(f, 1, device),
    )


def from_affine_ints(spec: CurveSpec, coords, device=None) -> Point:
    """List of (x, y) canonical-int pairs (or None for identity) -> batched Point."""
    f = spec.base
    xs, ys, zs = [], [], []
    for c in coords:
        if c is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(c[0]), ys.append(c[1]), zs.append(1)
    return Point(
        limb.from_ints(f, xs, device), limb.from_ints(f, ys, device), limb.from_ints(f, zs, device)
    )


def to_affine_ints(spec: CurveSpec, p: Point):
    """Batched Point -> list of (x, y) canonical int pairs / None for identity."""
    f = spec.base
    zinv = limb.finv(f, p.z)  # 0 -> 0, so identity maps to (0, 0)
    xs = limb.to_ints(f, limb.fmul(f, p.x, zinv))
    ys = limb.to_ints(f, limb.fmul(f, p.y, zinv))
    zs = limb.to_ints(f, p.z)
    return [None if z == 0 else (x, y) for x, y, z in zip(xs, ys, zs)]


def _flat(p):
    return tuple(c.reshape(NLIMBS, -1).contiguous() for c in p)


def ec_add(spec: CurveSpec, p: Point, q: Point) -> Point:
    """Complete projective addition of two same-shaped point batches (K2)."""
    shape = p.x.shape
    out = ec_kernels.ec_add(spec, _flat(p), _flat(q))
    return Point(*(c.reshape(shape) for c in out))


def ec_double(spec: CurveSpec, p: Point) -> Point:
    """Complete projective doubling of a point batch (K3)."""
    shape = p.x.shape
    out = ec_kernels.ec_double(spec, _flat(p))
    return Point(*(c.reshape(shape) for c in out))


def ec_neg(spec: CurveSpec, p: Point) -> Point:
    return Point(p.x, limb.fneg(spec.base, p.y), p.z)


def ec_select(cond, p: Point, q: Point) -> Point:
    """Pointwise select: where cond (batch-shaped) pick p else q."""
    return Point(
        limb.select(cond, p.x, q.x),
        limb.select(cond, p.y, q.y),
        limb.select(cond, p.z, q.z),
    )


def is_identity(p: Point):
    return limb.is_zero(p.z)


def batch_normalize(spec: CurveSpec, p: Point) -> Point:
    """Projective -> affine-with-z=1 (identity stays (0, *, 0) via inv(0)=0)."""
    f = spec.base
    zinv = limb.finv(f, p.z)
    one = limb.one_like(f, p.x)
    z = limb.select(limb.is_zero(p.z), p.z, one)
    return Point(limb.fmul(f, p.x, zinv), limb.fmul(f, p.y, zinv), z)
