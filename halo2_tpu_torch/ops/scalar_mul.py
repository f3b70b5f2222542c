"""Batched per-lane scalar multiplication: out[i] = k[i] * P[i].

Port of the JAX package's ``ops/scalar_mul.py``.  Used by the device SRS
setup, the group NTT of ``ops/gntt.py`` and the IPA generator fold.
Double-and-add over 256 bits, low bit first, in one launch of K3's chain
entry ``ec_scalar_mul`` (``curves/ec_kernels.py``), where the JAX package runs
one ``fori_loop``; the whole batch rides the point axis.
"""

from __future__ import annotations

from ..curves import ec_kernels
from ..curves.point import Point
from ..curves.spec import CurveSpec
from ..fields import limb
from ..fields.spec import NLIMBS


def batch_scalar_mul(spec: CurveSpec, scalars_mont, points: Point) -> Point:
    """scalars_mont: (16, n) Montgomery scalar-field limbs; points batched (n)."""
    canon = limb.from_mont(spec.scalar, scalars_mont).reshape(NLIMBS, -1).contiguous()
    shape = points.x.shape
    flat = tuple(c.reshape(NLIMBS, -1).contiguous() for c in points)
    out = ec_kernels.ec_scalar_mul(spec, canon, flat)
    return Point(*(c.reshape(shape) for c in out))
