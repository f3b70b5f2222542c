"""Batched per-lane scalar multiplication: out[i] = k[i] * P[i].

Port of the JAX package's ``ops/scalar_mul.py``.  Used by the device SRS
setup, the group NTT of ``ops/gntt.py`` and the IPA generator fold.
Branch-free double-and-add over 256 bits, low bit first, as a Python loop of
complete adds (K2), doubles (K3) and selects; the whole batch rides the
point axis.  The scalar bits are extracted once, up front, from non-negative
int32 limbs, so no shift ever meets a negative value.
"""

from __future__ import annotations

import torch

from ..curves.point import Point, ec_add, ec_double, ec_select, identity
from ..curves.spec import CurveSpec
from ..fields import limb
from ..fields.spec import LIMB_BITS, NLIMBS


def scalar_bits(spec, scalars_mont) -> torch.Tensor:
    """(16, n) Montgomery scalar limbs -> (256, n) bool bits, low bit first."""
    canon = limb.from_mont(spec, scalars_mont)
    shifts = torch.arange(LIMB_BITS, dtype=canon.dtype, device=canon.device)
    bits = (canon.unsqueeze(1) >> shifts.reshape(1, LIMB_BITS, 1)) & 1
    return bits.reshape(NLIMBS * LIMB_BITS, -1).bool()


def batch_scalar_mul(spec: CurveSpec, scalars_mont, points: Point) -> Point:
    """scalars_mont: (16, n) Montgomery scalar-field limbs; points batched (n)."""
    bits = scalar_bits(spec.scalar, scalars_mont)
    acc = identity(spec, (bits.shape[1],), scalars_mont.device)
    base = points
    for i in range(bits.shape[0]):
        acc = ec_select(bits[i], ec_add(spec, acc, base), acc)
        base = ec_double(spec, base)
    return acc
