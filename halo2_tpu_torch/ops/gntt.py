"""Radix-2 NTT over *curve points* (additive group transform).

Port of the JAX package's ``ops/gntt.py``.  The reference's ``best_fft`` is
generic over ``halo2curves::Group``, so the same FFT runs over scalars and
over curve points; ``g_to_lagrange`` (arithmetic.rs:277-301) uses it to turn
the IPA monomial SRS into the Lagrange SRS.  Each butterfly is t = twiddle *
hi (the per-lane double-and-add of ``ops/scalar_mul.py``: K2 and K3),
out0 = lo + t, out1 = lo - t (K2); every butterfly of a stage is one batch.
"""

from __future__ import annotations

import torch

from ..curves.point import Point, ec_add, ec_neg
from ..curves.spec import CurveSpec
from ..fields import limb
from ..fields.spec import NLIMBS
from .ntt import bitrev_indices, power_table
from .scalar_mul import batch_scalar_mul


def group_ntt(spec: CurveSpec, points: Point, twiddles, k: int) -> Point:
    """DFT of a batched Point array of length 2^k over the scalar field.

    ``twiddles``: (16, 2^(k-1)) Montgomery power table of the domain generator.
    """
    n = 1 << k
    rev = bitrev_indices(k, points.x.device)
    a = Point(*(c[:, rev] for c in points))
    for s in range(1, k + 1):
        half = 1 << (s - 1)
        groups = n // (2 * half)
        tw = twiddles[:, :: 1 << (k - s)][:, :half]  # (16, half)
        pairs = [c.reshape(NLIMBS, groups, 2, half) for c in a]
        lo = Point(*(c[:, :, 0].reshape(NLIMBS, n // 2) for c in pairs))
        hi = Point(*(c[:, :, 1].reshape(NLIMBS, n // 2) for c in pairs))
        t = batch_scalar_mul(spec, tw.repeat(1, groups), hi)
        out0 = ec_add(spec, lo, t)
        out1 = ec_add(spec, lo, ec_neg(spec, t))
        a = Point(*(
            torch.stack([c0.reshape(NLIMBS, groups, half), c1.reshape(NLIMBS, groups, half)],
                        dim=2).reshape(NLIMBS, n)
            for c0, c1 in zip(out0, out1)
        ))
    return a


def g_to_lagrange(spec: CurveSpec, g: Point, k: int) -> Point:
    """Monomial-basis SRS -> Lagrange-basis SRS (arithmetic.rs:277-301):
    inverse group NTT with omega^-1 twiddles, scaled by 1/n."""
    fr = spec.scalar
    n = 1 << k
    dev = g.x.device
    omega_inv = pow(pow(fr.root_of_unity, 1 << (fr.s - k), fr.p), -1, fr.p)
    tw_inv = power_table(fr, omega_inv, max(n // 2, 1), dev)
    out = group_ntt(spec, g, tw_inv, k)
    scale = limb.from_int(fr, pow(n, -1, fr.p), dev).reshape(NLIMBS, 1).expand(NLIMBS, n)
    return batch_scalar_mul(spec, scale.contiguous(), out)
