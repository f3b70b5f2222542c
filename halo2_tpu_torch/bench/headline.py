"""Headline benchmark: the MSM rate (BN254 G1, 2^16 points) on one card.

    python -m halo2_tpu_torch.bench.headline

Port of ``bench.py``.  Prints ONE JSON line: ``msm_bn254_points_per_sec_k16``
(``bench.full.bench_msm``'s operands and method, 5 calls after a warm-up)
and beside it

- ``ec_adds_per_sec_msm``: the rate times the complete adds per point of the
  signed-digit Straus MSM, ceil(256/c) + 2^(c-1) - 1 (67 at c = 5);
- ``ec_adds_per_sec_peak_kernel``: K2 (``curves.ec_kernels.ec_add``) on 2^21
  copies of one point, the JAX bench's broadcast operands (x, y, x), CUDA
  events over 8 launches; ``mfu_vs_ec_add_peak`` is the first over this;
- ``field_muls_per_sec_msm``: 12 Montgomery products per complete add;
- ``msm_u32_ops_per_sec`` and ``mfu_vs_vpu_arch_peak``: those products'
  32-bit multiply-adds (136 per 8-word CIOS product) per second, and their
  share of this card's 32-bit integer issue rate on one pipe
  (``bench.roofline``'s ``int32_arch_peak_per_sec_est``: SMs x 64 lanes x the
  maximum SM clock).  The JAX bench's denominator, a TPU v5e's VPU model
  from ``ROOFLINE.json``, is not read.

``vs_baseline`` divides by BASELINE.md's CPU estimate for the reference's
``best_multiexp`` at 2^16 (1.0e6 points/s), as ``bench.py`` does.  The card's
name and power limit are printed on the line before.
"""

from __future__ import annotations

import json

import torch

from ..curves import ec_kernels
from ..curves.spec import BN254_G1
from ..ops.msm import choose_window, msm
from . import roofline
from .full import CPU_MSM_BASELINE, card_name, msm_operands, on_device, rate

K = 16
REPS = 5
PEAK_N = 1 << 21
PEAK_REPS = 8
PRODUCT_MULS = 2 * 8 * 8 + 8  # 32-bit multiply-adds of one 8-word CIOS Montgomery product


def adds_per_point(n: int) -> int:
    """Complete adds per point of ``msm_many`` at n points (its window c)."""
    c = choose_window(n)
    return (256 + c - 1) // c + (1 << (c - 1)) - 1


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the headline runs on a CUDA card; torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    curve, n = BN254_G1, 1 << K
    scalars, points = msm_operands(K, dev)
    on_device(dev, scalars, *points)
    msm_rate = rate(n, lambda: msm(curve, scalars, points), REPS, dev)
    msm_adds = msm_rate * adds_per_point(n)

    trip = tuple(c[:, :1].expand(16, PEAK_N).contiguous() for c in (points.x, points.y, points.x))
    add_ms = roofline.event_ms(lambda: ec_kernels.ec_add(curve, trip, trip), PEAK_REPS)
    peak_adds = PEAK_N / (add_ms * 1e-3)

    props = torch.cuda.get_device_properties(dev)
    arch = roofline.arch_int32_per_sec(props.multi_processor_count,
                                       float(roofline._smi("clocks.max.sm")))
    muladds = msm_adds * 12 * PRODUCT_MULS
    line = {
        "metric": f"msm_bn254_points_per_sec_k{K}",
        "value": msm_rate,
        "unit": "points/sec",
        "vs_baseline": msm_rate / CPU_MSM_BASELINE,
        "ec_adds_per_sec_msm": msm_adds,
        "ec_adds_per_sec_peak_kernel": peak_adds,
        "field_muls_per_sec_msm": msm_adds * 12,
        "mfu_vs_ec_add_peak": msm_adds / peak_adds,
        "msm_u32_ops_per_sec": muladds,
        "int32_arch_peak_per_sec_est": arch,
        "mfu_vs_vpu_arch_peak": muladds / arch,
    }
    print(card_name(), flush=True)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
