"""cost-model.rs analog: estimate the prover's MSM time for a circuit shape
from the MSM rate measured on the card (``examples/cost_model.py`` ported).

    python -m halo2_tpu_torch.examples.cost_model --k 14 [--measure-k 10]
"""

from __future__ import annotations

import argparse

import torch

from ..bench.full import msm_operands, rate
from ..curves.spec import BN254_G1
from ..ops.msm import msm

REPS = 3


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=12, help="log2 circuit rows")
    ap.add_argument("--advice", type=int, default=3)
    ap.add_argument("--lookups", type=int, default=1)
    ap.add_argument("--permutations", type=int, default=4)
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--measure-k", type=int, default=10, help="MSM size for rate measurement")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the cost model measures on a CUDA card; none is available")

    # points/sec of REPS calls of ops.msm.msm at 2^measure_k after a warm-up
    scalars, points = msm_operands(args.measure_k, "cuda")
    msm_rate = rate(1 << args.measure_k, lambda: msm(BN254_G1, scalars, points), REPS, "cuda")
    n = 1 << args.k
    chunks = (args.permutations + args.degree - 3) // max(args.degree - 2, 1)
    # commitments of size n during proving (prover.rs / SURVEY.md §3.2)
    msms = (
        args.advice                      # advice columns
        + 3 * args.lookups               # permuted input/table + product
        + chunks                         # permutation z per chunk
        + 1                              # vanishing random poly
        + (args.degree - 1)              # h pieces
        + 1                              # multiopen witness (scheme-dependent)
    )
    est = msms * n / msm_rate
    print(f"measured MSM rate @2^{args.measure_k} on the card: {msm_rate:,.0f} points/sec")
    print(f"estimated k={args.k} prover MSM time: {est:.2f}s ({msms} MSMs of 2^{args.k})")
    return est


if __name__ == "__main__":
    main()
