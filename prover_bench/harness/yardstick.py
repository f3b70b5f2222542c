"""The yardstick: the card's peaks and the least work of a proof's MSMs,
reckoned from the configuration's constraint system (the reference's own
account of it), never from the port's calls, windows or formulas.

Peaks of one NVIDIA H100 SXM at its 700 W limit:
  * 32-bit integer multiply-adds: 132 SMs x 64 lanes x 1.98 GHz = 1.6727e13/s;
  * HBM3: 3.35e12 bytes/s.

The MSMs one KZG/GWC proof needs, each over n = 2^k bases: one commitment
per advice column, three per lookup (permuted input, permuted table,
product), one per permutation product set, the vanishing argument's random
polynomial, (degree - 1) quotient pieces, and the openings' MSMs, which
the multiopen scheme's own reference file counts from the number of distinct
points (``reference/multiopen_<name>.py``'s ``opening_msms``; GWC: one
witness a point).  The points are the rotations of the advice and fixed
queries, x and omega*x for the permutation, omega^-(blinding + 1)*x when it
has more than one set, omega^-1*x and omega*x for lookups; KZG opens no
instance column.

Least work of one MSM of n 254-bit scalars:
  * group additions: n * 254 / log2(n * 254), Pippenger's bound for a
    multi-exponentiation, which signed digits, the GLV split (2n scalars of
    127 bits: the same product n * 254) and bucket methods do not undercut;
  * each addition at least 6 field multiplications (batch-affine: 2M + 1S,
    plus 3M for its share of the batched inversion);
  * each field multiplication at least 64 32-bit multiply-adds (the 8 x 8
    limb product; the Montgomery reduction is not counted).
Bytes: each distinct set of bases read once (64 bytes an affine point: the
Lagrange bases g_lagrange and the monomial bases g), every scalar once (32
bytes) and every result written once (96 bytes, projective).
Least time = max(operations / peak multiply-adds, bytes / peak bandwidth).
"""

from __future__ import annotations

import importlib
import math

PEAK_IMAD_PER_S = 132 * 64 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12
SCALAR_BITS = 254
MULS_PER_ADD = 6
IMADS_PER_MUL = 64


def proof_msms(cs, multiopen: str) -> dict:
    """{"lagrange": m, "monomial": m} of one proof, from a reference CS and
    the name of the configuration's multiopen scheme."""
    opening_msms = importlib.import_module(
        f"prover_bench.reference.multiopen_{multiopen}").opening_msms
    nsets = cs.permutation_sets()
    lagrange = cs.num["advice"] + 3 * len(cs.lookups) + nsets
    rots = {rot for _, rot in cs.queries["advice"]} | {rot for _, rot in cs.queries["fixed"]}
    rots.add(0)
    if nsets:
        rots.add(1)
    if nsets > 1:
        rots.add(-(cs.blinding_factors() + 1))
    if cs.lookups:
        rots |= {1, -1}
    return {"lagrange": lagrange, "monomial": 1 + (cs.degree() - 1) + opening_msms(len(rots))}


def msm_least(k: int, msms: dict) -> dict:
    """Least operations, bytes and seconds of the MSMs ``msms`` over 2^k bases."""
    n = 1 << k
    count = sum(msms.values())
    adds = n * SCALAR_BITS / math.log2(n * SCALAR_BITS)
    ops = count * adds * MULS_PER_ADD * IMADS_PER_MUL
    bases = sum(1 for m in msms.values() if m)
    nbytes = bases * 64 * n + count * (32 * n + 96)
    seconds = max(ops / PEAK_IMAD_PER_S, nbytes / PEAK_BYTES_PER_S)
    return {"msms": count, "ops": ops, "bytes": nbytes, "seconds": seconds,
            "bound": "compute" if ops / PEAK_IMAD_PER_S >= nbytes / PEAK_BYTES_PER_S else "memory"}
