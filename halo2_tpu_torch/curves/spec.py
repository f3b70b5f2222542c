"""Curve specifications (short Weierstrass y^2 = x^3 + b, a = 0).

Mirrors the curves the reference gets from ``halo2curves`` (SURVEY.md §2.12):
BN254 G1 and the Pasta cycle (Pallas/Vesta).  All three have a = 0, which lets
every device kernel use the branch-free Renes–Costello–Batina complete
projective formulas — no data-dependent control flow anywhere on the device path.
"""

from __future__ import annotations

import dataclasses

from ..fields.spec import BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ, FieldSpec


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    name: str
    base: FieldSpec  # coordinate field
    scalar: FieldSpec  # scalar field (group order)
    b: int
    gx: int
    gy: int

    def __post_init__(self):
        assert (self.gy * self.gy - self.gx**3 - self.b) % self.base.p == 0


# BN254 G1: y^2 = x^3 + 3 over Fq, order = Fr modulus, generator (1, 2).
BN254_G1 = CurveSpec("bn254_g1", base=BN254_FQ, scalar=BN254_FR, b=3, gx=1, gy=2)

# Pallas: y^2 = x^3 + 5 over Fp, scalars in Fq, generator (-1, 2).
PALLAS = CurveSpec("pallas", base=PASTA_FP, scalar=PASTA_FQ, b=5, gx=PASTA_FP.p - 1, gy=2)

# Vesta: the cycle partner (fields swapped).
VESTA = CurveSpec("vesta", base=PASTA_FQ, scalar=PASTA_FP, b=5, gx=PASTA_FQ.p - 1, gy=2)

ALL_CURVES = (BN254_G1, PALLAS, VESTA)
