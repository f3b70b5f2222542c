"""ECC gadget over Pallas (SURVEY.md §2.34) — point witnessing + addition.

Round 1 ships witness_point (identity-allowed and non-identity variants),
incomplete addition, and the 12-constraint complete addition
(halo2_gadgets/src/ecc/chip/{witness_point,add_incomplete,add}.rs).
Variable-base and fixed-base scalar mul land next round (PARITY.md §2.34).
"""

from .chip import EccConfig, EccChip, EccPoint

__all__ = ["EccConfig", "EccChip", "EccPoint"]
