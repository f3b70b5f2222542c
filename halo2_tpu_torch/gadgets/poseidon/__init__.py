"""Poseidon gadget: Pow5 chip + host primitives (SURVEY.md §2.32)."""

from .primitives import (
    ConstantLength,
    Grain,
    PoseidonSpec,
    Sponge,
    generate_mds,
    hash_message,
    p128_pow5_t3,
    permute,
)
from .pow5 import PoseidonHashGadget, Pow5Chip, Pow5Config

__all__ = [
    "ConstantLength",
    "Grain",
    "PoseidonSpec",
    "Sponge",
    "generate_mds",
    "hash_message",
    "p128_pow5_t3",
    "permute",
    "PoseidonHashGadget",
    "Pow5Chip",
    "Pow5Config",
]
