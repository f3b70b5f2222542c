"""Polynomial values with basis tags + Rotation.

Port of the JAX package's ``poly/polynomial.py`` (the reference
``Polynomial<F, Basis>`` type-state wrapper, poly.rs:48-72): values are a
Montgomery limb tensor of shape (16, n); the basis is a runtime tag.
Rotations of evaluations are ``torch.roll``, which shifts toward higher
indices for a positive shift as ``jnp.roll`` does, so the reference's
``-rotation`` shifts carry over unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

COEFF = "coeff"
LAGRANGE = "lagrange"
EXTENDED = "extended_lagrange"


@dataclasses.dataclass(frozen=True)
class Rotation:
    """Rotation of a Lagrange polynomial over the domain (poly.rs:311)."""

    i: int = 0

    @staticmethod
    def cur() -> "Rotation":
        return Rotation(0)

    @staticmethod
    def prev() -> "Rotation":
        return Rotation(-1)

    @staticmethod
    def next() -> "Rotation":
        return Rotation(1)


@dataclasses.dataclass
class Poly:
    values: torch.Tensor  # (16, n) Montgomery limbs
    basis: str
