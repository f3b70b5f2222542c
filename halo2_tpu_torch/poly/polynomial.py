"""Polynomial values with basis tags + Rotation.

Port of the JAX package's ``poly/polynomial.py`` (the reference
``Polynomial<F, Basis>`` type-state wrapper, poly.rs:48-72): values are a
Montgomery limb tensor of shape (16, n); the basis is a runtime tag.
Rotations of evaluations are ``torch.roll``, which shifts toward higher
indices for a positive shift as ``jnp.roll`` does, so the reference's
``-rotation`` shifts carry over unchanged.  The pointwise algebra goes
through ``limb``: one kernel launch an operation on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import limb
from ..fields.spec import FieldSpec

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

    def __len__(self):
        return self.values.shape[1]

    def rotate(self, rotation: Rotation) -> "Poly":
        """Cyclic left-rotation by ``rotation`` (Lagrange basis, poly.rs:145)."""
        assert self.basis == LAGRANGE
        return Poly(torch.roll(self.values, -rotation.i, dims=1), self.basis)

    def add(self, spec: FieldSpec, other: "Poly") -> "Poly":
        assert self.basis == other.basis
        return Poly(limb.fadd(spec, self.values, other.values), self.basis)

    def sub(self, spec: FieldSpec, other: "Poly") -> "Poly":
        assert self.basis == other.basis
        return Poly(limb.fsub(spec, self.values, other.values), self.basis)

    def mul_pointwise(self, spec: FieldSpec, other: "Poly") -> "Poly":
        assert self.basis == other.basis
        return Poly(limb.fmul(spec, self.values, other.values), self.basis)

    def scale(self, spec: FieldSpec, scalar: torch.Tensor) -> "Poly":
        """Every value times one Montgomery element, (16,) or (16, 1): K1
        reads it in place as a (16, 1) view, with no (16, n) copy."""
        s = scalar.reshape(scalar.shape[0], 1)
        return Poly(limb.fmul(spec, self.values, s), self.basis)
