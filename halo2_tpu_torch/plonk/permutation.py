"""Permutation argument: keygen assembly (union-find cycles) + sigma polys.

Port of the JAX package's ``plonk/permutation.py`` (the reference
plonk/permutation.rs + permutation/keygen.rs).  Cycle bookkeeping is host
numpy; the sigma polynomials are one device gather into the
(delta^i * omega^j) table, followed by the usual NTT pipeline.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import FieldSpec
from ..ops import ntt as ntt_ops
from ..plonk.error import BoundsFailure, ColumnNotInPermutation
from ..poly.domain import EvaluationDomain
from ..poly.polynomial import LAGRANGE, Poly
from .circuit import Column, PermutationArgument


class PermutationAssembly:
    """permutation/keygen.rs:16-103 — union-find over copy cycles."""

    def __init__(self, n: int, p: PermutationArgument):
        self.columns: List[Column] = list(p.columns)
        m = len(self.columns)
        self.n = n
        # mapping/aux as (m, n) arrays of flat indices i*n + j
        base = np.arange(m * n, dtype=np.int64).reshape(m, n)
        self.mapping = base.copy()
        self.aux = base.copy()
        self.sizes = np.ones((m, n), dtype=np.int64)

    def _col_index(self, column: Column) -> int:
        try:
            return self.columns.index(column)
        except ValueError:
            raise ColumnNotInPermutation(column)

    def copy(self, left_column: Column, left_row: int, right_column: Column, right_row: int):
        lc, rc = self._col_index(left_column), self._col_index(right_column)
        n = self.n
        if left_row >= n or right_row >= n:
            raise BoundsFailure()
        left_cycle = self.aux[lc, left_row]
        right_cycle = self.aux[rc, right_row]
        if left_cycle == right_cycle:
            return
        lci, lcj = divmod(int(left_cycle), n)
        rci, rcj = divmod(int(right_cycle), n)
        if self.sizes[lci, lcj] < self.sizes[rci, rcj]:
            left_cycle, right_cycle = right_cycle, left_cycle
            lci, lcj, rci, rcj = rci, rcj, lci, lcj
        self.sizes[lci, lcj] += self.sizes[rci, rcj]
        i = right_cycle
        while True:
            ii, ij = divmod(int(i), n)
            self.aux[ii, ij] = left_cycle
            i = self.mapping[ii, ij]
            if i == right_cycle:
                break
        self.mapping[lc, left_row], self.mapping[rc, right_row] = (
            self.mapping[rc, right_row],
            self.mapping[lc, left_row],
        )

    # ------------------------------------------------------------------
    def sigma_lagrange(self, spec: FieldSpec, domain: EvaluationDomain) -> List[Poly]:
        """sigma_i[j] = delta^pi * omega^pj where (pi, pj) = mapping[i][j]."""
        m = len(self.columns)
        n = self.n
        dev = domain.device
        omega_pows = domain._omega_pows_full  # (16, n)
        delta_pows = ntt_ops.power_table(spec, spec.delta, m, dev)  # (16, m)
        # deltaomega[(i, j)] = delta^i * omega^j laid out flat as i*n+j
        do = limb.fmul(
            spec,
            delta_pows.repeat_interleave(n, dim=1),  # (16, m*n)
            omega_pows.repeat(1, m),
        )
        flat = torch.from_numpy(self.mapping.reshape(-1)).to(dev)
        sigma = do[:, flat]  # (16, m*n)
        return [Poly(sigma[:, i * n : (i + 1) * n], LAGRANGE) for i in range(m)]

    def build_vk(self, params, domain: EvaluationDomain, p: PermutationArgument):
        """One commitment a sigma column, each with Blind::default() = 1
        (keygen.rs:247-250); keygen batches the same commitments in one MSM."""
        sigmas = self.sigma_lagrange(domain.spec, domain)
        return PermutationVK([params.commit_lagrange(s, 1) for s in sigmas])

    def build_pk(self, params, domain: EvaluationDomain, p: PermutationArgument):
        return build_pk(domain, self.sigma_lagrange(domain.spec, domain))


class PermutationVK:
    def __init__(self, commitments):
        # projective device Points; normalized to host affine by the caller
        self.commitments = commitments


class PermutationPK:
    def __init__(self, permutations, polys, cosets):
        self.permutations = permutations  # Lagrange sigma polys
        self.polys = polys  # coefficient form
        self.cosets = cosets  # extended cosets


def build_pk(domain: EvaluationDomain, sigmas: List[Poly]) -> PermutationPK:
    """Proving-key half of the permutation argument from the Lagrange sigmas."""
    polys = [domain.lagrange_to_coeff(s) for s in sigmas]
    cosets = [domain.coeff_to_extended(q) for q in polys]
    return PermutationPK(sigmas, polys, cosets)
