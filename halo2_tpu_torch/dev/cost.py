"""CircuitCost: static circuit measurement + proof-size model.

Rebuild of dev/cost.rs (SURVEY.md §2.28): measures column/query/lookup/
permutation counts by synthesizing with a no-op Assignment, and computes
marginal/total proof sizes from the argument structure (cost.rs:229-300).
Sizes assume 32-byte points and scalars (BN254/Pasta compressed encodings).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..circuit.layouter import Assignment
from ..circuit.value import Value
from ..plonk.circuit import ConstraintSystem
from ..poly.polynomial import Rotation


class _NullAssembly(Assignment):
    """cost.rs Assembly: records selectors only."""

    def __init__(self, num_selectors: int, n: int):
        self.selectors = [[False] * n for _ in range(num_selectors)]

    def enable_selector(self, selector, row):
        self.selectors[selector.index][row] = True

    def query_instance(self, column, row):
        return Value.unknown()

    def evaluates_advice(self, column):
        return False

    def evaluates_fixed(self, column):
        return False

    def assign_advice(self, column, row, to):
        pass

    def assign_fixed(self, column, row, to):
        pass

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass


@dataclasses.dataclass
class ProofContribution:
    """(commitments, evaluations) pair (cost.rs ProofContribution)."""

    commitments: int
    evaluations: int

    def size(self, point_size: int = 32, scalar_size: int = 32) -> int:
        return self.commitments * point_size + self.evaluations * scalar_size

    def __add__(self, other):
        return ProofContribution(
            self.commitments + other.commitments,
            self.evaluations + other.evaluations,
        )

    def __mul__(self, instances: int):
        return ProofContribution(
            self.commitments * instances, self.evaluations * instances
        )


@dataclasses.dataclass
class MarginalProofSize:
    instance: ProofContribution
    advice: ProofContribution
    lookups: ProofContribution
    equality: ProofContribution

    def total(self) -> int:
        return sum(
            c.size()
            for c in (self.instance, self.advice, self.lookups, self.equality)
        )


@dataclasses.dataclass
class ProofSize:
    instance: ProofContribution
    advice: ProofContribution
    fixed: ProofContribution
    lookups: ProofContribution
    equality: ProofContribution
    vanishing: ProofContribution
    multiopen: ProofContribution
    polycomm: ProofContribution

    def total(self) -> int:
        return sum(
            c.size()
            for c in (
                self.instance,
                self.advice,
                self.fixed,
                self.lookups,
                self.equality,
                self.vanishing,
                self.multiopen,
                self.polycomm,
            )
        )


class CircuitCost:
    """cost.rs:24-150 — measure a circuit at size 2^k."""

    def __init__(self, k, max_deg, advice_columns, instance_queries, advice_queries,
                 fixed_queries, lookups, permutation_cols, point_sets):
        self.k = k
        self.max_deg = max_deg
        self.advice_columns = advice_columns
        self.instance_queries = instance_queries
        self.advice_queries = advice_queries
        self.fixed_queries = fixed_queries
        self.lookups = lookups
        self.permutation_cols = permutation_cols
        self.point_sets = point_sets

    @classmethod
    def measure(cls, k: int, circuit) -> "CircuitCost":
        cs = ConstraintSystem()
        config = type(circuit).configure(cs)
        assembly = _NullAssembly(cs.num_selectors, 1 << k)
        circuit.floor_planner.synthesize(assembly, circuit, config, list(cs.constants))

        # Figure out how many point sets we have due to queried cells
        # (cost.rs:188-220): distinct rotation sets across columns + lookups(2)
        # + permutation.
        column_queries = {}
        for column, rot in (
            list(cs.advice_queries) + list(cs.fixed_queries) + list(cs.instance_queries)
        ):
            column_queries.setdefault((column.kind, column.index), set()).add(rot.i)
        point_sets = {frozenset({0, 1})}  # product polys open at x, omega x
        for rotations in column_queries.values():
            point_sets.add(frozenset(rotations))

        return cls(
            k=k,
            max_deg=cs.degree(),
            advice_columns=cs.num_advice_columns,
            instance_queries=len(cs.instance_queries),
            advice_queries=len(cs.advice_queries),
            fixed_queries=len(cs.fixed_queries),
            lookups=len(cs.lookups),
            permutation_cols=len(cs.permutation.columns),
            point_sets=len(point_sets),
        )

    def permutation_chunks(self) -> int:
        chunk = self.max_deg - 2
        return (self.permutation_cols + chunk - 1) // chunk if self.permutation_cols else 0

    def marginal_proof_size(self) -> MarginalProofSize:
        chunks = self.permutation_chunks()
        return MarginalProofSize(
            instance=ProofContribution(0, self.instance_queries),
            advice=ProofContribution(self.advice_columns, self.advice_queries),
            lookups=ProofContribution(3 * self.lookups, 5 * self.lookups),
            equality=ProofContribution(chunks, max(3 * chunks - 1, 0)),
        )

    def proof_size(self, instances: int) -> ProofSize:
        marginal = self.marginal_proof_size()
        return ProofSize(
            instance=marginal.instance * instances,
            advice=marginal.advice * instances,
            fixed=ProofContribution(0, self.fixed_queries),
            lookups=marginal.lookups * instances,
            equality=marginal.equality * instances
            + ProofContribution(0, self.permutation_cols),
            vanishing=ProofContribution(self.max_deg, 1),
            multiopen=ProofContribution(1, self.point_sets),
            # polycomm (GWC-style): one W commitment per point set
            polycomm=ProofContribution(self.point_sets, 0),
        )
