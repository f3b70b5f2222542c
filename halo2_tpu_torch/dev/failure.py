"""Failure locations and reference-format failure rendering for MockProver.

Rebuild of halo2_proofs/src/dev/{failure.rs, metadata.rs, failure/emitter.rs}:
``FailureLocation`` resolves a failing absolute row back to the region that
assigned the participating columns (failure.rs:25-120), and each failure kind
renders with the reference's Display wording (failure.rs:191-255), e.g.

    Constraint 0 ('secant line') in gate 3 ('Sinsemilla gate') is not
    satisfied in Region 1 ('hash_to_point') at offset 7
    - Column('Advice', 0)@0 = 0x12…

so downstream tooling (and humans) see the same diagnostics as with the
reference MockProver.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ..plonk.circuit import (
    ADVICE,
    FIXED,
    INSTANCE,
    AdviceExpr,
    ConstraintSystem,
    FixedExpr,
    InstanceExpr,
)

_KIND_NAME = {ADVICE: "Advice", FIXED: "Fixed", INSTANCE: "Instance"}


def column_str(kind: int, index: int) -> str:
    """metadata::Column Display (metadata.rs:18-22)."""
    return f"Column('{_KIND_NAME[kind]}', {index})"


def gate_str(index: int, name: str) -> str:
    return f"Gate {index} ('{name}')"


def constraint_str(gate_index: int, gate_name: str, index: int, name: str) -> str:
    named = f" ('{name}')" if name else ""
    return f"Constraint {index}{named} in gate {gate_index} ('{gate_name}')"


def region_str(index: int, name: str) -> str:
    return f"Region {index} ('{name}')"


@dataclasses.dataclass(frozen=True)
class FailureLocation:
    """InRegion {region, offset} | OutsideRegion {row} (failure.rs:25-39)."""

    kind: str  # "InRegion" | "OutsideRegion"
    row: int
    region_index: Optional[int] = None
    region_name: Optional[str] = None
    offset: Optional[int] = None

    def __str__(self):
        if self.kind == "InRegion":
            return (
                f"in {region_str(self.region_index, self.region_name)}"
                f" at offset {self.offset}"
            )
        return f"outside any region, on row {self.row}"

    @staticmethod
    def find(regions, failure_row: int, failure_columns: Set[Tuple[int, int]]) -> "FailureLocation":
        """Match the region whose row span contains the row and whose columns
        overlap the failing columns (failure.rs:95-120).

        ``regions`` is MockProver's region list (each with .name, .rows set,
        .cells set of (column, row)); ``failure_columns`` holds (kind, index).
        """
        for r_i, r in enumerate(regions):
            if not r.rows:
                continue
            start, end = min(r.rows), max(r.rows)
            if not (start <= failure_row <= end):
                continue
            region_columns = {(c.kind, c.index) for c, _ in r.cells}
            if region_columns & failure_columns:
                return FailureLocation(
                    "InRegion",
                    failure_row,
                    region_index=r_i,
                    region_name=r.name,
                    offset=failure_row - start,
                )
        return FailureLocation("OutsideRegion", failure_row)

    @staticmethod
    def find_expressions(
        cs: ConstraintSystem, regions, failure_row: int, expressions
    ) -> "FailureLocation":
        """Columns participating in the expressions -> find (failure.rs:63-93)."""
        cols: Set[Tuple[int, int]] = set()

        def walk(e):
            if isinstance(e, FixedExpr):
                cols.add((FIXED, e.query.column_index))
            elif isinstance(e, AdviceExpr):
                cols.add((ADVICE, e.query.column_index))
            elif isinstance(e, InstanceExpr):
                cols.add((INSTANCE, e.query.column_index))
            for attr in ("expr", "a", "b"):
                child = getattr(e, attr, None)
                if child is not None:
                    walk(child)

        for e in expressions:
            walk(e)
        return FailureLocation.find(regions, failure_row, cols)


def render_cell_values(cell_values: List[Tuple[str, str]]) -> str:
    """'- column@rotation = value' lines (failure.rs:212-224)."""
    return "".join(f"\n- {vc} = {v}" for vc, v in cell_values)
