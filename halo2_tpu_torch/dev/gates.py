"""CircuitGates: dump of every gate's constraints and queries.

Rebuild of dev/gates.rs (SURVEY.md §2.29): collects each gate's constraint
expressions (via the Expression identifier walk) plus the set of queried
cells, rendered as text for circuit review/documentation.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..plonk.circuit import ConstraintSystem


@dataclasses.dataclass
class ConstraintInfo:
    name: str
    expression: str


@dataclasses.dataclass
class GateInfo:
    name: str
    constraints: List[ConstraintInfo]
    queries: List[str]


class CircuitGates:
    def __init__(self, gates: List[GateInfo]):
        self.gates = gates

    @classmethod
    def collect(cls, circuit_cls) -> "CircuitGates":
        cs = ConstraintSystem()
        circuit_cls.configure(cs)
        gates = []
        for gate in cs.gates:
            constraints = [
                ConstraintInfo(cname or "", poly.identifier())
                for cname, poly in zip(gate.constraint_names, gate.polys)
            ]
            queries = sorted(
                {
                    f"{column.kind}[{column.index}]@{rot.i}"
                    for column, rot in gate.queried_cells
                }
            ) + sorted({f"selector[{s.index}]" for s in gate.queried_selectors})
            gates.append(GateInfo(gate.name, constraints, queries))
        return cls(gates)

    def __str__(self) -> str:
        lines = []
        for gate in self.gates:
            lines.append(f"{gate.name}:")
            for c in gate.constraints:
                label = f" ({c.name})" if c.name else ""
                lines.append(f"  -{label} {c.expression}")
            lines.append(f"  queries: {', '.join(gate.queries)}")
        return "\n".join(lines)
