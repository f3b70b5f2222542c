"""A constraint system with what ``cs.py`` leaves out: simple selectors,
compressed into fixed columns (``compress_selectors.py``) before a key is
made; constant columns; and the query that halo2's ``enable_equality`` makes
of every column it adds to the permutation (``query_any_index(column,
Rotation::cur())``, plonk/circuit.rs).  Its pinned text lists the constant
columns."""

from __future__ import annotations

from . import compress_selectors
from . import cs as E


class SelectorCS(E.CS):
    def __init__(self):
        super().__init__()
        self.constants = []  # fixed columns, in enable_constant order

    def selector(self):
        self.num_selectors += 1
        return ("selector", self.num_selectors - 1)

    def enable_equality(self, column):
        self.query(column)
        super().enable_equality(column)

    def enable_constant(self, column):
        if column not in self.constants:
            self.constants.append(column)
            self.enable_equality(column)

    def degree(self) -> int:
        """``cs.CS.degree``, a selector not yet compressed counting 1."""
        d = 3
        for inputs, tables in self.lookups:
            d = max(d, 4, 2 + max([1] + [compress_selectors.degree(e) for e in inputs])
                    + max([1] + [compress_selectors.degree(e) for e in tables]))
        for g in self.gates:
            d = max(d, compress_selectors.degree(g))
        return d

    def debug(self) -> str:
        text = super().debug()
        tail = "constants: [], minimum_degree: None }"
        if not text.endswith(tail):
            raise ValueError("cs.CS.debug's tail has changed")
        columns = ", ".join(E.column_debug(c) for c in self.constants)
        return text[:-len(tail)] + f"constants: [{columns}], minimum_degree: None }}"
