"""(tag, dense, spread) lookup table chip — table16/spread_table.rs.

The table holds every 16-bit value with its zero-interleaved (spread) form and
a width tag (0: <2^7, 1: <2^10, 2: <2^11, 3: <2^13, 4: <2^14, 5: full 16
bits), so subword range checks and dense<->spread consistency are one lookup.
Requires k >= 17 (2^16 table rows + blinding).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ...circuit.layouter import Layouter, Region
from ...circuit.value import Value
from ...plonk.circuit import Column, ConstraintSystem, TableColumn
from ...poly.polynomial import Rotation
from .util import spread_u16


def get_tag(x: int) -> int:
    """Width tag of a 16-bit value (spread_table.rs:27-42)."""
    if x < (1 << 7):
        return 0
    if x < (1 << 10):
        return 1
    if x < (1 << 11):
        return 2
    if x < (1 << 13):
        return 3
    if x < (1 << 14):
        return 4
    return 5


@dataclasses.dataclass(frozen=True)
class SpreadWord:
    """A lookup input: dense 16-bit value with its tag and spread form."""

    dense: int

    @property
    def tag(self) -> int:
        return get_tag(self.dense)

    @property
    def spread(self) -> int:
        return spread_u16(self.dense)


@dataclasses.dataclass
class SpreadTableConfig:
    # advice inputs
    tag: Column
    dense: Column
    spread: Column
    # table columns
    table_tag: TableColumn
    table_dense: TableColumn
    table_spread: TableColumn


class SpreadTableChip:
    def __init__(self, config: SpreadTableConfig):
        self.config = config

    @staticmethod
    def configure(
        meta: ConstraintSystem, tag: Column, dense: Column, spread: Column
    ) -> SpreadTableConfig:
        table_tag = meta.lookup_table_column()
        table_dense = meta.lookup_table_column()
        table_spread = meta.lookup_table_column()
        config = SpreadTableConfig(
            tag, dense, spread, table_tag, table_dense, table_spread
        )

        def table_map(cells):
            tag_cur = cells.query_advice(tag, Rotation.cur())
            dense_cur = cells.query_advice(dense, Rotation.cur())
            spread_cur = cells.query_advice(spread, Rotation.cur())
            return [
                (tag_cur, table_tag),
                (dense_cur, table_dense),
                (spread_cur, table_spread),
            ]

        meta.lookup("spread lookup", table_map)
        return config

    def load(self, layouter: Layouter):
        """Fill the 2^16-row (tag, dense, spread) table."""
        config = self.config

        def do(table):
            for dense in range(1 << 16):
                table.assign_cell(config.table_tag, dense, lambda d=dense: get_tag(d))
                table.assign_cell(config.table_dense, dense, lambda d=dense: d)
                table.assign_cell(
                    config.table_spread, dense, lambda d=dense: spread_u16(d)
                )

        layouter.get_root().assign_table("spread table", do)

    def assign_word(
        self, region: Region, row: int, word: Value
    ):
        """Witness one (tag, dense, spread) row; word: Value of a 16-bit int.
        Returns (dense_cell, spread_cell)."""
        config = self.config
        region.assign_advice(
            config.tag, row, lambda: word.map(lambda d: get_tag(d))
        )
        dense_cell = region.assign_advice(config.dense, row, lambda: word)
        spread_cell = region.assign_advice(
            config.spread, row, lambda: word.map(spread_u16)
        )
        return dense_cell, spread_cell
