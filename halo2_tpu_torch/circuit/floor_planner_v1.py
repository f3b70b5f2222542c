"""V1 floor planner: measure pass + greedy biggest-advice-first slotting.

Rebuild of circuit/floor_planner/v1{.rs,/strategy.rs} (SURVEY.md §2.16):
a full measurement synthesis records each region's column set and height;
regions are then sorted by advice area (descending) and first-fit slotted into
per-column allocation maps (gaps between earlier regions are reused, unlike
the single-pass planner); a second synthesis performs the real assignments,
and constants are packed into the free intervals of the constants columns.

Tie-break note: the reference sorts with Rust's unstable sort; regions with
equal advice area may be laid out in a different relative order here (Python
stable sort + reverse).  Layout differences only affect row placement, never
satisfiability.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

from ..plonk.circuit import ADVICE, Column
from ..plonk.error import NotEnoughColumnsForConstants
from ..utils import profiling
from .layouter import (
    SHAPE_PHASE,
    Assignment,
    Cell,
    Layouter,
    NamespacedLayouter,
    Region,
    RegionShape,
    SimpleTableLayouter,
    Table,
    value_of,
)
from .value import Value


def _col_key(column) -> tuple:
    """RegionColumn ordering: concrete columns first (Column Ord), then
    selectors by index (layouter.rs:166-175)."""
    if isinstance(column, Column):
        return (0,) + column.sort_key()
    # ('selector', index)
    return (1, column[1])


class Allocations:
    """Disjoint allocated [start, start+length) intervals in one column."""

    def __init__(self):
        self.regions: List[Tuple[int, int]] = []  # sorted (start, length)

    def unbounded_interval_start(self) -> int:
        if not self.regions:
            return 0
        start, length = self.regions[-1]
        return start + length

    def free_intervals(self, start: int, end: Optional[int]):
        """Yield (space_start, space_end|None) gaps intersecting [start, end)."""
        row = start
        for r_start, r_length in self.regions:
            if end is not None and r_start >= end:
                return
            if row < r_start:
                yield (row, r_start)
            row = max(row, r_start + r_length)
        if end is None or row < end:
            yield (row, end)

    def insert(self, start: int, length: int):
        bisect.insort(self.regions, (start, length))


def first_fit_region(
    column_allocations: Dict[tuple, Allocations],
    region_columns: List[tuple],
    region_length: int,
    start: int,
    slack: Optional[int],
) -> Optional[int]:
    """strategy.rs:104-160 — recursive first-fit across the region's columns."""
    if not region_columns:
        return start
    c, remaining = region_columns[0], region_columns[1:]
    end = start + region_length + slack if slack is not None else None

    alloc = column_allocations.setdefault(c, Allocations())
    for space_start, space_end in list(alloc.free_intervals(start, end)):
        s_slack = (
            (space_end - space_start) - region_length if space_end is not None else None
        )
        if slack is not None and s_slack is not None:
            assert s_slack <= slack
        if s_slack is None or s_slack >= 0:
            row = first_fit_region(
                column_allocations, remaining, region_length, space_start, s_slack
            )
            if row is not None:
                if end is not None:
                    assert row + region_length <= end
                column_allocations[c].insert(row, region_length)
                return row
    return None


def slot_in_biggest_advice_first(region_shapes: List[RegionShape]):
    """strategy.rs:165-225."""

    def advice_area(shape: RegionShape) -> int:
        advice_cols = sum(
            1
            for c in shape.columns
            if isinstance(c, Column) and c.kind == ADVICE
        )
        return advice_cols * shape.row_count

    sorted_regions = sorted(region_shapes, key=advice_area)
    sorted_regions.reverse()

    column_allocations: Dict[tuple, Allocations] = {}
    placed = []
    for region in sorted_regions:
        region_columns = sorted((_col_key(c) for c in region.columns))
        start = first_fit_region(
            column_allocations, region_columns, region.row_count, 0, None
        )
        assert start is not None
        placed.append((start, region))

    placed.sort(key=lambda t: t[1].region_index)
    return [start for start, _ in placed], column_allocations


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


class _MeasureLayouter(Layouter):
    def __init__(self):
        self.regions: List[RegionShape] = []

    def assign_region(self, name, assignment):
        shape = RegionShape(len(self.regions))
        result = assignment(Region(shape))
        self.regions.append(shape)
        return result

    def assign_table(self, name, assignment):
        return None

    def constrain_instance(self, cell, instance, row):
        return None

    def get_challenge(self, challenge):
        return Value.unknown()

    def get_root(self):
        return self

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass


class _V1Region:
    """Region layouter for the assignment pass (v1.rs V1Region)."""

    def __init__(self, plan: "_V1Plan", region_index: int):
        self.plan = plan
        self.region_index = region_index

    def _abs(self, offset: int) -> int:
        return self.plan.regions[self.region_index] + offset

    def enable_selector(self, selector, offset):
        self.plan.cs.enable_selector(selector, self._abs(offset))

    def assign_advice(self, column, offset, to):
        cs = self.plan.cs
        value = value_of(to) if cs.evaluates_advice(column) else Value.unknown()
        cs.assign_advice_value(column, self._abs(offset), value)
        return Cell(self.region_index, offset, column), value

    def assign_advice_from_constant(self, column, offset, constant):
        cell, value = self.assign_advice(column, offset, constant)
        self.constrain_constant(cell, constant)
        return cell, value

    def assign_advice_from_instance(self, instance, row, advice, offset):
        value = self.plan.cs.query_instance(instance, row)
        cell, _ = self.assign_advice(advice, offset, value)
        self.plan.cs.copy(
            cell.column, self._abs(cell.row_offset), instance, row
        )
        return cell, value

    def instance_value(self, instance, row):
        return self.plan.cs.query_instance(instance, row)

    def assign_fixed(self, column, offset, to):
        cs = self.plan.cs
        value = value_of(to) if cs.evaluates_fixed(column) else Value.unknown()
        cs.assign_fixed_value(column, self._abs(offset), value)
        return Cell(self.region_index, offset, column), value

    def constrain_constant(self, cell, constant):
        self.plan.constants.append((constant, cell))

    def constrain_equal(self, left: Cell, right: Cell):
        self.plan.cs.copy(
            left.column,
            self.plan.regions[left.region_index] + left.row_offset,
            right.column,
            self.plan.regions[right.region_index] + right.row_offset,
        )


class _V1Plan:
    def __init__(self, cs: Assignment, regions: List[int]):
        self.cs = cs
        self.regions = regions
        self.constants: List[Tuple[object, Cell]] = []
        self.table_columns: List = []


class _AssignLayouter(Layouter):
    def __init__(self, plan: _V1Plan):
        self.plan = plan
        self.region_index = 0

    def assign_region(self, name, assignment):
        region_index = self.region_index
        self.region_index += 1
        self.plan.cs.enter_region(name)
        region = _V1Region(self.plan, region_index)
        result = assignment(Region(region))
        self.plan.cs.exit_region()
        return result

    def assign_table(self, name, assignment):
        from ..plonk.error import SynthesisError

        self.plan.cs.enter_region(name)
        table = SimpleTableLayouter(self.plan.cs, self.plan.table_columns)
        assignment(Table(table))
        daa = table.default_and_assigned
        self.plan.cs.exit_region()

        lengths = set()
        for default, flags in daa.values():
            if not all(flags):
                raise SynthesisError("table column has unassigned gaps")
            lengths.add(len(flags))
        if len(lengths) != 1:
            raise SynthesisError("table columns have differing lengths")
        first_unused = lengths.pop()
        for column in daa:
            self.plan.table_columns.append(column)
        for column, (default, flags) in daa.items():
            if default is None:
                raise SynthesisError("table column missing default value")
            self.plan.cs.fill_from_row(column.inner, first_unused, default)

    def constrain_instance(self, cell: Cell, instance, row):
        self.plan.cs.copy(
            cell.column,
            self.plan.regions[cell.region_index] + cell.row_offset,
            instance,
            row,
        )

    def get_challenge(self, challenge):
        return self.plan.cs.get_challenge(challenge)

    def get_root(self):
        return self

    def push_namespace(self, name):
        self.plan.cs.push_namespace(name)

    def pop_namespace(self, gadget_name=None):
        self.plan.cs.pop_namespace(gadget_name)


class V1FloorPlanner:
    """FloorPlanner::synthesize for V1 (v1.rs:59-146)."""

    @staticmethod
    def synthesize(cs: Assignment, circuit, config, constants: List[Column]):
        timed = profiling.enabled()
        t0 = time.perf_counter() if timed else 0.0
        measure = _MeasureLayouter()
        circuit.without_witnesses().synthesize(config, measure)

        regions, column_allocations = slot_in_biggest_advice_first(measure.regions)
        if timed:  # the measuring pass and the slotting, as the single pass's shapes
            profiling.add(SHAPE_PHASE, time.perf_counter() - t0)
        first_unassigned_row = max(
            (a.unbounded_interval_start() for a in column_allocations.values()),
            default=0,
        )

        plan = _V1Plan(cs, regions)
        assign = _AssignLayouter(plan)
        circuit.synthesize(config, assign)

        # position constants in the free intervals of the constants columns
        positions = []
        for c in constants:
            alloc = column_allocations.get(_col_key(c), Allocations())
            for space_start, space_end in alloc.free_intervals(0, first_unassigned_row):
                positions.extend((c, i) for i in range(space_start, space_end))
        if len(positions) < len(plan.constants):
            raise NotEnoughColumnsForConstants()
        for (col, row), (value, cell) in zip(positions, plan.constants):
            cs.assign_fixed_value(col, row, Value.known(value))
            cs.copy(
                col,
                row,
                cell.column,
                plan.regions[cell.region_index] + cell.row_offset,
            )
