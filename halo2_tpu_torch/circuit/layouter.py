"""Region / Layouter plumbing + the single-pass floor planner.

Python rebuild of circuit.rs (Region/AssignedCell/Layouter, SURVEY.md §2.15)
and circuit/floor_planner/single_pass.rs (§2.16).  single_pass.rs runs each
region's closure twice, once to measure its shape and once for real; here it
runs once, into a region recorder that measures the shape and records what
the backend keeps.  The layouter then places the region at the first row at
which none of its columns are in use and hands the backend the recorded
calls at absolute rows.

A backend sees the calls it declares it keeps (``Assignment.keeps_layout``).
One that keeps the layout (keygen, ``MockProver``, the cost and graph
collectors) gets every call, in the closure's order, with the values, rows
and regions of two runs.  One that keeps no layout (the prover's
``WitnessCollection``) gets one ``store_advice`` call a region, with the
values of the advice cells it evaluates, and owns their store: the
layouter neither reads nor writes it.  No fixed cell, selector, copy,
constant or table call reaches it.  Placement is the same for both.  A
``to`` runs at most once, while the closure runs, and only where the
backend evaluates its column (``evaluates_advice`` / ``evaluates_fixed``).

With the phase timers on (``utils/profiling.py``), the host time of the
placement, summed over a synthesis, is added to the report once as
``SHAPE_PHASE``; a span per region would cost more than the region.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..plonk.circuit import Challenge, Column, Selector, TableColumn
from ..plonk.error import NotEnoughColumnsForConstants, SynthesisError
from ..utils import profiling
from .value import Assigned, Value, to_assigned

SHAPE_PHASE = "synthesis: region shapes"


class Cell:
    """A cell of a region: the region, the row within it and the column.
    Equal and hashed by the three; never changed once made."""

    __slots__ = ("region_index", "row_offset", "column")

    def __init__(self, region_index: int, row_offset: int, column: Column):
        self.region_index = region_index
        self.row_offset = row_offset
        self.column = column

    def __eq__(self, other):
        if other.__class__ is not Cell:
            return NotImplemented
        return (self.region_index == other.region_index
                and self.row_offset == other.row_offset
                and self.column == other.column)

    def __hash__(self):
        return hash((self.region_index, self.row_offset, self.column))

    def __repr__(self):
        return f"Cell({self.region_index}, {self.row_offset}, {self.column!r})"


class AssignedCell:
    """A cell and the value assigned to it (``Value.unknown()`` where the
    backend did not evaluate the column)."""

    __slots__ = ("value", "cell")

    def __init__(self, value: Value, cell: Cell):
        self.value = value
        self.cell = cell

    def copy_advice(self, region: "Region", column: Column, offset: int) -> "AssignedCell":
        ac = region.assign_advice(column, offset, self.value)
        region.constrain_equal(ac.cell, self.cell)
        return ac

    def __repr__(self):
        return f"AssignedCell({self.value!r}, {self.cell!r})"


class Assignment:
    """Backend interface (reference plonk/circuit.rs:516-628).  Implemented by
    keygen Assembly, prover WitnessCollection, and MockProver."""

    # Whether the backend consumes the layout: fixed cells, selectors,
    # copies, constants and table fills.  ``SingleChipLayouter`` reads it once
    # a synthesis.  A backend that says False keeps the advice values of the
    # columns it evaluates and nothing else: ``SimpleFloorPlanner`` hands them
    # over through ``store_advice`` alone.
    keeps_layout = True

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def enable_selector(self, selector: Selector, row: int):
        raise NotImplementedError

    def query_instance(self, column: Column, row: int) -> Value:
        raise NotImplementedError

    def evaluates_advice(self, column: Column) -> bool:
        """Whether ``assign_advice`` runs its ``to`` for ``column``: the
        single-pass layouter evaluates a ``to`` while the region's closure
        runs, before the region is placed, and only where this says so."""
        return True

    def evaluates_fixed(self, column: Column) -> bool:
        """Whether ``assign_fixed`` runs its ``to`` for ``column``."""
        return True

    def assign_advice(self, column: Column, row: int, to: Callable[[], Value]):
        """Backends RETURN the evaluated Value when they ran ``to`` (or None
        when they skipped it, e.g. phase filtering / keygen) so region layers
        can hand the value to AssignedCell without wrapper closures."""
        raise NotImplementedError

    def store_advice(self, region_start: int, region_end: int, records):
        """Keep a placed region's advice values: the call through which a
        backend that keeps no layout receives them, once a region.
        ``records`` are ``(column index, offset, value)``, the offset from
        ``region_start`` and the value as the circuit gave it (an ``int``, an
        ``Assigned``, or None where unknown), for the columns that
        ``evaluates_advice`` accepts; the region's rows end before
        ``region_end``.  The backend checks the rows and the values, and
        raises ``NotEnoughRowsAvailable`` or ``to_assigned``'s ``TypeError``
        as its ``assign_advice`` would."""
        raise NotImplementedError

    def assign_advice_value(self, column: Column, row: int, value: Value):
        """``assign_advice`` of a value the layouter has computed already
        (``Value.unknown()`` where ``evaluates_advice`` says no)."""
        return self.assign_advice(column, row, lambda: value)

    def assign_fixed(self, column: Column, row: int, to: Callable[[], Value]):
        raise NotImplementedError

    def assign_fixed_value(self, column: Column, row: int, value: Value):
        """``assign_fixed`` of a value the layouter has computed already."""
        return self.assign_fixed(column, row, lambda: value)

    def copy(self, left_column: Column, left_row: int, right_column: Column, right_row: int):
        raise NotImplementedError

    def fill_from_row(self, column: Column, row: int, to: Value):
        raise NotImplementedError

    def get_challenge(self, challenge: Challenge) -> Value:
        return Value.unknown()

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name: Optional[str] = None):
        pass


# ---------------------------------------------------------------------------
# Region facade handed to circuit code
# ---------------------------------------------------------------------------


class Region:
    """The region handed to a closure.  A ``to`` is a Value, an ``int`` or
    an ``Assigned``, or a callable that returns one; the region layouter
    runs it, at most once, where the backend evaluates the column."""

    __slots__ = ("_l",)

    def __init__(self, layouter: "RegionLayouterBase"):
        self._l = layouter

    def assign_advice(self, column: Column, offset: int, to) -> AssignedCell:
        cell, value = self._l.assign_advice(column, offset, to)
        return AssignedCell(value, cell)

    def assign_advice_from_constant(self, column: Column, offset: int, constant) -> AssignedCell:
        cell, value = self._l.assign_advice_from_constant(column, offset, to_assigned(constant))
        return AssignedCell(value, cell)

    def assign_advice_from_instance(
        self, instance: Column, row: int, advice: Column, offset: int
    ) -> AssignedCell:
        cell, value = self._l.assign_advice_from_instance(instance, row, advice, offset)
        return AssignedCell(value, cell)

    def instance_value(self, instance: Column, row: int) -> Value:
        return self._l.instance_value(instance, row)

    def assign_fixed(self, column: Column, offset: int, to) -> AssignedCell:
        cell, value = self._l.assign_fixed(column, offset, to)
        return AssignedCell(value, cell)

    def constrain_constant(self, cell: Cell, constant):
        self._l.constrain_constant(cell, to_assigned(constant))

    def constrain_equal(self, left: Cell, right: Cell):
        self._l.constrain_equal(left, right)

    def enable_selector(self, selector: Selector, offset: int):
        self._l.enable_selector(selector, offset)


def value_of(to) -> Value:
    """The Value of an assignment's ``to``: run it if it is callable, and
    make an ``int`` or an ``Assigned`` a known Value."""
    return _coerce(to() if callable(to) else to)


def _coerce(v) -> Value:
    if isinstance(v, Value):
        return v
    if isinstance(v, (int, Assigned)):
        return Value.known(v)
    raise TypeError(f"cannot use {type(v)} as an assignment value")


class Table:
    __slots__ = ("_l",)

    def __init__(self, layouter: "SimpleTableLayouter"):
        self._l = layouter

    def assign_cell(self, column: TableColumn, offset: int, to):
        self._l.assign_cell(column, offset, to)


# ---------------------------------------------------------------------------
# Region layouters
# ---------------------------------------------------------------------------


class RegionLayouterBase:
    pass


class RegionShape(RegionLayouterBase):
    """Records which columns a region uses and its row count, and drops its
    assignments: ``V1FloorPlanner``'s measuring pass.  ``SimpleFloorPlanner``
    measures with its region recorders below."""

    def __init__(self, region_index: int):
        self.region_index = region_index
        self.columns: set = set()  # Column or ('selector', idx)
        self.row_count = 0

    def _see(self, column, offset):
        self.columns.add(column)
        if offset >= self.row_count:
            self.row_count = offset + 1

    def enable_selector(self, selector, offset):
        self._see(("selector", selector.index), offset)

    def assign_advice(self, column, offset, to):
        self._see(column, offset)
        return Cell(self.region_index, offset, column), Value.unknown()

    def assign_advice_from_constant(self, column, offset, constant):
        return self.assign_advice(column, offset, constant)

    def assign_advice_from_instance(self, instance, row, advice, offset):
        self._see(advice, offset)
        return Cell(self.region_index, offset, advice), Value.unknown()

    def instance_value(self, instance, row):
        return Value.unknown()

    def assign_fixed(self, column, offset, to):
        self._see(column, offset)
        return Cell(self.region_index, offset, column), Value.unknown()

    def constrain_constant(self, cell, constant):
        pass

    def constrain_equal(self, left, right):
        pass


# the backend calls a SingleChipLayouterRegion records
_SELECTOR, _ADVICE, _FIXED, _COPY, _INSTANCE_COPY = range(5)


class SingleChipLayouterRegion(RegionShape):
    """The one run of a region's closure under ``SingleChipLayouter``, for
    a backend that keeps the layout.

    It measures the region as ``RegionShape`` does and appends each backend
    call to ``calls``, in the closure's order, with region-relative rows and
    the value computed here; ``SingleChipLayouter`` hands them to the
    backend once it has placed the region.  Instance cells are queried from
    the backend at once."""

    def __init__(self, layouter: "SingleChipLayouter", region_index: int):
        super().__init__(region_index)
        self.layouter = layouter
        self.calls: list = []
        self.constants: list = []  # (Assigned, Cell)

    def enable_selector(self, selector, offset):
        self._see(("selector", selector.index), offset)
        self.calls.append((_SELECTOR, selector, offset))

    def assign_advice(self, column, offset, to):
        self._see(column, offset)
        value = value_of(to) if self.layouter.evaluates_advice(column) else Value.unknown()
        self.calls.append((_ADVICE, column, offset, value))
        return Cell(self.region_index, offset, column), value

    def assign_advice_from_constant(self, column, offset, constant):
        cell, value = self.assign_advice(column, offset, constant)
        self.constrain_constant(cell, constant)
        return cell, value

    def assign_advice_from_instance(self, instance, row, advice, offset):
        value = self.layouter.cs.query_instance(instance, row)
        cell, _ = self.assign_advice(advice, offset, value)
        self.calls.append((_INSTANCE_COPY, advice, offset, instance, row))
        return cell, value

    def instance_value(self, instance, row):
        return self.layouter.cs.query_instance(instance, row)

    def assign_fixed(self, column, offset, to):
        self._see(column, offset)
        value = value_of(to) if self.layouter.evaluates_fixed(column) else Value.unknown()
        self.calls.append((_FIXED, column, offset, value))
        return Cell(self.region_index, offset, column), value

    def constrain_constant(self, cell, constant):
        self.constants.append((constant, cell))

    def constrain_equal(self, left: Cell, right: Cell):
        self.calls.append((_COPY, left, right))


class SingleChipAdviceRegion(RegionShape):
    """The one run of a region's closure under ``SingleChipLayouter``, for
    a backend that keeps no layout.

    It measures the region as ``RegionShape`` does, and records only the
    advice cells whose column the backend evaluates, as the ``records`` of
    ``Assignment.store_advice`` in ``advice``; the store checks them.  Of the
    constants it keeps their number, ``num_constants``, which places the
    constants column's rows."""

    def __init__(self, layouter: "SingleChipLayouter", region_index: int):
        self.region_index = region_index
        self.columns: set = set()
        self.row_count = 0
        self.layouter = layouter
        self.advice: list = []
        self.num_constants = 0

    def assign_advice(self, column, offset, to):
        self.columns.add(column)
        if offset >= self.row_count:
            self.row_count = offset + 1
        evaluated = self.layouter.advice_evaluated.get(column.index)
        if evaluated is None:
            evaluated = self.layouter.evaluates_advice(column)
        if not evaluated:
            return Cell(self.region_index, offset, column), Value.unknown()
        value = to() if callable(to) else to
        if value.__class__ is not Value:
            value = _coerce(value)
        self.advice.append((column.index, offset, value._inner))
        return Cell(self.region_index, offset, column), value

    def assign_advice_from_constant(self, column, offset, constant):
        cell, value = self.assign_advice(column, offset, constant)
        self.num_constants += 1
        return cell, value

    def assign_advice_from_instance(self, instance, row, advice, offset):
        value = self.layouter.cs.query_instance(instance, row)
        cell, _ = self.assign_advice(advice, offset, value)
        return cell, value

    def instance_value(self, instance, row):
        return self.layouter.cs.query_instance(instance, row)

    def assign_fixed(self, column, offset, to):
        self.columns.add(column)
        if offset >= self.row_count:
            self.row_count = offset + 1
        return Cell(self.region_index, offset, column), Value.unknown()

    def constrain_constant(self, cell, constant):
        self.num_constants += 1


class SimpleTableLayouter:
    """A table's cells.  ``cs`` None: the backend keeps no layout, and only
    the table's shape is kept, for the checks of ``assign_table``."""

    def __init__(self, cs: Optional[Assignment], used_columns):
        self.cs = cs
        self.used_columns = used_columns
        # column -> (default value Value | None, [assigned flags])
        self.default_and_assigned: Dict[TableColumn, list] = {}
        # id(column) -> (column, its entry): a TableColumn hashes in Python,
        # and a table assigns a cell of each column a row
        self._entries: Dict[int, tuple] = {}

    def assign_cell(self, column: TableColumn, offset: int, to):
        known = self._entries.get(id(column))
        if known is not None and known[0] is column:
            entry = known[1]
        else:
            if column in self.used_columns:
                raise SynthesisError("table column already used")
            entry = self.default_and_assigned.setdefault(column, [None, []])
            self._entries[id(column)] = (column, entry)

        cs = self.cs
        v = None
        if cs is not None:
            value = value_of(to) if cs.evaluates_fixed(column.inner) else Value.unknown()
            v = cs.assign_fixed_value(column.inner, offset, value)
        if offset == 0:
            if entry[0] is None:
                # The default is SET even when the backend never ran the
                # closure (the prover's WitnessCollection keeps no fixed
                # cells): mirror single_pass.rs DefaultTableValue =
                # Some(Value::unknown()) in that case.
                entry[0] = Value.unknown() if v is None else v
            else:
                raise SynthesisError("table column default already set")
        flags = entry[1]
        if len(flags) <= offset:
            flags.extend([False] * (offset + 1 - len(flags)))
        flags[offset] = True


# ---------------------------------------------------------------------------
# Layouter + SimpleFloorPlanner
# ---------------------------------------------------------------------------


class Layouter:
    def assign_region(self, name, assignment):
        raise NotImplementedError

    def assign_table(self, name, assignment):
        raise NotImplementedError

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        raise NotImplementedError

    def get_challenge(self, challenge: Challenge) -> Value:
        raise NotImplementedError

    def get_root(self):
        raise NotImplementedError

    def namespace(self, name) -> "NamespacedLayouter":
        self.get_root().push_namespace(name)
        return NamespacedLayouter(self.get_root())


class NamespacedLayouter(Layouter):
    def __init__(self, root):
        self.root = root

    def assign_region(self, name, assignment):
        return self.root.assign_region(name, assignment)

    def assign_table(self, name, assignment):
        return self.root.assign_table(name, assignment)

    def constrain_instance(self, cell, instance, row):
        return self.root.constrain_instance(cell, instance, row)

    def get_challenge(self, challenge):
        return self.root.get_challenge(challenge)

    def get_root(self):
        return self.root

    def push_namespace(self, name):
        raise RuntimeError("only the root's push_namespace should be called")


class SingleChipLayouter(Layouter):
    """single_pass.rs:40-247.  Runs each region's closure once into a
    recorder, places the region, then hands the backend what it keeps: every
    recorded call, at absolute rows, to a backend that keeps the layout; one
    ``store_advice`` call to one that does not, whose store it never reads or
    writes itself."""

    def __init__(self, cs: Assignment, constants: List[Column]):
        self.cs = cs
        self.constants = constants
        self.regions: List[int] = []
        self.columns: Dict[object, int] = {}
        self.table_columns: List[TableColumn] = []
        # seconds of the placements so far; None: not timed
        self.shape_s: Optional[float] = None
        # what the backend keeps, asked once a synthesis (a column's
        # evaluates_* once, by its index)
        self.keeps_layout = cs.keeps_layout
        self.advice_evaluated: Dict[int, bool] = {}
        self.fixed_evaluated: Dict[int, bool] = {}

    def evaluates_advice(self, column: Column) -> bool:
        evaluated = self.advice_evaluated.get(column.index)
        if evaluated is None:
            evaluated = self.advice_evaluated[column.index] = bool(self.cs.evaluates_advice(column))
        return evaluated

    def evaluates_fixed(self, column: Column) -> bool:
        evaluated = self.fixed_evaluated.get(column.index)
        if evaluated is None:
            evaluated = self.fixed_evaluated[column.index] = bool(self.cs.evaluates_fixed(column))
        return evaluated

    def assign_region(self, name, assignment):
        keeps_layout = self.keeps_layout
        recorder = SingleChipLayouterRegion if keeps_layout else SingleChipAdviceRegion
        region = recorder(self, len(self.regions))
        result = assignment(Region(region))

        t0 = None if self.shape_s is None else time.perf_counter()
        region_start = 0
        for column in region.columns:
            start = self.columns.get(column, 0)
            if start > region_start:
                region_start = start
        self.regions.append(region_start)
        # from the set's stored hashes: no Column.__hash__ call
        self.columns.update(dict.fromkeys(region.columns, region_start + region.row_count))
        if t0 is not None:
            self.shape_s += time.perf_counter() - t0

        if keeps_layout:
            self.cs.enter_region(name)
            self._replay(region.calls, region_start)
            self.cs.exit_region()
            num_constants = len(region.constants)
        else:
            self.cs.store_advice(region_start, region_start + region.row_count, region.advice)
            num_constants = region.num_constants

        if num_constants:
            if not self.constants:
                raise NotEnoughColumnsForConstants()
            constants_column = self.constants[0]
            next_constant_row = self.columns.get(constants_column, 0)
            if keeps_layout:
                for constant, advice in region.constants:
                    self.cs.assign_fixed_value(
                        constants_column, next_constant_row, Value.known(constant)
                    )
                    self.cs.copy(
                        constants_column,
                        next_constant_row,
                        advice.column,
                        self.regions[advice.region_index] + advice.row_offset,
                    )
                    next_constant_row += 1
            else:
                next_constant_row += num_constants
            self.columns[constants_column] = next_constant_row

        return result

    def _replay(self, calls, region_start: int):
        """Make a region's recorded backend calls, at absolute rows."""
        cs = self.cs
        regions = self.regions
        for call in calls:
            kind = call[0]
            if kind == _ADVICE:
                cs.assign_advice_value(call[1], region_start + call[2], call[3])
            elif kind == _FIXED:
                cs.assign_fixed_value(call[1], region_start + call[2], call[3])
            elif kind == _COPY:
                left, right = call[1], call[2]
                cs.copy(
                    left.column, regions[left.region_index] + left.row_offset,
                    right.column, regions[right.region_index] + right.row_offset,
                )
            elif kind == _SELECTOR:
                cs.enable_selector(call[1], region_start + call[2])
            else:
                cs.copy(call[1], region_start + call[2], call[3], call[4])

    def assign_table(self, name, assignment):
        keeps_layout = self.keeps_layout
        if keeps_layout:
            self.cs.enter_region(name)
        table = SimpleTableLayouter(self.cs if keeps_layout else None, self.table_columns)
        assignment(Table(table))
        daa = table.default_and_assigned
        if keeps_layout:
            self.cs.exit_region()

        lengths = set()
        for default, flags in daa.values():
            if not all(flags):
                raise SynthesisError("table column has unassigned gaps")
            lengths.add(len(flags))
        if len(lengths) != 1:
            raise SynthesisError("table columns have differing lengths")
        first_unused = lengths.pop()

        for column in daa:
            self.table_columns.append(column)
        for column, (default, flags) in daa.items():
            if default is None:
                raise SynthesisError("table column missing default value")
            if keeps_layout:
                self.cs.fill_from_row(column.inner, first_unused, default)

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        if not self.keeps_layout:
            return
        self.cs.copy(
            cell.column,
            self.regions[cell.region_index] + cell.row_offset,
            instance,
            row,
        )

    def get_challenge(self, challenge):
        return self.cs.get_challenge(challenge)

    def get_root(self):
        return self

    def push_namespace(self, name):
        self.cs.push_namespace(name)

    def pop_namespace(self, gadget_name=None):
        self.cs.pop_namespace(gadget_name)


class SimpleFloorPlanner:
    @staticmethod
    def synthesize(cs: Assignment, circuit, config, constants: List[Column]):
        layouter = SingleChipLayouter(cs, constants)
        if profiling.enabled():
            layouter.shape_s = 0.0
        try:
            return circuit.synthesize(config, layouter)
        finally:
            if layouter.shape_s is not None:
                profiling.add(SHAPE_PHASE, layouter.shape_s)


class Circuit:
    """Base class for circuits (reference plonk/circuit.rs Circuit trait)."""

    floor_planner = SimpleFloorPlanner

    def without_witnesses(self) -> "Circuit":
        raise NotImplementedError

    @classmethod
    def configure(cls, meta):
        raise NotImplementedError

    def synthesize(self, config, layouter: Layouter):
        raise NotImplementedError
