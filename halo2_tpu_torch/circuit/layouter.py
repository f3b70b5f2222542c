"""Region / Layouter plumbing + the single-pass floor planner.

Python rebuild of circuit.rs (Region/AssignedCell/Layouter, SURVEY.md §2.15)
and circuit/floor_planner/single_pass.rs (§2.16): a shape-measuring pass picks
each region's start row (first row at which none of its columns are in use),
then a second pass performs the real assignments against the backend's
``Assignment`` interface.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..plonk.circuit import ADVICE, FIXED, INSTANCE, Challenge, Column, Selector, TableColumn
from ..plonk.error import NotEnoughColumnsForConstants, SynthesisError
from ..poly.polynomial import Rotation
from .value import Assigned, Value, to_assigned


@dataclasses.dataclass(frozen=True)
class Cell:
    region_index: int
    row_offset: int
    column: Column


@dataclasses.dataclass
class AssignedCell:
    value: Value
    cell: Cell

    def copy_advice(self, region: "Region", column: Column, offset: int) -> "AssignedCell":
        ac = region.assign_advice(column, offset, lambda: self.value)
        region.constrain_equal(ac.cell, self.cell)
        return ac


class Assignment:
    """Backend interface (reference plonk/circuit.rs:516-628).  Implemented by
    keygen Assembly, prover WitnessCollection, and MockProver."""

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def enable_selector(self, selector: Selector, row: int):
        raise NotImplementedError

    def query_instance(self, column: Column, row: int) -> Value:
        raise NotImplementedError

    def assign_advice(self, column: Column, row: int, to: Callable[[], Value]):
        """Backends RETURN the evaluated Value when they ran ``to`` (or None
        when they skipped it, e.g. phase filtering / keygen) so region layers
        can hand the value to AssignedCell without wrapper closures."""
        raise NotImplementedError

    def assign_fixed(self, column: Column, row: int, to: Callable[[], Value]):
        raise NotImplementedError

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
    def __init__(self, layouter: "RegionLayouterBase"):
        self._l = layouter

    def assign_advice(self, column: Column, offset: int, to) -> AssignedCell:
        to = _as_value_fn(to)
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
        to = _as_value_fn(to)
        cell, value = self._l.assign_fixed(column, offset, to)
        return AssignedCell(value, cell)

    def constrain_constant(self, cell: Cell, constant):
        self._l.constrain_constant(cell, to_assigned(constant))

    def constrain_equal(self, left: Cell, right: Cell):
        self._l.constrain_equal(left, right)

    def enable_selector(self, selector: Selector, offset: int):
        self._l.enable_selector(selector, offset)


def _as_value_fn(to):
    if callable(to):
        return lambda: _coerce_value(to())
    return lambda: _coerce_value(to)


def _coerce_value(v) -> Value:
    if isinstance(v, Value):
        return v
    if isinstance(v, (int, Assigned)):
        return Value.known(v)
    raise TypeError(f"cannot use {type(v)} as an assignment value")


class Table:
    def __init__(self, layouter: "SimpleTableLayouter"):
        self._l = layouter

    def assign_cell(self, column: TableColumn, offset: int, to):
        self._l.assign_cell(column, offset, _as_value_fn(to))


# ---------------------------------------------------------------------------
# Region layouters
# ---------------------------------------------------------------------------


class RegionLayouterBase:
    pass


class RegionShape(RegionLayouterBase):
    """Measurement pass: records which columns are used and the row count."""

    def __init__(self, region_index: int):
        self.region_index = region_index
        self.columns: set = set()  # Column or ('selector', idx)
        self.row_count = 0

    def _see(self, column, offset):
        self.columns.add(column)
        self.row_count = max(self.row_count, offset + 1)

    def enable_selector(self, selector, offset):
        self._see(("selector", selector.index), offset)

    def assign_advice(self, column, offset, to):
        self._see(column, offset)
        return Cell(self.region_index, offset, column), Value.unknown()

    def assign_advice_from_constant(self, column, offset, constant):
        return self.assign_advice(column, offset, lambda: Value.known(constant))

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


class SingleChipLayouterRegion(RegionLayouterBase):
    def __init__(self, layouter: "SingleChipLayouter", region_index: int):
        self.layouter = layouter
        self.region_index = region_index
        self.constants: List[Tuple[Assigned, Cell]] = []

    def _abs(self, offset: int) -> int:
        return self.layouter.regions[self.region_index] + offset

    def enable_selector(self, selector, offset):
        self.layouter.cs.enable_selector(selector, self._abs(offset))

    def assign_advice(self, column, offset, to):
        v = self.layouter.cs.assign_advice(column, self._abs(offset), to)
        return (
            Cell(self.region_index, offset, column),
            Value.unknown() if v is None else v,
        )

    def assign_advice_from_constant(self, column, offset, constant):
        cell, value = self.assign_advice(column, offset, lambda: Value.known(constant))
        self.constrain_constant(cell, constant)
        return cell, value

    def assign_advice_from_instance(self, instance, row, advice, offset):
        value = self.layouter.cs.query_instance(instance, row)
        cell, _ = self.assign_advice(advice, offset, lambda: value)
        self.layouter.cs.copy(
            cell.column, self.layouter.regions[cell.region_index] + cell.row_offset,
            instance, row,
        )
        return cell, value

    def instance_value(self, instance, row):
        return self.layouter.cs.query_instance(instance, row)

    def assign_fixed(self, column, offset, to):
        v = self.layouter.cs.assign_fixed(column, self._abs(offset), to)
        return (
            Cell(self.region_index, offset, column),
            Value.unknown() if v is None else v,
        )

    def constrain_constant(self, cell, constant):
        self.constants.append((to_assigned(constant), cell))

    def constrain_equal(self, left: Cell, right: Cell):
        self.layouter.cs.copy(
            left.column,
            self.layouter.regions[left.region_index] + left.row_offset,
            right.column,
            self.layouter.regions[right.region_index] + right.row_offset,
        )


class SimpleTableLayouter:
    def __init__(self, cs: Assignment, used_columns):
        self.cs = cs
        self.used_columns = used_columns
        # column -> (default value Value | None, [assigned flags])
        self.default_and_assigned: Dict[TableColumn, list] = {}

    def assign_cell(self, column: TableColumn, offset: int, to):
        if column in self.used_columns:
            raise SynthesisError("table column already used")
        entry = self.default_and_assigned.setdefault(column, [None, []])

        v = self.cs.assign_fixed(column.inner, offset, to)
        if offset == 0:
            if entry[0] is None:
                # The default is SET even when the backend never ran the
                # closure (prover WitnessCollection ignores fixed
                # assignments): mirror single_pass.rs DefaultTableValue =
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
    """single_pass.rs:40-247."""

    def __init__(self, cs: Assignment, constants: List[Column]):
        self.cs = cs
        self.constants = constants
        self.regions: List[int] = []
        self.columns: Dict[object, int] = {}
        self.table_columns: List[TableColumn] = []

    def assign_region(self, name, assignment):
        region_index = len(self.regions)
        shape = RegionShape(region_index)
        assignment(Region(shape))

        region_start = 0
        for column in shape.columns:
            region_start = max(region_start, self.columns.get(column, 0))
        self.regions.append(region_start)
        for column in shape.columns:
            self.columns[column] = region_start + shape.row_count

        self.cs.enter_region(name)
        region = SingleChipLayouterRegion(self, region_index)
        result = assignment(Region(region))
        constants_to_assign = region.constants
        self.cs.exit_region()

        if not self.constants:
            if constants_to_assign:
                raise NotEnoughColumnsForConstants()
        else:
            constants_column = self.constants[0]
            next_constant_row = self.columns.get(constants_column, 0)
            for constant, advice in constants_to_assign:
                self.cs.assign_fixed(
                    constants_column, next_constant_row, lambda: Value.known(constant)
                )
                self.cs.copy(
                    constants_column,
                    next_constant_row,
                    advice.column,
                    self.regions[advice.region_index] + advice.row_offset,
                )
                next_constant_row += 1
            self.columns[constants_column] = next_constant_row

        return result

    def assign_table(self, name, assignment):
        self.cs.enter_region(name)
        table = SimpleTableLayouter(self.cs, self.table_columns)
        assignment(Table(table))
        daa = table.default_and_assigned
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
            self.cs.fill_from_row(column.inner, first_unused, default)

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
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
        return circuit.synthesize(config, layouter)


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
