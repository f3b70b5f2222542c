"""The witness's per-cell objects and its store.

``Cell`` and ``AssignedCell`` are ``__slots__`` classes: a ``Cell`` is equal
and hashed by its region, row and column.  ``WitnessCollection`` keeps each
advice value as the circuit gave it, an ``int`` or an ``Assigned``, and
``batch_invert_assigned`` reads both: an ``int`` v is v mod p over 1, with
the same limbs as ``Assigned(v, 1)``, and a column of such values takes the
all-trivial shortcut (no inversion).
"""

import pytest
import torch

from halo2_tpu_torch.circuit import Assigned, AssignedCell, Cell, SimpleFloorPlanner, Value
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.fields.spec import BN254_FR
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import batch_invert_assigned
from halo2_tpu_torch.plonk.prover import WitnessCollection

torch.set_num_threads(1)

P = BN254_FR.p
N = 8


def test_cell_is_equal_and_hashed_by_its_three_fields():
    cs = ConstraintSystem()
    a, b = cs.advice_column(), cs.advice_column()
    cell = Cell(1, 2, a)
    same = Cell(1, 2, a)
    assert cell == same and hash(cell) == hash(same)
    assert len({cell, same}) == 1 and {cell: "x"}[same] == "x"
    for other in (Cell(0, 2, a), Cell(1, 3, a), Cell(1, 2, b)):
        assert cell != other
    assert cell != (1, 2, a)
    assert (cell.region_index, cell.row_offset, cell.column) == (1, 2, a)
    with pytest.raises(AttributeError):
        cell.extra = 0  # __slots__: no per-instance dict


def test_assigned_cell_keeps_its_value_and_cell():
    cell = Cell(0, 0, ConstraintSystem().advice_column())
    value = Value.known(5)
    ac = AssignedCell(value, cell)
    assert ac.value is value and ac.cell is cell
    assert not hasattr(ac, "__dict__")


def _limbs(columns):
    return [p.values for p in batch_invert_assigned(BN254_FR, columns, N, "cpu")]


def _finv_calls(monkeypatch):
    calls = []
    finv = limb.finv

    def counted(*args, **kwargs):
        calls.append(1)
        return finv(*args, **kwargs)

    monkeypatch.setattr(limb, "finv", counted)
    return calls


def test_batch_invert_assigned_reads_ints_as_assigned_over_one(monkeypatch):
    values = {0: 0, 1: 1, 2: P - 1, 3: -5, 4: P + 7, 6: 123456789 << 200}
    ints = [values, {5: 9}]
    assigned = [{r: Assigned(v, 1) for r, v in values.items()}, {5: Assigned(9)}]
    mixed = [{r: (v if r % 2 else Assigned(v, 1)) for r, v in values.items()}, {5: 9}]
    calls = _finv_calls(monkeypatch)
    got = [_limbs(cols) for cols in (ints, assigned, mixed)]
    assert calls == []  # every column trivial: no inversion
    for cols in got[1:]:
        assert all(torch.equal(x, y) for x, y in zip(got[0], cols))
    assert limb.to_ints(BN254_FR, got[0][0]) == [0, 1, P - 1, P - 5, 7, 0, (123456789 << 200) % P, 0]


def test_batch_invert_assigned_of_a_rational_beside_ints(monkeypatch):
    quotient = 3 * pow(4, -1, P) % P
    rational = [{0: Assigned(3, 4), 1: 11, 2: Assigned(6, 1)}]
    plain = [{0: quotient, 1: 11, 2: 6}]
    calls = _finv_calls(monkeypatch)
    (got,) = _limbs(rational)
    assert calls == [1]  # the rational cell takes the inversion
    (want,) = _limbs(plain)
    assert torch.equal(got, want)
    assert limb.to_ints(BN254_FR, got)[:3] == [quotient, 11, 6]


class _Values:
    """A circuit of one region that assigns the given values, one a row, in
    one advice column."""

    def __init__(self, values):
        self.values = values

    @staticmethod
    def configure(meta):
        return meta.advice_column()

    def synthesize(self, column, layouter):
        def region(r):
            for row, v in enumerate(self.values):
                r.assign_advice(column, row, lambda v=v: Value.known(v))
        layouter.assign_region("values", region)


def test_witness_store_holds_values_as_the_circuit_gave_them():
    values = [7, Assigned(3, 4), -1, Assigned(5, 1)]
    cs = ConstraintSystem()
    column = _Values.configure(cs)
    witness = WitnessCollection(4, cs, 0, [], {}, 10)
    SimpleFloorPlanner.synthesize(witness, _Values(values), column, [])
    assert list(witness.advice[0].items()) == list(enumerate(values))
    assert [type(v) for v in witness.advice[0].values()] == [int, Assigned, int, Assigned]
