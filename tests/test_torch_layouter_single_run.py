"""``SimpleFloorPlanner`` runs each region's closure once.

``SingleChipLayouter`` runs a closure into a region recorder, which measures
the region and records what the backend keeps; the layouter then places the
region and hands the backend the recorded calls.  A backend states whether
it keeps the layout (``Assignment.keeps_layout``).  Over the three backends
the planner drives (the prover's ``WitnessCollection`` in both phases, which
keeps no layout, keygen's ``KeygenAssembly`` and ``MockProver``), on a small
circuit with a table, regions of four shapes, selectors, a constant,
instance copies and a second-phase column that reads a challenge:

- each closure runs once: the circuit's count of its closure runs equals
  the layouter's number of regions;
- a ``to`` runs once where the backend evaluates its column, and never
  where the backend skips it;
- the region starts equal those of the JAX package's ``SimpleFloorPlanner``
  on the same circuit, as do the backends' own records; for keygen and
  ``MockProver`` so does every backend call (regions, selectors, advice and
  fixed cells with their values, copies, table fills), in order; the
  witness gets only its phase's advice values, through ``store_advice``, in
  the order, rows and values of the JAX run's advice calls, and no other
  call;
- the calls each backend receives, counted from what it logged, and those
  left out, here and for BenchPlonk;
- a backend that keeps no layout needs no store the layouter knows: one
  with only ``store_advice``, ``evaluates_advice``, ``query_instance`` and
  ``get_challenge`` gets what ``WitnessCollection`` gets;
- a region past the usable rows still raises ``NotEnoughRowsAvailable``, and
  a witness value that is neither an ``int`` nor an ``Assigned`` raises
  ``to_assigned``'s ``TypeError``.
"""

import collections
import importlib
import types

import pytest
import torch

torch.set_num_threads(1)

K = 5
INSTANCE_X = 10
CHALLENGE = 12345
BACKENDS = ("witness", "keygen", "mock")


def frontend(pkg: str) -> types.SimpleNamespace:
    """The names this test needs from ``halo2_tpu_torch`` or ``halo2_tpu``."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    circuit, layouter, value = mod("plonk.circuit"), mod("circuit.layouter"), mod("circuit.value")
    return types.SimpleNamespace(
        pkg=pkg,
        Circuit=layouter.Circuit,
        SingleChipLayouter=layouter.SingleChipLayouter,
        Value=value.Value,
        to_assigned=value.to_assigned,
        ConstraintSystem=circuit.ConstraintSystem,
        FIRST_PHASE=circuit.FIRST_PHASE,
        SECOND_PHASE=circuit.SECOND_PHASE,
        Rotation=mod("poly.polynomial").Rotation,
        WitnessCollection=mod("plonk.prover").WitnessCollection,
        KeygenAssembly=mod("plonk.keygen").KeygenAssembly,
        SimpleFloorPlanner=layouter.SimpleFloorPlanner,
        MockProver=mod("dev.mock_prover").MockProver,
        NotEnoughRowsAvailable=mod("plonk.error").NotEnoughRowsAvailable,
        spec=mod("fields.spec").BN254_FR,
    )


PORT = frontend("halo2_tpu_torch")


def layout_circuit(fe):
    """A circuit of four regions of different shapes, written against
    ``fe``'s frontend, and a table of four rows.  It counts its closure
    runs and, by column name, the runs of the ``to`` of each advice, fixed
    and table cell it assigns."""

    class LayoutCircuit(fe.Circuit):
        def __init__(self, x, height: int = 3):
            self.x = x  # Value: the instance's first cell
            self.height = height  # rows of the second-phase region
            self.closure_runs = 0
            self.to_runs = collections.Counter()

        def without_witnesses(self):
            return LayoutCircuit(fe.Value.unknown(), self.height)

        @classmethod
        def configure(cls, meta):
            a, b = meta.advice_column(), meta.advice_column()
            z = meta.advice_column(fe.SECOND_PHASE)
            f, constants = meta.fixed_column(), meta.fixed_column()
            inst = meta.instance_column()
            for col in (a, b, z, inst):
                meta.enable_equality(col)
            meta.enable_constant(constants)
            q_mul, q_z = meta.selector(), meta.selector()
            ch = meta.challenge_usable_after(fe.FIRST_PHASE)
            cur = fe.Rotation.cur()

            def mul(c):  # b = a * f
                return [c.query_selector(q_mul) * (
                    c.query_advice(a, cur) * c.query_fixed(f, cur) - c.query_advice(b, cur))]

            def second(c):  # z = a * ch
                return [c.query_selector(q_z) * (
                    c.query_advice(z, cur) - c.query_advice(a, cur) * c.query_challenge(ch))]

            meta.create_gate("mul", mul)
            meta.create_gate("second phase", second)
            t = meta.lookup_table_column()
            meta.lookup("b in t", lambda c: [(c.query_advice(b, cur), t)])
            return {"a": a, "b": b, "z": z, "f": f, "inst": inst,
                    "q_mul": q_mul, "q_z": q_z, "ch": ch, "t": t}

        def synthesize(self, config, layouter):
            p = fe.spec.p
            ch = layouter.get_challenge(config["ch"])

            def to(name, value):
                def run():
                    self.to_runs[name] += 1
                    return value
                return run

            def counted(closure):
                def run(region):
                    self.closure_runs += 1
                    return closure(region)
                return run

            def load(region):  # a, b, f and q_mul; rows 0-1
                x = region.assign_advice_from_instance(config["inst"], 0, config["a"], 0)
                region.assign_fixed(config["f"], 0, to("f", fe.Value.known(3)))
                config["q_mul"].enable(region, 0)
                y = region.assign_advice(config["b"], 0, to("b", x.value.map(lambda v: 3 * v % p)))
                region.assign_advice_from_constant(config["a"], 1, 7)
                return y

            def second_phase(region):  # a, z and q_z; starts at row 2, below load
                cells = []
                for i in range(self.height):
                    av = self.x.map(lambda v, i=i: (v + i) % p)
                    cells.append(region.assign_advice(config["a"], i, to("a", av)))
                    config["q_z"].enable(region, i)
                    zv = av.zip(ch).map(lambda t: t[0] * t[1] % p)
                    region.assign_advice(config["z"], i, to("z", zv))
                region.constrain_equal(cells[0].cell, y.cell)
                return cells[-1]

            def fixed_only(region):  # f alone; starts at row 2, beside second phase
                region.assign_fixed(config["f"], 0, to("f", fe.Value.known(5)))
                region.assign_fixed(config["f"], 1, to("f", fe.Value.known(6)))

            def after_fixed(region):  # b and f; starts at row 4, below fixed only
                region.assign_fixed(config["f"], 0, to("f", fe.Value.known(8)))
                return region.assign_advice(config["b"], 0, to("b", fe.Value.known(11)))

            def table(tbl):  # four rows of t
                for i in range(4):
                    tbl.assign_cell(config["t"], i, to("t", fe.Value.known(30 + i)))

            layouter.assign_table("table", table)
            y = layouter.assign_region("load", counted(load))
            last = layouter.assign_region("second phase", counted(second_phase))
            layouter.assign_region("fixed only", counted(fixed_only))
            layouter.assign_region("after fixed", counted(after_fixed))
            layouter.constrain_instance(last.cell, config["inst"], 1)

    return LayoutCircuit


def _column(col):
    return (col.kind, col.index, col.phase)


def logged(fe, cls):
    """``cls`` with a log of every backend call the layouter makes, in order,
    with the values the backend returns, and, for ``WitnessCollection``, a
    log of the writes into its store (``stores``: the port's
    ``store_advice`` calls; ``writes``: the values each stores, as the JAX
    package's witness writes them from its ``assign_advice``); instance
    queries are not logged."""

    def stored(v):
        a = fe.to_assigned(v)
        return (a.numerator % fe.spec.p, a.denominator % fe.spec.p)

    def norm(v):
        if v is None or v.is_none():
            return v if v is None else "unknown"
        return stored(v.value())

    class Store(dict):
        def __init__(self, index, writes):
            super().__init__()
            self.index, self.writes = index, writes

        def __setitem__(self, row, v):
            self.writes.append((self.index, row, stored(v)))
            super().__setitem__(row, v)

    class Logged(cls):
        def __init__(self, *args):
            super().__init__(*args)
            self.log = []
            self.stores = []
            self.writes = []
            if fe is not PORT and isinstance(getattr(self, "advice", None), list) and all(
                    isinstance(col, dict) for col in self.advice):
                self.advice = [Store(i, self.writes) for i in range(len(self.advice))]

        def store_advice(self, region_start, region_end, records):
            super().store_advice(region_start, region_end, records)
            self.stores.append((region_start, region_end, list(records)))
            self.writes.extend((index, region_start + offset, stored(v))
                               for index, offset, v in records if v is not None)

        def enter_region(self, name):
            self.log.append(("enter", str(name)))
            return super().enter_region(name)

        def exit_region(self):
            self.log.append(("exit",))
            return super().exit_region()

        def enable_selector(self, selector, row):
            self.log.append(("selector", selector.index, row))
            return super().enable_selector(selector, row)

        def assign_advice(self, column, row, to):
            v = super().assign_advice(column, row, to)
            self.log.append(("advice", _column(column), row, norm(v)))
            return v

        def assign_fixed(self, column, row, to):
            v = super().assign_fixed(column, row, to)
            self.log.append(("fixed", _column(column), row, norm(v)))
            return v

        def copy(self, left_column, left_row, right_column, right_row):
            self.log.append(("copy", _column(left_column), left_row,
                             _column(right_column), right_row))
            return super().copy(left_column, left_row, right_column, right_row)

        def fill_from_row(self, column, row, to):
            self.log.append(("fill", _column(column), row, norm(to)))
            return super().fill_from_row(column, row, to)

    return Logged


def setup(fe, backend: str, height: int = 3, x=INSTANCE_X):
    """(circuit, config, constants, the backends to synthesize into in turn):
    ``WitnessCollection`` gives one per phase, the second with the challenge
    squeezed.  ``x`` is the circuit's witness of the instance's first cell."""
    circuit = layout_circuit(fe)(fe.Value.known(x), height)
    cs = fe.ConstraintSystem()
    config = type(circuit).configure(cs)
    n = 1 << K
    instance = [INSTANCE_X, (INSTANCE_X + height - 1) % fe.spec.p]
    usable = n - (cs.blinding_factors() + 1)
    if backend == "witness":
        cls = logged(fe, fe.WitnessCollection)
        targets = [cls(K, cs, 0, [instance], {}, usable),
                   cls(K, cs, 1, [instance], {0: CHALLENGE}, usable)]
    elif backend == "keygen":
        targets = [logged(fe, fe.KeygenAssembly)(K, cs, n)]
        circuit = circuit.without_witnesses()
    else:
        args = (fe.spec, K, cs) + (("cpu",) if fe is PORT else ())
        mock = logged(fe, fe.MockProver)(*args)
        mock.instance.append(instance)
        targets = [mock]
    return circuit, config, list(cs.constants), targets


def synthesize(fe, circuit, config, constants, target):
    """Synthesize as ``SimpleFloorPlanner.synthesize`` does, keeping the
    layouter."""
    layouter = fe.SingleChipLayouter(target, constants)
    circuit.synthesize(config, layouter)
    return layouter


def records(backend: str, target) -> dict:
    """What each backend keeps of the synthesis, columns by kind and index
    (the port's witness keeps an ``int`` where the JAX package's keeps an
    ``Assigned`` over 1: an ``int``'s numerator is itself, over 1)."""
    if backend == "witness":
        return {"advice": [sorted((r, (a.numerator, a.denominator)) for r, a in col.items())
                           for col in target.advice]}
    if backend == "keygen":
        return {"fixed": [sorted((r, (a.numerator, a.denominator)) for r, a in col.items())
                          for col in target.fixed],
                "selectors": [list(map(bool, s)) for s in target.selectors],
                "mapping": [list(map(int, row)) for row in target.permutation.mapping]}
    return {"advice": [[str(v) for v in col] for col in target.advice],
            "fixed": [[str(v) for v in col] for col in target.fixed],
            "selectors": target.selectors,
            "copies": [(_column(lc), lr, _column(rc), rr) for lc, lr, rc, rr in target.copies],
            "regions": [(r.name, sorted(r.rows), sorted((_column(c), row) for c, row in r.cells))
                        for r in target.regions]}


@pytest.mark.parametrize("backend", BACKENDS)
def test_each_region_closure_runs_once(backend):
    circuit, config, constants, targets = setup(PORT, backend)
    for target in targets:
        circuit.closure_runs = 0
        layouter = synthesize(PORT, circuit, config, constants, target)
        assert len(layouter.regions) == 4
        assert circuit.closure_runs == len(layouter.regions)


# ``to`` runs by column over the synthesis into each backend in turn: the
# circuit assigns a 3 cells, b 2, f 4, z 3 and the table t 4
EXPECTED_TO_RUNS = {
    "witness": [{"a": 3, "b": 2}, {"z": 3}],  # this phase's advice; no fixed, no table
    "keygen": [{"f": 4, "t": 4}],  # fixed alone
    "mock": [{"a": 3, "b": 2, "f": 4, "z": 3, "t": 4}],  # everything
}


@pytest.mark.parametrize("backend", BACKENDS)
def test_to_runs_once_where_the_backend_evaluates_and_never_elsewhere(backend):
    circuit, config, constants, targets = setup(PORT, backend)
    runs = []
    for target in targets:
        circuit.to_runs.clear()
        PORT.Circuit.floor_planner.synthesize(target, circuit, config, constants)
        runs.append(dict(circuit.to_runs))
    assert runs == EXPECTED_TO_RUNS[backend]


def advice_calls(log) -> list:
    """(column index, row, value) of each advice call in ``log`` whose
    backend kept a value."""
    return [(entry[1][1], entry[2], entry[3]) for entry in log
            if entry[0] == "advice" and entry[3] not in (None, "unknown")]


@pytest.mark.parametrize("backend", BACKENDS)
def test_layout_and_backend_calls_equal_the_jax_packages(backend):
    jax = frontend("halo2_tpu")
    got = {}
    for fe in (PORT, jax):
        circuit, config, constants, targets = setup(fe, backend)
        got[fe.pkg] = [
            (synthesize(fe, circuit, config, constants, t).regions, t.log, t.writes,
             records(backend, t))
            for t in targets
        ]
    port, ref = got["halo2_tpu_torch"], got["halo2_tpu"]
    # the layout itself: fixed starts, not only agreement
    assert [regions for regions, _, _, _ in port] == [[0, 2, 2, 4]] * len(port)
    if backend == "witness":
        # no call reaches the witness: its phase's advice values are written
        # into its store, in the order, rows and values of the JAX run's
        # advice calls, and it keeps what the JAX run's witness keeps
        assert [log for _, log, _, _ in port] == [[], []]
        assert [writes for _, _, writes, _ in port] == [advice_calls(log) for _, log, _, _ in ref]
        assert [writes for _, _, writes, _ in port] == [writes for _, _, writes, _ in ref]
        assert [(regions, rec) for regions, _, _, rec in port] == [
            (regions, rec) for regions, _, _, rec in ref]
        assert [len(writes) for _, _, writes, _ in port] == [7, 3]
        return
    assert port == ref
    # the synthesis reached every kind of call
    kinds = {entry[0] for _, log, _, _ in port for entry in log}
    assert {"enter", "exit", "advice", "fixed", "copy", "selector", "fill"} <= kinds


def test_witness_collection_receives_no_layout_call():
    """The witness's store gets its phase's advice, and no fixed cell,
    selector, copy, constant, table cell or fill reaches it."""
    circuit, config, constants, targets = setup(PORT, "witness")
    for target in targets:
        layouter = synthesize(PORT, circuit, config, constants, target)
        assert not layouter.keeps_layout
        assert target.log == []
        assert target.writes
        # the constants column and the table's column stay empty: nothing of
        # them was handed over, and the witness has no fixed store
        assert not hasattr(target, "fixed")


def calls_received(target) -> int:
    """The calls a logged backend received: its logged calls other than
    entering and leaving a region, and the values written into its store."""
    return sum(entry[0] not in ("enter", "exit") for entry in target.log) + len(target.writes)


# the circuit makes 28 calls in all: 5 for the table (4 cells and a fill), 8
# in "load" (constant: a fixed cell and a copy), 10 in "second phase", 2 in
# "fixed only", 2 in "after fixed" and the instance copy
CIRCUIT_CALLS = 28
# (calls the backend received, calls left out) of each synthesis: the
# witness gets the 7 first-phase advice cells in phase 0 and the 3 z cells
# in phase 1
EXPECTED_CALLS = {
    "witness": [(7, 21), (3, 25)],
    "keygen": [(28, 0)],
    "mock": [(28, 0)],
}


@pytest.mark.parametrize("backend", BACKENDS)
def test_layouter_counts_the_calls_it_hands_and_leaves_out(backend):
    circuit, config, constants, targets = setup(PORT, backend)
    counts = []
    for target in targets:
        synthesize(PORT, circuit, config, constants, target)
        received = calls_received(target)
        counts.append((received, CIRCUIT_CALLS - received))
    assert counts == EXPECTED_CALLS[backend]


@pytest.mark.parametrize("backend", ["witness", "keygen"])
def test_layouter_counts_for_benchplonk(backend):
    """BenchPlonk at k=5: 13 iterations of two regions of 3 advice and 4
    fixed cells, and two copies: 78 advice cells, 104 fixed cells and 26
    copies.  The witness gets the 78 advice values; keygen gets all 208
    calls."""
    from torch_circuits import BenchPlonkCircuit

    k = 5
    circuit = BenchPlonkCircuit(k, PORT.Value.known(5))
    cs = PORT.ConstraintSystem()
    config = BenchPlonkCircuit.configure(cs)
    if backend == "witness":
        target = logged(PORT, PORT.WitnessCollection)(
            k, cs, 0, [], {}, (1 << k) - (cs.blinding_factors() + 1))
    else:
        target = logged(PORT, PORT.KeygenAssembly)(k, cs, 1 << k)
        circuit = circuit.without_witnesses()
    layouter = synthesize(PORT, circuit, config, list(cs.constants), target)
    assert len(layouter.regions) == 52
    assert calls_received(target) == (78 if backend == "witness" else 208)
    if backend == "witness":
        assert target.log == []
        assert sum(len(col) for col in target.advice) == len(target.writes) == 78


class AdviceOnly:
    """A backend that keeps no layout and has nothing but the methods a
    ``SingleChipLayouter`` calls on one: no ``advice``, ``k`` or
    ``usable_rows``.  It keeps the ``store_advice`` calls it gets."""

    keeps_layout = False

    def __init__(self, phases, phase, instance, challenges):
        self.phases, self.phase = phases, phase
        self.instance, self.challenges = instance, challenges
        self.stores = []

    def store_advice(self, region_start, region_end, records):
        self.stores.append((region_start, region_end, list(records)))

    def evaluates_advice(self, column):
        return self.phases[column.index] == self.phase

    def query_instance(self, column, row):
        col = self.instance[column.index]
        return PORT.Value.known(col[row] if row < len(col) else 0)

    def get_challenge(self, challenge):
        if challenge.index in self.challenges:
            return PORT.Value.known(self.challenges[challenge.index])
        return PORT.Value.unknown()


def test_a_backend_with_only_store_advice_gets_what_the_witness_gets():
    circuit, config, constants, witnesses = setup(PORT, "witness")

    def norm(stores):
        return [(start, end, [(index, offset, None if v is None else
                               (PORT.to_assigned(v).numerator, PORT.to_assigned(v).denominator))
                              for index, offset, v in records])
                for start, end, records in stores]

    for witness in witnesses:
        backend = AdviceOnly(witness.cs.advice_column_phase, witness.current_phase,
                             witness.instances, witness.challenges)
        layouter = synthesize(PORT, circuit, config, constants, backend)
        assert layouter.regions == [0, 2, 2, 4]
        synthesize(PORT, circuit, config, constants, witness)
        assert norm(backend.stores) == norm(witness.stores)
        assert len(backend.stores) == 4
        kept = {(index, start + offset) for start, _, records in backend.stores
                for index, offset, v in records if v is not None}
        assert kept == {(index, row) for index, col in enumerate(witness.advice) for row in col}


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_region_past_the_usable_rows_raises(backend):
    cs = PORT.ConstraintSystem()
    layout_circuit(PORT).configure(cs)
    usable = (1 << K) - (cs.blinding_factors() + 1)
    # the second-phase region starts at row 2: its last row is the first unusable one
    circuit, config, constants, targets = setup(PORT, backend, height=usable - 1)
    for target in targets:
        with pytest.raises(PORT.NotEnoughRowsAvailable):
            PORT.Circuit.floor_planner.synthesize(target, circuit, config, constants)


def test_a_witness_value_neither_int_nor_assigned_raises():
    """A float where the circuit should give an ``int`` or an ``Assigned``
    raises ``to_assigned``'s ``TypeError`` on the path that keeps no
    layout, as the backend's own ``assign_advice`` does."""
    circuit, config, constants, targets = setup(PORT, "witness", x=1.5)
    with pytest.raises(TypeError, match="cannot convert <class 'float'> to Assigned"):
        PORT.SimpleFloorPlanner.synthesize(targets[0], circuit, config, constants)
