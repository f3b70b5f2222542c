"""``SimpleFloorPlanner`` runs each region's closure once.

``SingleChipLayouter`` runs a closure into ``SingleChipLayouterRegion``,
which measures the region and records its backend calls; the layouter then
places the region and replays the calls.  Over the three backends the
planner drives (the prover's ``WitnessCollection`` in both phases, keygen's
``KeygenAssembly`` and ``MockProver``), on a small circuit with regions of
four shapes, selectors, a constant, instance copies and a second-phase
column that reads a challenge:

- each closure runs once, and the layouter's ``closure_runs`` equals its
  number of regions;
- a ``to`` runs once where the backend evaluates its column, and never
  where the backend skips it;
- the region starts and every backend call (regions, selectors, advice and
  fixed cells with their values, copies), in order, equal those of the JAX
  package's ``SimpleFloorPlanner`` on the same circuit, as do the backends'
  own records;
- a region past the usable rows still raises ``NotEnoughRowsAvailable``.
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
        MockProver=mod("dev.mock_prover").MockProver,
        NotEnoughRowsAvailable=mod("plonk.error").NotEnoughRowsAvailable,
        spec=mod("fields.spec").BN254_FR,
    )


PORT = frontend("halo2_tpu_torch")


def layout_circuit(fe):
    """A circuit of four regions of different shapes, written against
    ``fe``'s frontend.  It counts its closure runs and, by column name, the
    runs of the ``to`` of each advice and fixed cell it assigns."""

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
            return {"a": a, "b": b, "z": z, "f": f, "inst": inst,
                    "q_mul": q_mul, "q_z": q_z, "ch": ch}

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
    with the values the backend returns; instance queries are not logged."""

    def norm(v):
        if v is None or v.is_none():
            return v if v is None else "unknown"
        a = fe.to_assigned(v.value())
        return (a.numerator % fe.spec.p, a.denominator % fe.spec.p)

    class Logged(cls):
        def __init__(self, *args):
            super().__init__(*args)
            self.log = []

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

    return Logged


def setup(fe, backend: str, height: int = 3):
    """(circuit, config, constants, the backends to synthesize into in turn):
    ``WitnessCollection`` gives one per phase, the second with the challenge
    squeezed."""
    circuit = layout_circuit(fe)(fe.Value.known(INSTANCE_X), height)
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
    """What each backend keeps of the synthesis, columns by kind and index."""
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
        assert circuit.closure_runs == layouter.closure_runs == len(layouter.regions)


# ``to`` runs by column over the synthesis into each backend in turn: the
# circuit assigns a 3 cells, b 2, f 4 and z 3
EXPECTED_TO_RUNS = {
    "witness": [{"a": 3, "b": 2}, {"z": 3}],  # this phase's advice; no fixed
    "keygen": [{"f": 4}],  # fixed alone
    "mock": [{"a": 3, "b": 2, "f": 4, "z": 3}],  # everything
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


@pytest.mark.parametrize("backend", BACKENDS)
def test_layout_and_backend_calls_equal_the_jax_packages(backend):
    jax = frontend("halo2_tpu")
    got = {}
    for fe in (PORT, jax):
        circuit, config, constants, targets = setup(fe, backend)
        got[fe.pkg] = [
            (synthesize(fe, circuit, config, constants, t).regions, t.log, records(backend, t))
            for t in targets
        ]
    port, ref = got["halo2_tpu_torch"], got["halo2_tpu"]
    # the layout itself: fixed starts, not only agreement
    assert [regions for regions, _, _ in port] == [[0, 2, 2, 4]] * len(port)
    assert port == ref
    # the synthesis reached every kind of call
    kinds = {entry[0] for _, log, _ in port for entry in log}
    assert {"enter", "exit", "advice", "fixed", "copy"} <= kinds
    assert backend == "witness" or "selector" in kinds


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
