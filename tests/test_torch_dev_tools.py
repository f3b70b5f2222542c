"""The dev tools of halo2_tpu_torch against the JAX package's.

MockProver's two paths on the port (the vectorised one evaluates each gate
over all rows as limb tensors, here on the CPU through the plain K1) must give
the failure list of the JAX package's per-row path, kind, gate, row and
Display string, for every failure kind: ConstraintNotSatisfied,
ConstraintPoisoned, Lookup, Permutation and CellNotAssigned.  The JAX side
only ever runs host paths (``verify(vectorized=False)``, cost, gates, graph),
never its vectorised verify or ``create_proof``, which compile for minutes.
Also held to the JAX package: ``CircuitCost``, ``CircuitGates``, the DOT and
SVG renderers, the V1 floor planner, ``convert_selectors``, the examples'
circuits, the MockProver cases of tests/test_shuffle.py and
tests/test_utilities.py; and the prover's ``HALO2_TPU_SANITY_CHECKS``
asserts, which pass on a valid proof and fire on a broken copy constraint.
"""

import dataclasses
import os
import random
import sys

import numpy as np
import pytest
import torch

import circuits as jc
import test_shuffle as jshuffle
import test_utilities as jutil
import torch_circuits as tc
from torch_circuits import failure_summary as summary
from halo2_tpu.circuit import V1FloorPlanner as JaxV1FloorPlanner
from halo2_tpu.circuit import Value as JV
from halo2_tpu.dev import CircuitCost as JaxCircuitCost
from halo2_tpu.dev import CircuitGates as JaxCircuitGates
from halo2_tpu.dev import CircuitLayout as JaxCircuitLayout
from halo2_tpu.dev import MockProver as JaxMockProver
from halo2_tpu.dev import circuit_dot_graph as jax_circuit_dot_graph
from halo2_tpu.fields.spec import BN254_FR as JAX_FR
from halo2_tpu.fields.spec import PASTA_FP as JAX_FP
from halo2_tpu_torch.circuit import Value as TV
from halo2_tpu_torch.dev import (
    CircuitCost,
    CircuitGates,
    CircuitLayout,
    MockProver,
    VerifyFailure,
    circuit_dot_graph,
)
from halo2_tpu_torch.fields.spec import BN254_FR, PASTA_FP
from halo2_tpu_torch.gadgets.utilities import bitrange_subset, decompose_word

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples"))
import two_chip as jtwo_chip  # noqa: E402  (the JAX package's examples/two_chip.py)

from halo2_tpu_torch.examples import two_chip  # noqa: E402

P = BN254_FR.p
A = 2834758237 * BN254_FR.zeta % P  # tests/plonk_api.rs common!
TABLE = [2, A, A, 0]


CASES = [(name, k) for k in (5, 11) for name in tc.failure_cases(tc, TV)]


@pytest.mark.parametrize("name,k", CASES)
def test_vectorised_and_per_row_failures_equal_jax(name, k):
    jax_circuit, instances, tamper, kinds = tc.failure_cases(jc, JV)[name]
    port_circuit = tc.failure_cases(tc, TV)[name][0]
    jp = JaxMockProver.run(JAX_FR, k, jax_circuit, instances)
    tp = MockProver.run(BN254_FR, k, port_circuit, instances, device="cpu")
    if tamper is not None:
        tamper(jp)
        tamper(tp)
    want = summary(jp.verify(vectorized=False))
    assert {f[0] for f in want} == kinds
    assert summary(tp.verify(vectorized=True)) == want
    assert summary(tp.verify(vectorized=False)) == want
    if k == 11:  # n > 1024: verify() picks the vectorised path by itself
        assert summary(tp.verify()) == want


def test_bench_plonk_tampered_cell():
    """The failures chip_smoke.py expects at k=17, here at k=12 on both
    paths: exactly the product gate and the copy at the tampered row."""
    prover = MockProver.run(BN254_FR, 12, tc.BenchPlonkCircuit(12, TV.known(2)), [],
                            device="cpu")
    assert prover.verify() == []
    want = tc.tamper_bench_plonk(prover, 1000)
    for vectorized in (True, False):
        got = prover.verify(vectorized=vectorized)
        assert [(f.kind, f.row, str(f)) for f in got] == want


def test_vectorised_columns_follow_the_device():
    tp = MockProver.run(BN254_FR, 11, tc.SimpleCircuit(7, TV.known(5)),
                        [[7 * pow(5, 4, P) % P]], device="cpu")
    fixed, advice, instance = tp._vec_columns()
    for vals, mask in fixed + advice + instance:
        assert vals.device.type == "cpu" and vals.shape == (16, 2048)
        assert mask.dtype == torch.bool and mask.shape == (2048,)
    # unusable advice rows are poisoned; assigned rows are not
    assert bool(advice[0][1][tp.usable_rows:].all()) and not bool(advice[0][1][:8].any())
    assert MockProver.run(BN254_FR, 4, tc.SimpleCircuit(7, TV.known(5)), [[0]]).device.type == "cuda"


@pytest.mark.parametrize("rotation", [-1, 1])
def test_vectorised_rotation_sign(rotation):
    """A gate that reads a cell at row + rotation sees what the per-row path
    sees: one advice value changed at row r fails exactly row r - rotation."""
    from halo2_tpu_torch.circuit import Circuit
    from halo2_tpu_torch.poly import Rotation

    class Shifted(Circuit):
        def without_witnesses(self):
            return self

        @classmethod
        def configure(cls, meta):
            a, b = meta.advice_column(), meta.advice_column()
            s = meta.selector()
            meta.create_gate("shift", lambda cells: [cells.query_selector(s) * (
                cells.query_advice(a, Rotation(rotation)) - cells.query_advice(b, Rotation.cur()))])
            return a, b, s

        def synthesize(self, config, layouter):
            a, b, s = config

            def do(region):
                for row in range(1, 30):
                    s.enable(region, row)
                for row in range(32):
                    region.assign_advice(a, row, lambda r=row: TV.known(r * r + 3))
                    region.assign_advice(b, row, lambda r=row: TV.known((r + rotation) ** 2 + 3))

            layouter.assign_region("rows", do)

    prover = MockProver.run(BN254_FR, 6, Shifted(), [], device="cpu")
    assert prover.verify(vectorized=True) == []
    prover.advice[0][10] += 1
    vec = prover.verify(vectorized=True)
    assert [f.row for f in vec] == [10 - rotation]
    assert summary(vec) == summary(prover.verify(vectorized=False))


def test_lookup_range_circuit_vectorised_equals_per_row():
    """The dev_lookup.rs circuit at k=11 (n > 1024): satisfied, then one
    value out of the table gives exactly one Lookup failure at its row."""
    prover = MockProver.run(BN254_FR, 11, tc.LookupRangeCircuit(11), [], device="cpu")
    assert prover.verify() == []
    prover.advice[0][700] = 300
    failures = prover.verify()
    assert [(f.kind, f.row) for f in failures] == [("Lookup", 700)]
    assert summary(failures) == summary(prover.verify(vectorized=False))


def test_verify_failure_display():
    f = VerifyFailure("Lookup", lookup_index=0, row=3)
    assert str(f) == "Lookup row=3 lookup=0"


# -- shuffle, utilities and the examples' circuits under MockProver ----------


class SmallShuffle(tc.ShuffleCircuit):
    W = 2
    H = 8


class NoAssertShuffle(SmallShuffle):
    check_telescopes = False


def _forged_pair(rng):
    original = [[rng.randrange(P) for _ in range(SmallShuffle.H)] for _ in range(SmallShuffle.W)]
    forged = [list(c) for c in tc.shuffled_copy(original, rng)]
    forged[0][0] = (forged[0][0] + 1) % P  # not a permutation any more
    return original, forged


def test_shuffle_mock_prover_equals_jax():
    good = SmallShuffle.rand(P, random.Random(1))
    assert MockProver.run(BN254_FR, 5, good, [], device="cpu").verify() == []
    original, forged = _forged_pair(random.Random(2))
    port = MockProver.run(BN254_FR, 5, NoAssertShuffle(P, TV.known(original), TV.known(forged)),
                          [], device="cpu")
    jax = JaxMockProver.run(JAX_FR, 5, jshuffle.NoAssertShuffle(
        P, JV.known(original), JV.known(forged)), [])
    want = summary(jax.verify(vectorized=False))
    assert "z should end with 1" in {f[1] for f in want}
    assert summary(port.verify(vectorized=True)) == want
    assert summary(port.verify(vectorized=False)) == want


def test_shuffle_witness_sanity_assert_fires():
    """The in-witness telescoping assert (the reference's `sanity-checks`
    feature, shuffle.rs:236) catches a forged shuffle during synthesis."""
    original, forged = _forged_pair(random.Random(2))
    with pytest.raises(AssertionError, match="telescope"):
        MockProver.run(BN254_FR, 5, SmallShuffle(P, TV.known(original), TV.known(forged)), [],
                       device="cpu")


# name: (k, the port's circuit, the JAX package's circuit, witness values)
UTIL_CASES = {
    "cond_swap": (5, "CondSwapCircuit", "CondSwapCircuit", (11, 22, False)),
    "cond_swap_swapped": (5, "CondSwapCircuit", "CondSwapCircuit", (11, 22, True)),
    "running_sum": (5, "RunningSumCircuit", "RunningSumCircuit", (0b101_110_011,)),
    "running_sum_out_of_range": (5, "RunningSumCircuit", "RunningSumCircuit", (1 << 9,)),
    "lookup_range_check": (7, "LookupRangeCheckCircuit", "LookupRangeCircuit", (0xAB,)),
    "lookup_range_check_out_of_range": (7, "LookupRangeCheckCircuit", "LookupRangeCircuit",
                                        (0x1AB,)),
}


@pytest.mark.parametrize("name", list(UTIL_CASES))
def test_utilities_mock_prover_equals_jax(name):
    k, port_cls, jax_cls, values = UTIL_CASES[name]
    jax = getattr(jutil, jax_cls)(*map(JV.known, values))
    want = summary(JaxMockProver.run(JAX_FP, k, jax, []).verify(vectorized=False))
    port = MockProver.run(PASTA_FP, k, getattr(tc, port_cls)(*map(TV.known, values)), [],
                          device="cpu")
    assert summary(port.verify(vectorized=True)) == want
    assert summary(port.verify(vectorized=False)) == want
    assert bool(want) == name.endswith("out_of_range")


def test_utilities_host_helpers_equal_jax():
    from halo2_tpu.gadgets.utilities import bitrange_subset as jax_bitrange
    from halo2_tpu.gadgets.utilities import decompose_word as jax_decompose

    rs = np.random.default_rng(7)
    for word in [0b1011_0110_0101, 0, (1 << 12) - 1] + [int(v) for v in rs.integers(0, 1 << 12, 8)]:
        for window in (1, 2, 3, 4):
            windows = decompose_word(word, 12, window)
            assert windows == jax_decompose(word, 12, window)
            assert sum(w << (window * i) for i, w in enumerate(windows)) == word
        for lo, hi in ((0, 4), (4, 8), (8, 12), (3, 11)):
            assert bitrange_subset(word, lo, hi) == jax_bitrange(word, lo, hi)


@pytest.mark.parametrize("d_offset", [0, 1])
def test_two_chip_mock_prover_equals_jax(d_offset):
    d = ((7 + 11) * 13 + d_offset) % P
    jax = JaxMockProver.run(JAX_FR, 4, jtwo_chip.FieldCircuit(JV.known(7), JV.known(11),
                                                               JV.known(13)), [[d]])
    port = MockProver.run(BN254_FR, 4, two_chip.FieldCircuit(TV.known(7), TV.known(11),
                                                             TV.known(13)), [[d]], device="cpu")
    want = summary(jax.verify(vectorized=False))
    assert bool(want) == bool(d_offset)
    assert summary(port.verify(vectorized=True)) == want
    assert summary(port.verify(vectorized=False)) == want


# -- cost, gates, graph, the V1 floor planner, convert_selectors -------------


class JaxV1Simple(jc.SimpleCircuit):
    floor_planner = JaxV1FloorPlanner

    def without_witnesses(self):
        return JaxV1Simple(self.constant, JV.unknown())


def _fields(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, (int, str, list, tuple))}


def test_circuit_cost_equals_jax():
    for k, port, jax in ((4, tc.V1Simple(7, TV.known(5)), JaxV1Simple(7, JV.known(5))),
                         (5, tc.StandardPlonkCircuit(TV.known(A), TABLE),
                          jc.StandardPlonkCircuit(JV.known(A), TABLE))):
        cost, jcost = CircuitCost.measure(k, port), JaxCircuitCost.measure(k, jax)
        assert _fields(cost) == _fields(jcost) and _fields(cost)
        for instances in (1, 2, 3):
            assert (dataclasses.asdict(cost.proof_size(instances))
                    == dataclasses.asdict(jcost.proof_size(instances)))
        assert (dataclasses.asdict(cost.marginal_proof_size())
                == dataclasses.asdict(jcost.marginal_proof_size()))
        assert cost.proof_size(2).total() - cost.proof_size(1).total() == \
            cost.marginal_proof_size().total()


@pytest.mark.parametrize("which", ["v1_simple", "standard", "poseidon", "running_sum",
                                   "lookup_range_check", "shuffle"])
def test_circuit_gates_equal_jax(which):
    import test_poseidon as jposeidon

    port, jax = {
        "v1_simple": (tc.V1Simple, JaxV1Simple),
        "standard": (tc.StandardPlonkCircuit, jc.StandardPlonkCircuit),
        "poseidon": (tc.HashCircuit, jposeidon.HashCircuit),
        "running_sum": (tc.RunningSumCircuit, jutil.RunningSumCircuit),
        "lookup_range_check": (tc.LookupRangeCheckCircuit, jutil.LookupRangeCircuit),
        "shuffle": (SmallShuffle, jshuffle.SmallShuffle),
    }[which]
    text = str(CircuitGates.collect(port))
    assert text == str(JaxCircuitGates.collect(jax)) and "queries:" in text


def test_graph_and_layout_equal_jax(tmp_path):
    from halo2_tpu_torch.examples import circuit_layout

    for port, jax, k, inst in ((tc.SimpleCircuit(7, TV.known(5)), jc.SimpleCircuit(7, JV.known(5)),
                                4, [[7 * 5 ** 4 % P]]),
                               (tc.StandardPlonkCircuit(TV.unknown(), TABLE),
                                jc.StandardPlonkCircuit(JV.unknown(), TABLE), 5, [[2]])):
        dot = circuit_dot_graph(BN254_FR, port)
        assert dot == jax_circuit_dot_graph(JAX_FR, jax) and "->" in dot
        svg = CircuitLayout().render(BN254_FR, k, port, inst)
        assert svg == JaxCircuitLayout().render(JAX_FR, k, jax, inst) and svg.endswith("</svg>")
    # the example writes the last pair's strings
    assert circuit_layout.main(str(tmp_path)) == (svg, dot)
    assert (tmp_path / "layout.svg").read_text() == svg
    assert (tmp_path / "circuit.dot").read_text() == dot


def _regions(prover):
    return [(r.name, sorted(r.rows), sorted((c.kind, c.index, row) for c, row in r.cells))
            for r in prover.regions]


@pytest.mark.parametrize("a", [5, 6])
def test_v1_floor_planner_equals_jax(a):
    inst = [[7 * pow(5, 4, P) % P]]
    port = MockProver.run(BN254_FR, 4, tc.V1Simple(7, TV.known(a)), inst, device="cpu")
    jax = JaxMockProver.run(JAX_FR, 4, JaxV1Simple(7, JV.known(a)), inst)
    assert _regions(port) == _regions(jax)
    assert port.fixed == jax.fixed and port.advice == jax.advice
    want = summary(jax.verify(vectorized=False))
    assert bool(want) == (a != 5)
    assert summary(port.verify(vectorized=True)) == summary(port.verify(vectorized=False)) == want


def test_v1_floor_planner_into_the_witness_equals_jax():
    """``V1FloorPlanner`` into the prover's ``WitnessCollection`` keeps the
    advice values that the JAX package's keeps (an ``int`` of the port's is
    an ``Assigned`` over 1 of the JAX package's)."""
    from halo2_tpu.plonk.circuit import ConstraintSystem as JaxConstraintSystem
    from halo2_tpu.plonk.prover import WitnessCollection as JaxWitnessCollection
    from halo2_tpu_torch.plonk.circuit import ConstraintSystem
    from halo2_tpu_torch.plonk.prover import WitnessCollection

    k = 4
    inst = [7 * pow(5, 4, P) % P]
    stores = []
    for cs_cls, witness_cls, circuit in (
            (ConstraintSystem, WitnessCollection, tc.V1Simple(7, TV.known(5))),
            (JaxConstraintSystem, JaxWitnessCollection, JaxV1Simple(7, JV.known(5)))):
        cs = cs_cls()
        config = type(circuit).configure(cs)
        usable = (1 << k) - (cs.blinding_factors() + 1)
        witness = witness_cls(k, cs, 0, [inst], {}, usable)
        circuit.floor_planner.synthesize(witness, circuit, config, list(cs.constants))
        stores.append([
            sorted((row, (v % P, 1) if isinstance(v, int) else (v.numerator % P, v.denominator % P))
                   for row, v in col.items())
            for col in witness.advice])
    assert stores[0] == stores[1]
    assert sum(map(len, stores[0])) > 0


def test_convert_selectors_equals_jax():
    from halo2_tpu.plonk.circuit import ConstraintSystem as JaxConstraintSystem
    from halo2_tpu.plonk.keygen import convert_selectors as jax_convert_selectors
    from halo2_tpu_torch.plonk.circuit import ConstraintSystem
    from halo2_tpu_torch.plonk.keygen import convert_selectors

    rs = np.random.default_rng(3)
    sels = [rs.integers(0, 2, 16).astype(bool) for _ in range(4)]
    out = []
    for cs_cls, circuit_cls, convert in ((ConstraintSystem, SmallShuffle, convert_selectors),
                                         (JaxConstraintSystem, jshuffle.SmallShuffle,
                                          jax_convert_selectors)):
        cs = cs_cls()
        circuit_cls.configure(cs)
        before = cs.num_fixed_columns
        values = convert(cs, sels[:cs.num_selectors])
        out.append((cs.num_fixed_columns - before, [v.tolist() for v in values],
                    [c.index for c in cs.selector_map],
                    [p.identifier() for g in cs.gates for p in g.polys]))
    assert out[0] == out[1]
    assert out[0][0] == 3 and all("selector" not in e for e in out[0][3])


# -- the prover's sanity asserts ----------------------------------------------


def _prove_simple(params, pk, instance):
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.plonk import create_proof
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng

    return create_proof(params, pk, [tc.SimpleCircuit(7, TV.known(5))], [[[instance]]],
                        FieldRng(BN254_FR, b"sanity-rng"), Blake2bTranscript(BN254_G1),
                        gwc_create_proof)


def test_prover_sanity_assert_fires(monkeypatch):
    """HALO2_TPU_SANITY_CHECKS=1: a wrong instance breaks the copy constraint
    to the instance column, and the permutation product's assert stops the
    prover.  (tests/test_torch_poseidon.py makes the pinned proof with the
    asserts on: they pass on a valid proof and change no byte.)"""
    from halo2_tpu_torch.plonk import keygen_pk, keygen_vk
    from halo2_tpu_torch.poly.kzg import ParamsKZG

    params = ParamsKZG.setup_host(4, seed=b"sanity", device="cpu")
    empty = tc.SimpleCircuit(7, TV.unknown())
    pk = keygen_pk(params, keygen_vk(params, empty), empty)
    monkeypatch.setenv("HALO2_TPU_SANITY_CHECKS", "1")
    with pytest.raises(AssertionError, match="permutation product"):
        _prove_simple(params, pk, 7 * pow(5, 4, P) % P + 1)
