"""SHA-256 (Table16) in halo2_tpu_torch against the JAX package and hashlib.

The host primitives equal hashlib and the JAX package's, round trace
included; the spread utilities and tags equal the JAX package's at their
boundaries; the spread-table chip with a test-sized table gives the JAX
package's MockProver outcome.  The whole k=17 circuit is held to the JAX
package structurally: its gates' Display, its cost, and the keygen assembly
of "abc" (fixed columns, selectors, permutation mapping), array for array.
A Sigma_1 block laid out at the end of the usable rows, whose gate reads a
dozen rows ahead, gives the same failure list on the vectorised path as on
both packages' per-row paths.  The full k=17 MockProver runs cost ~50 s of
host time a side and are ``slow``; phase 16(a) of chip_smoke.py runs them on
the card.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import test_sha256 as jsha
import torch_circuits as tc
from torch_circuits import failure_summary as summary
import halo2_tpu.circuit as jax_circuit
import halo2_tpu.gadgets.sha256 as jax_sha
import halo2_tpu.gadgets.sha256.table16 as jax_table16
from halo2_tpu.circuit import Value as JV
from halo2_tpu.dev import CircuitCost as JaxCircuitCost
from halo2_tpu.dev import CircuitGates as JaxCircuitGates
from halo2_tpu.dev import MockProver as JaxMockProver
from halo2_tpu.fields.spec import BN254_FR as JAX_FR
from halo2_tpu.plonk.circuit import ConstraintSystem as JaxConstraintSystem
from halo2_tpu.plonk.keygen import KeygenAssembly as JaxKeygenAssembly
from halo2_tpu.plonk.keygen import compress_selectors as jax_compress_selectors
import halo2_tpu_torch.circuit as port_circuit
import halo2_tpu_torch.gadgets.sha256 as sha
import halo2_tpu_torch.gadgets.sha256.table16 as table16
from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.dev import CircuitCost, CircuitGates, MockProver
from halo2_tpu_torch.fields.spec import BN254_FR
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import KeygenAssembly, compress_selectors

torch.set_num_threads(1)  # host-bound synthesis and small limb tensors; xdist runs several workers

P = BN254_FR.p
K = 17
MESSAGES = [b"", b"abc", b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
            b"x" * 55, b"x" * 56, b"x" * 64, b"x" * 200]


def test_digest_equals_hashlib_and_jax():
    for msg in MESSAGES + [tc.sha256_bench_message()]:
        digest = sha.sha256_digest(msg)
        assert digest == hashlib.sha256(msg).digest() == jax_sha.sha256_digest(msg)
        assert sha.pad_message(msg) == jax_sha.pad_message(msg)
    assert len(sha.pad_message(tc.sha256_bench_message())) == 31
    assert tc.sha256_instance(b"abc") == jsha._digest_instance(b"abc")


def test_compress_trace_equals_jax():
    from halo2_tpu.gadgets.sha256 import primitives as jprim
    from halo2_tpu_torch.gadgets.sha256 import primitives as prim

    assert (prim.IV, prim.ROUND_CONSTANTS, prim.M32) == (jprim.IV, jprim.ROUND_CONSTANTS, jprim.M32)
    state, jstate = list(prim.IV), list(jprim.IV)
    for block in sha.pad_message(tc.sha256_bench_message())[:3]:
        ours = sha.sha256_compress(state, block, trace=True)
        assert ours == jax_sha.sha256_compress(jstate, block, trace=True)
        assert len(ours[1]) == 64 and ours[2][:16] == block
        state = jstate = ours[0]


def test_spread_utilities_equal_jax():
    rs = np.random.default_rng(17)
    values = [0, 1, 2, 0x7F, 0x80, 0x3FF, 0x400, 0x7FF, 0x800, 0x1FFF, 0x2000, 0x3FFF, 0x4000,
              0xBEEF, 0xFFFF] + [int(v) for v in rs.integers(0, 1 << 16, 64)]
    for x in values:
        s = sha.spread_u16(x)
        assert s == jax_sha.spread_u16(x) == sha.interleave_u16(x)
        assert sha.get_tag(x) == jax_sha.get_tag(x)
        assert sha.even_bits(s, 16) == x and sha.odd_bits(s, 16) == 0
        y = int(rs.integers(0, 1 << 16))
        t = s + sha.spread_u16(y)
        assert (sha.even_bits(t, 16), sha.odd_bits(t, 16)) == (x ^ y, x & y)
        assert (sha.even_bits(t, 16), sha.odd_bits(t, 16)) == (
            jax_sha.even_bits(t, 16), jax_sha.odd_bits(t, 16))
    assert [sha.get_tag(v) for v in (0x7F, 0x80, 0x3FF, 0x400, 0x7FF, 0x800, 0x1FFF, 0x2000,
                                     0x3FFF, 0x4000)] == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5]
    word = sha.SpreadWord(0x1234)
    assert (word.tag, word.spread) == (jax_sha.SpreadWord(0x1234).tag, jax_sha.spread_u16(0x1234))


@pytest.mark.parametrize("word", [0x00, 0x5A, 0xFF, 0x100, 0x1FF])
def test_spread_table_chip_equals_jax(word):
    """k = 9 with the 8-bit test table: a 9-bit word is not in it."""
    prover = MockProver.run(BN254_FR, 9, tc.SmallSpreadCircuit(Value.known(word)), [],
                            device="cpu")
    want = summary(JaxMockProver.run(JAX_FR, 9, jsha.SmallSpreadCircuit(JV.known(word)), [])
                   .verify(vectorized=False))
    assert summary(prover.verify(vectorized=False)) == want
    assert summary(prover.verify(vectorized=True)) == want
    assert [f[0] for f in want] == ([] if word < 0x100 else ["Lookup"])


# -- the whole k=17 circuit, structurally --------------------------------------


def _fields(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, (int, str, list, tuple))}


def test_gates_and_cost_equal_jax():
    text = str(CircuitGates.collect(tc.Sha256Circuit))
    assert text == str(JaxCircuitGates.collect(jsha.Sha256Circuit)) and "sha256 Sigma_1" in text
    cost = CircuitCost.measure(K, tc.Sha256Circuit.of(b"abc"))
    jcost = JaxCircuitCost.measure(K, jsha.Sha256Circuit(
        [[JV.known(w) for w in blk] for blk in jax_sha.pad_message(b"abc")]))
    assert _fields(cost) == _fields(jcost) and _fields(cost)
    for instances in (1, 2):
        assert (dataclasses.asdict(cost.proof_size(instances))
                == dataclasses.asdict(jcost.proof_size(instances)))
    assert (dataclasses.asdict(cost.marginal_proof_size())
            == dataclasses.asdict(jcost.marginal_proof_size()))


def test_constraint_system_shape():
    """8 advice, 5 fixed and 1 instance column, 11 selectors and gates,
    degree 5, one lookup, 8 permutation columns (the JAX package's too)."""
    shapes = []
    for cs, circuit in ((ConstraintSystem(), tc.Sha256Circuit),
                        (JaxConstraintSystem(), jsha.Sha256Circuit)):
        circuit.configure(cs)
        shapes.append((cs.num_advice_columns, cs.num_fixed_columns, cs.num_instance_columns,
                       cs.num_selectors, len(cs.gates), cs.degree(), len(cs.lookups),
                       len(cs.permutation.columns), cs.blinding_factors()))
    assert shapes[0] == shapes[1]
    assert shapes[0][:8] == (8, 5, 1, 11, 11, 5, 1, 8)


def test_keygen_assembly_equals_jax():
    """The keygen synthesis of "abc" at k=17, array for array."""
    n = 1 << K
    assemblies = []
    for cs_cls, assembly_cls, circuit in (
            (ConstraintSystem, KeygenAssembly, tc.Sha256Circuit.of(b"abc")),
            (JaxConstraintSystem, JaxKeygenAssembly, jsha.Sha256Circuit(
                [[JV.known(w) for w in blk] for blk in jax_sha.pad_message(b"abc")]))):
        cs = cs_cls()
        config = type(circuit).configure(cs)
        assembly = assembly_cls(K, cs, n)
        circuit.floor_planner.synthesize(assembly, circuit, config, list(cs.constants))
        assemblies.append((cs, assembly))
    (cs, a), (jcs, ja) = assemblies
    assert a.usable_rows == ja.usable_rows
    assert len(a.fixed) == len(ja.fixed) == 5  # the table's 3, the round and the IV constants
    assert sorted(len(col) for col in a.fixed)[2:] == [a.usable_rows] * 3  # filled to the end
    for col, jcol in zip(a.fixed, ja.fixed):
        assert {r: v.evaluate(P) for r, v in col.items()} == {
            r: v.evaluate(P) for r, v in jcol.items()}
    assert len(a.selectors) == len(ja.selectors) == 11
    for sel, jsel in zip(a.selectors, ja.selectors):
        assert np.array_equal(sel, jsel) and sel.any()
    assert ([(c.kind, c.index) for c in a.permutation.columns]
            == [(c.kind, c.index) for c in ja.permutation.columns])
    for name in ("mapping", "aux", "sizes"):
        assert np.array_equal(getattr(a.permutation, name), getattr(ja.permutation, name)), name
    for sv, jsv in zip(compress_selectors(cs, a.selectors),
                       jax_compress_selectors(jcs, ja.selectors), strict=True):
        assert np.array_equal(np.asarray(sv), np.asarray(jsv))


# -- a Sigma_1 block at the end of the usable rows -----------------------------


def sigma_at_end_circuit(circuit_mod, value_cls, t16, word: int, offset: int):
    """A Table16 Sigma_1 block whose last row is the last usable row, when
    ``offset`` is usable_rows - 14; its table holds only the rows the block
    looks up, so that the circuit fits k = 11.  Built on either package."""
    pat = t16.BIG_SIGMA_1
    pieces = [(word >> off) & ((1 << w) - 1) for w, off in zip(pat.widths, pat.offsets)]
    total = sum(pat.spread_coeff(i) * t16.spread_u16(v) for i, v in enumerate(pieces))
    even, odd = t16.even_bits(total, 32), t16.odd_bits(total, 32)
    dense = {0, word & 0xFFFF, word >> 16, even & 0xFFFF, even >> 16, odd & 0xFFFF, odd >> 16}
    dense |= set(pieces) | {v << (16 - w) for v, w in zip(pieces, pat.widths)
                            if w < 16 and w not in t16.TAG_FOR_WIDTH}

    class SigmaAtEnd(circuit_mod.Circuit):
        def without_witnesses(self):
            return self

        @classmethod
        def configure(cls, meta):
            return t16.Table16Chip.configure(meta)

        def synthesize(self, config, layouter):
            chip = t16.Table16Chip(config)
            lookup = config.lookup

            def table(tbl):
                for row, d in enumerate(sorted(dense)):
                    tbl.assign_cell(lookup.table_tag, row, lambda d=d: t16.get_tag(d))
                    tbl.assign_cell(lookup.table_dense, row, lambda d=d: d)
                    tbl.assign_cell(lookup.table_spread, row, lambda d=d: t16.spread_u16(d))

            layouter.get_root().assign_table("spread table", table)
            x = chip.assign_word(layouter, "x", value_cls.known(word))
            layouter.assign_region("filler", lambda region: chip._assign_lookup_row(
                region, offset, value_cls.known(0)))
            chip.sigma(layouter, "Sigma_1/0", pat, x)

    return SigmaAtEnd()


@pytest.mark.parametrize("tamper", ["none", "last_row", "first_row"])
def test_sigma_block_at_end_vectorised_equals_per_row(tamper):
    """Rotation(r) for r up to 10 from the block's first row: a change in its
    last row (a shift-range row) or its first row fails the gate at the first
    row, on the vectorised path as on the per-row paths of both packages."""
    word, k = 0xDEADBEEF, 11
    cs = ConstraintSystem()
    table16.Table16Chip.configure(cs)
    usable = (1 << k) - cs.blinding_factors() - 1
    assert max(rot.i for _, rot in cs.advice_queries) == 10
    provers = [
        MockProver.run(BN254_FR, k, sigma_at_end_circuit(port_circuit, Value, table16, word,
                                                         usable - 14), [], device="cpu"),
        JaxMockProver.run(JAX_FR, k, sigma_at_end_circuit(jax_circuit, JV, jax_table16, word,
                                                          usable - 14), []),
    ]
    region = next(r for r in provers[0].regions if r.name == "Sigma_1/0")
    first, last = min(region.rows), max(region.rows)
    assert (first, last) == (usable - 11, usable - 1)
    if tamper != "none":
        row = last if tamper == "last_row" else first
        for pr in provers:  # advice 1 is Table16's dense column
            pr.advice[1][row] = (pr.advice[1][row] + 1) % P
    want = summary(provers[1].verify(vectorized=False))
    assert summary(provers[0].verify(vectorized=False)) == want
    assert summary(provers[0].verify(vectorized=True)) == want
    if tamper == "none":
        assert want == []
    else:
        assert {(f[0], f[3]) for f in want if f[0] == "ConstraintNotSatisfied"} == {
            ("ConstraintNotSatisfied", first)}
        assert any(f[0] == "Lookup" for f in want)


# -- the full circuit under MockProver (slow: ~50 s of host time a side) ------


@pytest.mark.slow
@pytest.mark.parametrize("wrong_digest", [False, True])
def test_sha256_circuit_abc_equals_jax(wrong_digest):
    instance = tc.sha256_instance(b"abc")
    if wrong_digest:
        instance[0] ^= 1
    prover = MockProver.run(BN254_FR, K, tc.Sha256Circuit.of(b"abc"), [instance], device="cpu")
    jprover = JaxMockProver.run(JAX_FR, K, jsha.Sha256Circuit(
        [[JV.known(w) for w in blk] for blk in jax_sha.pad_message(b"abc")]), [instance])
    want = summary(jprover.verify(vectorized=False))
    assert summary(prover.verify(vectorized=False)) == want
    assert summary(prover.verify(vectorized=True)) == want
    assert {f[0] for f in want} == ({"Permutation"} if wrong_digest else set())
