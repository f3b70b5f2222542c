"""Test circuits for the halo2_tpu_torch port.

Copies, written against the port's frontend so that nothing here imports
jax, of ``tests/circuits.SimpleCircuit`` (simple-example.rs),
``tests/circuits.BenchPlonkCircuit``
(the reference's benches/plonk.rs workload), ``tests/circuits.
StandardPlonkCircuit`` (tests/plonk_api.rs, the circuit of the pinned
``tests/data/plonk_api_*_k5.hex`` proofs); and ``LookupRangeCircuit``,
the shape of the reference's benches/dev_lookup.rs circuit.  ``EntryCircuit``,
the circuit of the pinned proof ``tests/data/dryrun_proof_k6.hex``
(``__graft_entry__._EntryCircuit``), lives in ``halo2_tpu_torch/entry.py``
and is re-exported here, as is ``ShuffleCircuit`` (a second-phase advice
column), which lives in ``halo2_tpu_torch/examples/shuffle.py``.

The gadget circuits are copies of the JAX package's test circuits:
``V1Simple`` (tests/test_dev_tools.py), the utilities' ``CondSwapCircuit``,
``RunningSumCircuit`` and ``LookupRangeCheckCircuit`` (tests/test_utilities.py,
where the last is named ``LookupRangeCircuit``), and Poseidon's
``HashCircuit`` (tests/test_poseidon.py, pow5.rs) with ``PastaHashCircuit``,
its P128Pow5T3 over Pallas Fp: the reference's benches/poseidon.rs circuit.
The SHA-256, ECC, Sinsemilla and soundness circuits are copies of those of
tests/test_sha256.py, test_ecc_gadget.py, test_ecc_mul_fixed.py,
test_sinsemilla.py (its ``HashCircuit`` is ``SinsemillaHashCircuit`` here) and
test_soundness_regressions.py, each with an ``of`` constructor for the inputs
those tests use.
"""

import functools
import hashlib
import random

import numpy as np

from halo2_tpu_torch.circuit import Circuit, SimpleFloorPlanner, V1FloorPlanner, Value
from halo2_tpu_torch.curves import PALLAS, host
from halo2_tpu_torch.dev.mock_prover import UNASSIGNED
from halo2_tpu_torch.entry import EntryCircuit  # noqa: F401  (the pinned k=6 proof's circuit)
from halo2_tpu_torch.examples.shuffle import ShuffleCircuit, shuffled_copy  # noqa: F401
from halo2_tpu_torch.fields.spec import BN254_FR, PASTA_FP
from halo2_tpu_torch.gadgets.ecc import EccChip
from halo2_tpu_torch.gadgets.ecc.mul_fixed import FQ, MulFixedChip
from halo2_tpu_torch.gadgets.poseidon import ConstantLength, PoseidonHashGadget, Pow5Chip, p128_pow5_t3
from halo2_tpu_torch.gadgets.sha256 import (
    Sha256,
    SpreadTableChip,
    Table16Chip,
    get_tag,
    pad_message,
    spread_u16,
)
from halo2_tpu_torch.gadgets.sinsemilla import primitives as sinsemilla_prim
from halo2_tpu_torch.gadgets.sinsemilla.chip import K as SINSEMILLA_K
from halo2_tpu_torch.gadgets.sinsemilla.chip import (
    CommitDomainGadget,
    HashDomainGadget,
    SinsemillaChip,
    message_from_bitstring,
)
from halo2_tpu_torch.gadgets.sinsemilla.chip import _ev as sinsemilla_ev
from halo2_tpu_torch.gadgets.sinsemilla.merkle import (
    MERKLE_CRH_PERSONALIZATION,
    MerkleChip,
    MerklePath,
)
from halo2_tpu_torch.gadgets.utilities import (
    CondSwapChip,
    LookupRangeCheckConfig,
    RunningSumConfig,
    i2lebsp,
    load_private,
)
from halo2_tpu_torch.plonk.circuit import ADVICE, Constant
from halo2_tpu_torch.poly import Rotation


class SimpleCircuit(Circuit):
    """simple-example.rs: out = constant * a^4 via three mul regions (a copy
    of ``tests/circuits.SimpleCircuit``).

    Exercises: custom gate with selector, equality (permutation), constants,
    instance exposure.
    """

    def __init__(self, constant: int, a):
        self.constant = constant
        self.a = a  # Value

    def without_witnesses(self):
        return SimpleCircuit(self.constant, Value.unknown())

    @classmethod
    def configure(cls, meta):
        advice = [meta.advice_column(), meta.advice_column()]
        instance = meta.instance_column()
        constant = meta.fixed_column()
        meta.enable_equality(instance)
        meta.enable_constant(constant)
        for column in advice:
            meta.enable_equality(column)
        s_mul = meta.selector()

        def gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_mul)
            return [("mul", s * (lhs * rhs - out))]

        meta.create_gate("mul", gate)
        return {"advice": advice, "instance": instance, "constant": constant, "s_mul": s_mul}

    def synthesize(self, config, layouter):
        advice = config["advice"]

        def load_private(value):
            def do(region):
                return region.assign_advice(advice[0], 0, lambda: value)

            return layouter.namespace("load private").assign_region("load private", do)

        def load_constant(c):
            def do(region):
                return region.assign_advice_from_constant(advice[0], 0, c)

            return layouter.namespace("load constant").assign_region("load constant", do)

        def mul(a_cell, b_cell):
            def do(region):
                config["s_mul"].enable(region, 0)
                a_cell.copy_advice(region, advice[0], 0)
                b_cell.copy_advice(region, advice[1], 0)
                value = a_cell.value * b_cell.value
                return region.assign_advice(advice[0], 1, lambda: value)

            return layouter.namespace("mul").assign_region("mul", do)

        a = load_private(self.a)
        c = load_constant(self.constant)
        ab = mul(a, a)
        absq = mul(ab, ab)
        out = mul(c, absq)
        layouter.namespace("expose").constrain_instance(out.cell, config["instance"], 0)


class BenchPlonkCircuit(Circuit):
    """benches/plonk.rs MyCircuit: domain-filling standard plonk.

    (2^(k-1) - 3) iterations of {raw_multiply, raw_add, 2 copies} over 3
    advice + 4 fixed columns with a/b/c in the permutation; no lookup or
    instance columns.
    """

    def __init__(self, k: int, a):
        self.k = k
        self.a = a  # Value (canonical int)

    def without_witnesses(self):
        return BenchPlonkCircuit(self.k, Value.unknown())

    @classmethod
    def configure(cls, meta):
        a = meta.advice_column()
        b = meta.advice_column()
        c = meta.advice_column()
        meta.enable_equality(a)
        meta.enable_equality(b)
        meta.enable_equality(c)
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()
        sm = meta.fixed_column()

        def gate(cells):
            a_q = cells.query_advice(a, Rotation.cur())
            b_q = cells.query_advice(b, Rotation.cur())
            c_q = cells.query_advice(c, Rotation.cur())
            sa_q = cells.query_fixed(sa, Rotation.cur())
            sb_q = cells.query_fixed(sb, Rotation.cur())
            sc_q = cells.query_fixed(sc, Rotation.cur())
            sm_q = cells.query_fixed(sm, Rotation.cur())
            return [a_q * sa_q + b_q * sb_q + a_q * b_q * sm_q - (c_q * sc_q)]

        meta.create_gate("Combined add-mult", gate)
        return {"a": a, "b": b, "c": c, "sa": sa, "sb": sb, "sc": sc, "sm": sm}

    def synthesize(self, config, layouter):
        def raw(name, sa_v, sb_v, sm_v, vals):
            def do(region):
                lhs = region.assign_advice(config["a"], 0, lambda: vals.map(lambda t: t[0]))
                rhs = region.assign_advice(config["b"], 0, lambda: vals.map(lambda t: t[1]))
                out = region.assign_advice(config["c"], 0, lambda: vals.map(lambda t: t[2]))
                region.assign_fixed(config["sa"], 0, sa_v)
                region.assign_fixed(config["sb"], 0, sb_v)
                region.assign_fixed(config["sc"], 0, 1)
                region.assign_fixed(config["sm"], 0, sm_v)
                return lhs.cell, rhs.cell, out.cell

            return layouter.assign_region(name, do)

        def copy(left, right):
            layouter.assign_region("copy", lambda region: region.constrain_equal(left, right))

        a = self.a
        a_sq = a.square()
        fin = a_sq + a
        mul_vals = a.zip(a_sq).map(lambda t: (t[0], t[0], t[1]))
        add_vals = a.zip(a_sq).zip(fin).map(lambda t: (t[0][0], t[0][1], t[1]))
        for _ in range((1 << (self.k - 1)) - 3):
            a0, _, c0 = raw("raw_multiply", 0, 0, 1, mul_vals)
            a1, b1, _ = raw("raw_add", 1, 1, 0, add_vals)
            copy(a0, a1)
            copy(b1, c0)


class StandardPlonkCircuit(Circuit):
    """tests/plonk_api.rs:23-400 MyCircuit: standard plonk + lookup.

    Columns (creation order mirrors the reference configure): advice e, a, b;
    fixed sf; advice c, d; instance p; fixed sm, sa, sb, sc, sp; lookup table
    sl.  Gates: "Combined add-mult" a*sa + b*sb + a*b*sm - c*sc + sf*(d_next *
    e_prev) and "Public input" sp*(a - p); one lookup a ∈ sl.
    """

    def __init__(self, a, lookup_table):
        self.a = a  # Value (canonical int)
        self.lookup_table = list(lookup_table)

    def without_witnesses(self):
        return StandardPlonkCircuit(Value.unknown(), self.lookup_table)

    @classmethod
    def configure(cls, meta):
        e = meta.advice_column()
        a = meta.advice_column()
        b = meta.advice_column()
        sf = meta.fixed_column()
        c = meta.advice_column()
        d = meta.advice_column()
        p = meta.instance_column()

        meta.enable_equality(a)
        meta.enable_equality(b)
        meta.enable_equality(c)

        sm = meta.fixed_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()
        sp = meta.fixed_column()
        sl = meta.lookup_table_column()

        meta.lookup("lookup", lambda cells: [(cells.query_any(a, Rotation.cur()), sl)])

        def combined_gate(cells):
            d_q = cells.query_advice(d, Rotation.next())
            a_q = cells.query_advice(a, Rotation.cur())
            sf_q = cells.query_fixed(sf, Rotation.cur())
            e_q = cells.query_advice(e, Rotation.prev())
            b_q = cells.query_advice(b, Rotation.cur())
            c_q = cells.query_advice(c, Rotation.cur())
            sa_q = cells.query_fixed(sa, Rotation.cur())
            sb_q = cells.query_fixed(sb, Rotation.cur())
            sc_q = cells.query_fixed(sc, Rotation.cur())
            sm_q = cells.query_fixed(sm, Rotation.cur())
            return [
                a_q * sa_q + b_q * sb_q + a_q * b_q * sm_q
                - (c_q * sc_q) + sf_q * (d_q * e_q)
            ]

        meta.create_gate("Combined add-mult", combined_gate)

        def public_gate(cells):
            a_q = cells.query_advice(a, Rotation.cur())
            p_q = cells.query_instance(p, Rotation.cur())
            sp_q = cells.query_fixed(sp, Rotation.cur())
            return [sp_q * (a_q - p_q)]

        meta.create_gate("Public input", public_gate)

        for col in (sf, e, d, p, sm, sa, sb, sc, sp):
            meta.enable_equality(col)

        return {
            "a": a, "b": b, "c": c, "d": d, "e": e,
            "sa": sa, "sb": sb, "sc": sc, "sm": sm, "sp": sp, "sf": sf,
            "sl": sl,
        }

    def synthesize(self, config, layouter):
        def raw_gate(name, sa_v, sb_v, sc_v, sm_v, vals):
            """vals: Value of (lhs, rhs, out) canonical ints."""

            def do(region):
                lhs = region.assign_advice(config["a"], 0, lambda: vals.map(lambda t: t[0]))
                region.assign_advice(
                    config["d"], 0, lambda: vals.map(lambda t: t[0]).square().square()
                )
                rhs = region.assign_advice(config["b"], 0, lambda: vals.map(lambda t: t[1]))
                region.assign_advice(
                    config["e"], 0, lambda: vals.map(lambda t: t[1]).square().square()
                )
                out = region.assign_advice(config["c"], 0, lambda: vals.map(lambda t: t[2]))
                region.assign_fixed(config["sa"], 0, sa_v)
                region.assign_fixed(config["sb"], 0, sb_v)
                region.assign_fixed(config["sc"], 0, sc_v)
                region.assign_fixed(config["sm"], 0, sm_v)
                return lhs.cell, rhs.cell, out.cell

            return layouter.assign_region(name, do)

        def copy(left, right):
            def do(region):
                region.constrain_equal(left, right)
                region.constrain_equal(left, right)

            layouter.assign_region("copy", do)

        def public_input(value):
            def do(region):
                cell = region.assign_advice(config["a"], 0, lambda: value)
                region.assign_fixed(config["sp"], 0, 1)
                return cell.cell

            return layouter.assign_region("public_input", do)

        public_input(Value.known(2))

        a = self.a
        a_sq = a.square()
        for _ in range(10):
            a0, _, c0 = raw_gate(
                "raw_multiply", 0, 0, 1, 1, a.zip(a_sq).map(lambda t: (t[0], t[0], t[1]))
            )
            fin = a_sq + a
            a1, b1, _ = raw_gate(
                "raw_add", 1, 1, 1, 0,
                a.zip(a_sq).zip(fin).map(lambda t: (t[0][0], t[0][1], t[1])),
            )
            copy(a0, a1)
            copy(b1, c0)

        def table(tbl):
            for index, value in enumerate(self.lookup_table):
                tbl.assign_cell(config["sl"], index, value)

        layouter.assign_table("lookup_table", table)


def plonk_api_common(spec):
    """tests/plonk_api.rs ``common!``: (witness a, instance, lookup table)."""
    a = 2834758237 * spec.zeta % spec.p
    instance = 2
    return a, instance, [instance, a, a, 0]


class LookupRangeCircuit(Circuit):
    """benches/dev_lookup.rs MyCircuit: one advice column, one complex
    selector q and an 8-bit table column holding 1..=256, with the lookup
    (q * advice + (1 - q)) in table.  q is enabled on every usable row, where
    advice = (offset mod 256) + 1."""

    def __init__(self, k: int):
        self.k = k

    def without_witnesses(self):
        return self  # the advice is fixed data, as in the reference

    @classmethod
    def configure(cls, meta):
        q = meta.complex_selector()
        table = meta.lookup_table_column()
        advice = meta.advice_column()

        def lookup(cells):
            sel = cells.query_selector(q)
            value = cells.query_advice(advice, Rotation.cur())
            return [(sel * value + (Constant(1) - sel), table)]

        meta.lookup("lookup", lookup)
        return {"q": q, "table": table, "advice": advice,
                "blinding_factors": meta.blinding_factors()}

    def synthesize(self, config, layouter):
        def fill_table(tbl):
            for row in range(1 << 8):
                tbl.assign_cell(config["table"], row, row + 1)

        layouter.assign_table("8-bit table", fill_table)
        usable = (1 << self.k) - config["blinding_factors"] - 1

        def assign(region):
            for offset in range(usable):
                config["q"].enable(region, offset)
                region.assign_advice(
                    config["advice"], offset, lambda o=offset: Value.known(o % 256 + 1)
                )

        layouter.assign_region("assign values", assign)


def configure_tuple_lookup(meta, rotation):
    """Two advice columns a, b and a two-column lookup
    (a, a^2 + b) in (t0, t1).  Takes the frontend's ``meta`` and ``Rotation``
    so that a test can build the same constraint system in either package."""
    a = meta.advice_column()
    b = meta.advice_column()
    t0 = meta.lookup_table_column()
    t1 = meta.lookup_table_column()

    def lookup(cells):
        a_q = cells.query_advice(a, rotation.cur())
        b_q = cells.query_advice(b, rotation.cur())
        return [(a_q, t0), (a_q * a_q + b_q, t1)]

    meta.lookup("tuple", lookup)
    return {"a": a, "b": b, "t0": t0, "t1": t1, "blinding_factors": meta.blinding_factors()}


class TupleLookupCircuit(Circuit):
    """A two-column lookup, which folds its columns with theta: table rows
    (i, i^2 + 5) for i < 8; every usable row holds a = row mod 8, b = 5."""

    def __init__(self, k: int):
        self.k = k

    def without_witnesses(self):
        return self  # the advice is fixed data

    @classmethod
    def configure(cls, meta):
        return configure_tuple_lookup(meta, Rotation)

    def synthesize(self, config, layouter):
        def fill_table(tbl):
            for i in range(8):
                tbl.assign_cell(config["t0"], i, i)
                tbl.assign_cell(config["t1"], i, i * i + 5)

        layouter.assign_table("tuple table", fill_table)
        usable = (1 << self.k) - config["blinding_factors"] - 1

        def assign(region):
            for row in range(usable):
                region.assign_advice(config["a"], row, lambda r=row: Value.known(r % 8))
                region.assign_advice(config["b"], row, lambda: Value.known(5))

        layouter.assign_region("tuple rows", assign)


class V1Simple(SimpleCircuit):
    """SimpleCircuit laid out by the V1 floor planner."""

    floor_planner = V1FloorPlanner

    def without_witnesses(self):
        return V1Simple(self.constant, Value.unknown())


class CondSwapCircuit(Circuit):
    """utilities/cond_swap.rs test circuit: swap (a, b) when ``swap``."""

    def __init__(self, a, b, swap):
        self.a, self.b, self.swap = a, b, swap

    def without_witnesses(self):
        return CondSwapCircuit(Value.unknown(), Value.unknown(), Value.unknown())

    @classmethod
    def configure(cls, meta):
        advices = [meta.advice_column() for _ in range(5)]
        return CondSwapChip.configure(meta, advices)

    def synthesize(self, config, layouter):
        chip = CondSwapChip(config)
        a = load_private(layouter, config.a, self.a)
        a_sw, b_sw = chip.swap(layouter, (a, self.b), self.swap)
        # check the witnessed swap output on the host
        if not a_sw.value.is_none():
            av, bv, sw = self.a.value(), self.b.value(), self.swap.value()
            assert a_sw.value.value() == (bv if sw else av)
            assert b_sw.value.value() == (av if sw else bv)


class RunningSumCircuit(Circuit):
    """utilities/decompose_running_sum.rs test circuit: 3 windows of 3 bits."""

    WINDOW = 3
    WORD_BITS = 9
    NUM_WINDOWS = 3

    def __init__(self, alpha, strict=True):
        self.alpha = alpha
        self.strict = strict

    def without_witnesses(self):
        return RunningSumCircuit(Value.unknown(), self.strict)

    @classmethod
    def configure(cls, meta):
        z = meta.advice_column()
        q = meta.selector()
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return RunningSumConfig.configure(meta, q, z, cls.WINDOW, PASTA_FP)

    def synthesize(self, config, layouter):
        def do(region):
            config.witness_decompose(
                region, 0, self.alpha, self.strict, self.WORD_BITS, self.NUM_WINDOWS
            )

        layouter.namespace("decompose").assign_region("decompose", do)


class LookupRangeCheckCircuit(Circuit):
    """utilities/lookup_range_check.rs test circuit: two 4-bit words."""

    K = 4
    NUM_WORDS = 2

    def __init__(self, value, strict=True):
        self.value = value
        self.strict = strict

    def without_witnesses(self):
        return LookupRangeCheckCircuit(Value.unknown(), self.strict)

    @classmethod
    def configure(cls, meta):
        running_sum = meta.advice_column()
        table_idx = meta.lookup_table_column()
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return LookupRangeCheckConfig.configure(meta, running_sum, table_idx, cls.K, PASTA_FP)

    def synthesize(self, config, layouter):
        config.load(layouter)
        config.witness_check(layouter, self.value, self.NUM_WORDS, self.strict)


class HashCircuit(Circuit):
    """poseidon pow5.rs HashCircuit: hash a 2-word message with P128Pow5T3
    over BN254 Fr (width 3, rate 2) and expose the digest as instance 0."""

    spec = p128_pow5_t3(BN254_FR)

    def __init__(self, message, output):
        self.message = message  # Value of list[int] (len 2)
        self.output = output

    def without_witnesses(self):
        return type(self)(Value.unknown(), Value.unknown())

    @classmethod
    def configure(cls, meta):
        width = cls.spec.t
        state = [meta.advice_column() for _ in range(width)]
        partial_sbox = meta.advice_column()
        rc_a = [meta.fixed_column() for _ in range(width)]
        rc_b = [meta.fixed_column() for _ in range(width)]
        meta.enable_constant(rc_b[0])
        instance = meta.instance_column()
        meta.enable_equality(instance)
        config = Pow5Chip.configure(meta, cls.spec, state, partial_sbox, rc_a, rc_b)
        return {"pow5": config, "instance": instance}

    def synthesize(self, config, layouter):
        chip = Pow5Chip(config["pow5"])
        message = self.message

        def load(region):
            cells = []
            for i in range(2):
                v = message.map(lambda m, i=i: m[i])
                cells.append(region.assign_advice(config["pow5"].state[i], 0, lambda v=v: v))
            return cells

        words = layouter.namespace("load message").assign_region("load message", load)
        gadget = PoseidonHashGadget(chip, ConstantLength(2))
        out = gadget.hash(layouter.namespace("hash"), words)
        layouter.namespace("expose").constrain_instance(out.cell, config["instance"], 0)


class PastaHashCircuit(HashCircuit):
    """HashCircuit over Pallas Fp: the reference's benches/poseidon.rs
    (P128Pow5T3, width 3, rate 2, a 2-word message), proved over Vesta."""

    spec = p128_pow5_t3(PASTA_FP)


def failure_summary(failures):
    """A MockProver failure list as plain tuples, in order, so that the two
    packages' lists (and their Display strings) compare directly."""
    return [(f.kind, f.gate, f.constraint, f.row, f.region, f.lookup_index, f.gate_index,
             f.constraint_index, str(f)) for f in failures]


# -- MockProver failures of every kind -----------------------------------------
#
# Each tamper edits a prover after synthesis.  The JAX package's MockProver
# keeps the same cells, regions and markers ("unassigned" in both), so a test
# applies the same edit to both packages' provers.


def bump_mult_output(prover):
    """StandardPlonkCircuit: one more in the first assigned cell of advice c
    (the product's output, copy-constrained)."""
    row = next(r for r, v in enumerate(prover.advice[3]) if isinstance(v, int) and v)
    prover.advice[3][row] = (prover.advice[3][row] + 1) % prover.spec.p


def poison_first_row(prover):
    """StandardPlonkCircuit: sf = 1 at row 0, where the gate's e@-1 reads
    row n-1, a poisoned blinding row."""
    prover.fixed[0][0] = 1


def unassign_mul_output(prover):
    """SimpleCircuit: drop the first "mul" region's output cell from its
    region and its column."""
    row = min(prover.regions[2].rows) + 1
    for region in prover.regions:
        region.cells = {(c, r) for c, r in region.cells
                        if not (c.kind == ADVICE and c.index == 0 and r == row)}
    prover.advice[0][row] = UNASSIGNED


def failure_cases(frontend, value) -> dict:
    """name -> (circuit, instances, tamper or None, the failure kinds
    expected) for any k >= 5, built from ``frontend`` (this module or the
    JAX package's tests/circuits.py) and its ``Value``."""
    p = BN254_FR.p
    a, inst, table = plonk_api_common(BN254_FR)
    simple_inst = [[7 * pow(5, 4, p) % p]]
    std = frontend.StandardPlonkCircuit
    return {
        "satisfied": (std(value.known(a), table), [[inst]], None, set()),
        "lookup": (std(value.known((a + 1) % p), table), [[inst]], None, {"Lookup"}),
        "constraint": (std(value.known(a), table), [[inst]], bump_mult_output,
                       {"ConstraintNotSatisfied", "Permutation"}),
        "poisoned": (std(value.known(a), table), [[inst]], poison_first_row,
                     {"ConstraintPoisoned"}),
        "permutation": (frontend.SimpleCircuit(7, value.known(6)), simple_inst, None,
                        {"Permutation"}),
        "cell_not_assigned": (frontend.SimpleCircuit(7, value.known(5)), simple_inst,
                              unassign_mul_output,
                              {"CellNotAssigned", "ConstraintNotSatisfied", "Permutation"}),
    }


def tamper_bench_plonk(prover, iteration: int) -> list:
    """BenchPlonkCircuit with a = 2: add one to the a cell of the
    ``iteration``-th raw_multiply region (region 4i, row 2i under the
    single-pass floor planner) and return what verify() must report, as
    (kind, row, Display string): the product gate and the copy to raw_add."""
    region = prover.regions[4 * iteration]
    row = min(region.rows)
    assert region.name == "raw_multiply" and row == 2 * iteration
    prover.advice[0][row] += 1
    where = f"in Region {4 * iteration} ('raw_multiply') at offset 0"
    # the cells in the gate's query order, a*sa + b*sb + a*b*sm - c*sc, with
    # a = 3, b = 2, c = 4 and (sa, sb, sm, sc) = (0, 0, 1, 1)
    cells = (("Advice', 0", 3), ("Fixed', 0", 0), ("Advice', 1", 2), ("Fixed', 1", 0),
             ("Fixed', 3", 1), ("Advice', 2", 4), ("Fixed', 2", 1))
    return [
        ("ConstraintNotSatisfied", row,
         f"Constraint 0 in gate 0 ('Combined add-mult') is not satisfied {where}"
         + "".join(f"\n- Column('{c})@0 = {hex(v)}" for c, v in cells)),
        ("Permutation", row,
         f"Equality constraint not satisfied by cell (Column('Advice', 0), {where})"),
    ]


# -- SHA-256 (Table16) -----------------------------------------------------------
#
# Copies of tests/test_sha256.py's ``Sha256Circuit`` and ``SmallSpreadCircuit``.

SHA256_BENCH_BYTES = 1975  # 1975 + 1 + 8 = 31 * 64: the reference bench's 31 blocks


def sha256_bench_message(seed: int = 31) -> bytes:
    """The message of the reference's benches/sha256.rs length, from a seed."""
    return np.random.default_rng(seed).integers(0, 256, SHA256_BENCH_BYTES, dtype=np.uint8).tobytes()


def sha256_instance(msg: bytes) -> list:
    """The 16 half-words (lo, hi of each digest word) of ``hashlib.sha256``."""
    digest = hashlib.sha256(msg).digest()
    halves = []
    for i in range(8):
        w = int.from_bytes(digest[4 * i: 4 * i + 4], "big")
        halves += [w & 0xFFFF, w >> 16]
    return halves


class Sha256Circuit(Circuit):
    """Hash the padded blocks; digest half-words exposed as the instance."""

    def __init__(self, blocks):
        self.blocks = blocks  # list of 16-element lists of Value

    @classmethod
    def of(cls, msg: bytes):
        return cls([[Value.known(w) for w in blk] for blk in pad_message(msg)])

    def without_witnesses(self):
        return Sha256Circuit([[Value.unknown() for _ in b] for b in self.blocks])

    @classmethod
    def configure(cls, meta):
        config = Table16Chip.configure(meta)
        instance = meta.instance_column()
        meta.enable_equality(instance)
        return config, instance

    def synthesize(self, config, layouter):
        table_config, instance = config
        chip = Table16Chip(table_config)
        Table16Chip.load(table_config, layouter)
        hasher = Sha256(chip, layouter)
        for block in self.blocks:
            hasher.process_block(block)
        for i, word in enumerate(hasher.digest()):
            layouter.constrain_instance(word.lo.dense.cell, instance, 2 * i)
            layouter.constrain_instance(word.hi.dense.cell, instance, 2 * i + 1)


class SmallSpreadCircuit(Circuit):
    """The spread-table chip with a truncated table (8-bit dense values)."""

    TABLE_BITS = 8

    def __init__(self, word):
        self.word = word

    def without_witnesses(self):
        return SmallSpreadCircuit(Value.unknown())

    @classmethod
    def configure(cls, meta):
        tag = meta.advice_column()
        dense = meta.advice_column()
        spread = meta.advice_column()
        return SpreadTableChip.configure(meta, tag, dense, spread)

    def synthesize(self, config, layouter):
        chip = SpreadTableChip(config)

        def do(table):
            for d in range(1 << self.TABLE_BITS):
                table.assign_cell(config.table_tag, d, lambda v=d: get_tag(v))
                table.assign_cell(config.table_dense, d, lambda v=d: v)
                table.assign_cell(config.table_spread, d, lambda v=d: spread_u16(v))

        layouter.get_root().assign_table("spread table", do)
        layouter.namespace("word").assign_region("word", lambda region: chip.assign_word(
            region, 0, self.word))


# -- ECC ---------------------------------------------------------------------------
#
# Copies of tests/test_ecc_gadget.py's ``AddCircuit`` and ``MulCircuit`` and
# tests/test_ecc_mul_fixed.py's ``FixedMulCircuit``, ``BaseFieldMulCircuit``.

G = host.generator(PALLAS)
G2 = host.double(PALLAS, G)
G3 = host.add(PALLAS, G2, G)
FIXED_BASE = host.mul(PALLAS, G, 0xDEADBEEF)  # tests/test_ecc_mul_fixed.py's BASE
VAR_MUL_SCALAR = 0x0ACE1234DEADBEEF5A5A5A5AC0FFEE0123456789ABCDEF0102030405060708


class AddCircuit(Circuit):
    def __init__(self, p, q, expected, complete=True):
        self.p, self.q, self.expected, self.complete = p, q, expected, complete

    @classmethod
    def of(cls, p, q, expected, complete=True):
        """The identity is witnessed as the (0, 0) sentinel."""
        return cls(Value.known((0, 0) if p is None else p), Value.known((0, 0) if q is None else q),
                   expected, complete)

    def without_witnesses(self):
        return AddCircuit(Value.unknown(), Value.unknown(), self.expected, self.complete)

    @classmethod
    def configure(cls, meta):
        advices = [meta.advice_column() for _ in range(9)]
        return EccChip.configure(meta, advices)

    def synthesize(self, config, layouter):
        chip = EccChip(config)
        p = chip.witness_point(layouter, self.p)
        q = chip.witness_point(layouter, self.q)
        r = chip.add(layouter, p, q) if self.complete else chip.add_incomplete(layouter, p, q)
        if not r.x.value.is_none() and self.expected is not None:
            got = r.value().value()
            assert got == self.expected, (got, self.expected)


def add_cases() -> dict:
    """name -> AddCircuit of tests/test_ecc_gadget.py's add cases."""
    bad = (G[0], (G[1] + 1) % PASTA_FP.p)
    return {
        "incomplete": AddCircuit.of(G, G2, G3, complete=False),
        "distinct": AddCircuit.of(G, G2, G3),
        "doubling": AddCircuit.of(G, G, G2),
        "identity_left": AddCircuit.of(None, G, G),
        "identity_right": AddCircuit.of(G, None, G),
        "inverse": AddCircuit.of(G, host.neg(PALLAS, G), None),
        "off_curve": AddCircuit(Value.known(bad), Value.known(G2), None),
    }


class MulCircuit(Circuit):
    """Variable-base scalar mul; the result checked against host.mul."""

    def __init__(self, scalar, base, expected):
        self.scalar, self.base, self.expected = scalar, base, expected

    def without_witnesses(self):
        return MulCircuit(Value.unknown(), Value.unknown(), self.expected)

    @classmethod
    def configure(cls, meta):
        advices = [meta.advice_column() for _ in range(9)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return EccChip.configure(meta, advices)

    def synthesize(self, config, layouter):
        chip = EccChip(config)
        base = chip.witness_point(layouter, self.base)
        result, z = chip.mul(layouter, self.scalar, base)
        if not result.x.value.is_none() and self.expected is not None:
            got = result.value().value()
            assert got == self.expected, (got, self.expected)
            assert z.value.value() == self.scalar.value()


def flip_mul_bit(prover):
    """MulCircuit: a 2 in the bit column (advice 4) at the first row of
    "mul step 5", which the "bit boolean" constraint rejects."""
    step_region = next(r for r in prover.regions if r.name.startswith("mul step 5"))
    prover.advice[4][min(step_region.rows)] = 2


class FixedMulCircuit(Circuit):
    def __init__(self, scalar, expected, short=False):
        self.scalar, self.expected, self.short = scalar, expected, short

    def without_witnesses(self):
        return FixedMulCircuit(Value.unknown(), self.expected, self.short)

    @classmethod
    def configure(cls, meta):
        advices = [meta.advice_column() for _ in range(11)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        ecc = EccChip.configure(meta, advices[:9])
        return MulFixedChip.configure(meta, ecc, advices[9], advices[10])

    def synthesize(self, config, layouter):
        chip = MulFixedChip(config)
        if self.short:
            r = chip.mul_short(layouter, self.scalar, FIXED_BASE)
        else:
            r = chip.mul_full_width(layouter, self.scalar, FIXED_BASE)
        if not r.x.value.is_none() and self.expected is not None:
            got = r.value().value()
            assert got == self.expected, (got, self.expected)


def fixed_mul_full(scalar: int) -> FixedMulCircuit:
    return FixedMulCircuit(Value.known(scalar), host.mul(PALLAS, FIXED_BASE, scalar % FQ))


def fixed_mul_short(magnitude: int, sign: int) -> FixedMulCircuit:
    return FixedMulCircuit(Value.known((magnitude, sign)),
                           host.mul(PALLAS, FIXED_BASE, magnitude * sign % FQ), short=True)


class BaseFieldMulCircuit(Circuit):
    """mul_base_field with its canonicity checks."""

    def __init__(self, alpha, expected):
        self.alpha, self.expected = alpha, expected

    @classmethod
    def of(cls, alpha: int, expected=None):
        return cls(Value.known(alpha), host.mul(PALLAS, FIXED_BASE, alpha % FQ)
                   if expected is None else expected)

    def without_witnesses(self):
        return BaseFieldMulCircuit(Value.unknown(), self.expected)

    @classmethod
    def configure(cls, meta):
        advices = [meta.advice_column() for _ in range(15)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        table_idx = meta.lookup_table_column()
        lookup = LookupRangeCheckConfig.configure(meta, advices[14], table_idx, 10, PASTA_FP)
        ecc = EccChip.configure(meta, advices[:9])
        config = MulFixedChip.configure(meta, ecc, advices[9], advices[10])
        return MulFixedChip.configure_base_field(meta, config, advices[11:14], lookup)

    def synthesize(self, config, layouter):
        config.lookup_config.load(layouter)
        chip = MulFixedChip(config)
        alpha_cell = load_private(layouter, config.canon_advices[0], self.alpha)
        r = chip.mul_base_field(layouter, alpha_cell, FIXED_BASE)
        if not r.x.value.is_none() and self.expected is not None:
            got = r.value().value()
            assert got == self.expected, (got, self.expected)


# -- Sinsemilla ----------------------------------------------------------------------
#
# Copies of tests/test_sinsemilla.py's ``HashCircuit`` (here
# ``SinsemillaHashCircuit``), ``MerkleCircuit`` and ``CommitCircuit``.  Their
# messages are witnessed on ``witness_pieces`` and copied into the hash
# region; the JAX tests' circuits leave that column out of the permutation
# argument, which only a MockProver accepts.  The ``Proved*`` subclasses enable
# equality there, so keygen can lay the copies out.


@functools.lru_cache(maxsize=None)
def sinsemilla_domains():
    """(HashDomain("MerkleCRH"), the Merkle CRH's, CommitDomain("z.cash:test-commit"))."""
    return (sinsemilla_prim.HashDomain("MerkleCRH"),
            sinsemilla_prim.HashDomain(MERKLE_CRH_PERSONALIZATION),
            sinsemilla_prim.CommitDomain("z.cash:test-commit"))


def _sinsemilla_configure(meta, num_advice: int, range_col: int, pieces_col: int):
    advices = [meta.advice_column() for _ in range(num_advice)]
    constants = meta.fixed_column()
    meta.enable_constant(constants)
    fixed_y_q = meta.fixed_column()
    table_idx = meta.lookup_table_column()
    table_x = meta.lookup_table_column()
    table_y = meta.lookup_table_column()
    range_check = LookupRangeCheckConfig.configure(
        meta, advices[range_col], table_idx, SINSEMILLA_K, PASTA_FP)
    sin_config = SinsemillaChip.configure(meta, advices[:5], advices[pieces_col], fixed_y_q,
                                          (table_idx, table_x, table_y), range_check)
    return advices, sin_config


class SinsemillaHashCircuit(Circuit):
    """Witness a message and hash it; compare against the host primitives."""

    def __init__(self, bits, expected):
        self.bits = bits  # list[Value[bool]], length multiple of K
        self.expected = expected  # host affine point or None

    @classmethod
    def of(cls, nbits: int, seed: int):
        bits = i2lebsp(pow(seed, 5, 1 << nbits), nbits)
        return cls([Value.known(b) for b in bits], sinsemilla_domains()[0].hash_to_point(bits))

    def without_witnesses(self):
        return SinsemillaHashCircuit([Value.unknown()] * len(self.bits), self.expected)

    @classmethod
    def configure(cls, meta):
        return _sinsemilla_configure(meta, 7, 6, 5)[1]

    def synthesize(self, config, layouter):
        SinsemillaChip.load(config, layouter)
        chip = SinsemillaChip(config)
        domain = HashDomainGadget(chip, sinsemilla_domains()[0].Q)
        pieces = message_from_bitstring(chip, layouter, self.bits)
        (x, y), zs = domain.hash_to_point(layouter, pieces)
        if not x.value.is_none() and self.expected is not None:
            got = (x.value.value(), y.value.value())
            assert got == self.expected, (got, self.expected)
        assert len(zs) == len(pieces)


def host_merkle_root(leaf: int, pos: int, path: list) -> int:
    domain = sinsemilla_domains()[1]
    node = leaf
    for layer, sibling in enumerate(path):
        left, right = (sibling, node) if (pos >> layer) & 1 else (node, sibling)
        node = domain.hash(sinsemilla_prim.i2lebsp(layer, 10) + sinsemilla_prim.i2lebsp(left, 255)
                           + sinsemilla_prim.i2lebsp(right, 255))
    return node


class MerkleCircuit(Circuit):
    def __init__(self, leaf, leaf_pos, path, depth, expected_root):
        self.leaf, self.leaf_pos, self.path = leaf, leaf_pos, path
        self.depth, self.expected_root = depth, expected_root

    @classmethod
    def of(cls, depth: int):
        """tests/test_sinsemilla.py's inputs: depth 4 fixed, depth 32 from random.Random(42)."""
        if depth == 4:
            leaf = 0x2F0F40C2F152A01C9CAF66298493D5D0944A041C2E65BA0117C24F76BF8E6483 % PASTA_FP.p
            pos = 0b1011
            path = [(7 * i + 3) * 10**70 % PASTA_FP.p for i in range(depth)]
        else:
            rng = random.Random(42)
            leaf = rng.randrange(PASTA_FP.p)
            pos = rng.randrange(1 << depth)
            path = [rng.randrange(PASTA_FP.p) for _ in range(depth)]
        return cls(Value.known(leaf), Value.known(pos), Value.known(path), depth,
                   host_merkle_root(leaf, pos, path))

    def without_witnesses(self):
        return type(self)(Value.unknown(), Value.unknown(), Value.unknown(), self.depth, None)

    @classmethod
    def configure(cls, meta):
        return MerkleChip.configure(meta, _sinsemilla_configure(meta, 7, 6, 5)[1])

    def synthesize(self, config, layouter):
        SinsemillaChip.load(config.sinsemilla_config, layouter)
        chip = MerkleChip(config)
        leaf = load_private(layouter, config.advices[0], self.leaf)
        path_gadget = MerklePath([chip], sinsemilla_domains()[1].Q, self.leaf_pos, self.path,
                                 self.depth)
        root = path_gadget.calculate_root(layouter, leaf)
        if not root.value.is_none() and self.expected_root is not None:
            got = root.value.map(sinsemilla_ev).value()
            assert got == self.expected_root, (got, self.expected_root)


class ProvedMerkleCircuit(MerkleCircuit):
    @classmethod
    def configure(cls, meta):
        config = super().configure(meta)
        meta.enable_equality(config.sinsemilla_config.witness_pieces)
        return config


COMMIT_MESSAGE = 0b1011001110_0100110101  # tests/test_sinsemilla.py::test_commit_domain_circuit
COMMIT_R = 0x2C45DEADBEEF1234567890


class CommitCircuit(Circuit):
    def __init__(self, bits, r, expected):
        self.bits, self.r, self.expected = bits, r, expected

    @classmethod
    def of(cls, message: int = COMMIT_MESSAGE, r: int = COMMIT_R):
        bits = i2lebsp(message, 2 * SINSEMILLA_K)
        return cls([Value.known(b) for b in bits], Value.known(r),
                   sinsemilla_domains()[2].commit(bits, r))

    def without_witnesses(self):
        return type(self)([Value.unknown()] * len(self.bits), Value.unknown(), self.expected)

    @classmethod
    def configure(cls, meta):
        advices, sin_config = _sinsemilla_configure(meta, 12, 8, 9)
        ecc_config = EccChip.configure(meta, advices[:9])
        mf_config = MulFixedChip.configure(meta, ecc_config, advices[10], advices[11])
        return sin_config, mf_config

    def synthesize(self, config, layouter):
        sin_config, mf_config = config
        SinsemillaChip.load(sin_config, layouter)
        sin_chip = SinsemillaChip(sin_config)
        domain = sinsemilla_domains()[2]
        gadget = CommitDomainGadget(sin_chip, MulFixedChip(mf_config), domain.M.Q, domain.R)
        pieces = message_from_bitstring(sin_chip, layouter, self.bits)
        point, zs = gadget.commit(layouter, pieces, self.r)
        if not point.x.value.is_none() and self.expected is not None:
            got = point.value().value()
            assert got == self.expected, (got, self.expected)


class ProvedCommitCircuit(CommitCircuit):
    """tests/make_sinsemilla_pin.py's circuit."""

    @classmethod
    def configure(cls, meta):
        config = super().configure(meta)
        meta.enable_equality(config[0].witness_pieces)
        return config


# -- Soundness regressions ---------------------------------------------------------
#
# Copies of tests/test_soundness_regressions.py's circuits.

SHORT_CHECK_K = 4  # a 4-bit lookup table
SHORT_CHECK_BITS = 3  # the claimed bound: value < 8


class ShortCheckCircuit(Circuit):
    """witness_short_check(value, 3) over a 4-bit table (the honest gadget)."""

    def __init__(self, value):
        self.value = value

    def without_witnesses(self):
        return type(self)(Value.unknown())

    @classmethod
    def configure(cls, meta):
        running_sum = meta.advice_column()
        table_idx = meta.lookup_table_column()
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        return LookupRangeCheckConfig.configure(meta, running_sum, table_idx, SHORT_CHECK_K,
                                                PALLAS.scalar)

    def synthesize(self, config, layouter):
        config.load(layouter)
        config.witness_short_check(layouter, self.value, SHORT_CHECK_BITS)


class ForgedShortCheckCircuit(ShortCheckCircuit):
    """A malicious witness: value 9 >= 2^3 with a forged multiplier, so the
    bitshift gate and both lookups pass; the honest gadget's region shape."""

    def synthesize(self, config, layouter):
        config.load(layouter)
        p = PALLAS.scalar.p
        evil, shifted = 9, 15
        forged_inv = shifted * pow(evil * (1 << SHORT_CHECK_K), -1, p) % p

        def do(region):
            el = region.assign_advice(config.running_sum, 0, lambda: Value.known(evil))
            config.q_lookup.enable(region, 0)
            region.assign_advice(config.running_sum, 1, lambda: Value.known(shifted))
            config.q_lookup.enable(region, 1)
            config.q_bitshift.enable(region, 1)
            region.assign_advice(config.running_sum, 2, lambda: Value.known(forged_inv))
            return el

        layouter.namespace("short range check").assign_region(
            f"Witness short check {SHORT_CHECK_BITS} bits", do)


class ShortMulCircuit(Circuit):
    """The short fixed-base mul of the Pallas generator."""

    floor_planner = SimpleFloorPlanner

    def __init__(self, mag_sign):
        self.mag_sign = mag_sign

    def without_witnesses(self):
        return ShortMulCircuit(Value.unknown())

    @classmethod
    def configure(cls, meta):
        advices = [meta.advice_column() for _ in range(11)]
        constants = meta.fixed_column()
        meta.enable_constant(constants)
        ecc = EccChip.configure(meta, advices[:9])
        return MulFixedChip.configure(meta, ecc, advices[9], advices[10])

    def synthesize(self, config, layouter):
        MulFixedChip(config).mul_short(layouter, self.mag_sign, (PALLAS.gx, PALLAS.gy))
