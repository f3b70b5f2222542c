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
"""

from halo2_tpu_torch.circuit import Circuit, V1FloorPlanner, Value
from halo2_tpu_torch.dev.mock_prover import UNASSIGNED
from halo2_tpu_torch.entry import EntryCircuit  # noqa: F401  (the pinned k=6 proof's circuit)
from halo2_tpu_torch.examples.shuffle import ShuffleCircuit, shuffled_copy  # noqa: F401
from halo2_tpu_torch.fields.spec import BN254_FR, PASTA_FP
from halo2_tpu_torch.gadgets.poseidon import ConstantLength, PoseidonHashGadget, Pow5Chip, p128_pow5_t3
from halo2_tpu_torch.gadgets.utilities import (
    CondSwapChip,
    LookupRangeCheckConfig,
    RunningSumConfig,
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
