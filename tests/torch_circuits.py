"""Test circuits for the halo2_tpu_torch port.

Copies, written against the port's frontend so that nothing here imports
jax, of ``__graft_entry__._EntryCircuit`` (the circuit of the pinned proof
``tests/data/dryrun_proof_k6.hex``), ``tests/circuits.BenchPlonkCircuit``
(the reference's benches/plonk.rs workload), ``tests/circuits.
StandardPlonkCircuit`` (tests/plonk_api.rs, the circuit of the pinned
``tests/data/plonk_api_*_k5.hex`` proofs) and ``examples/shuffle.py``'s
``ShuffleCircuit`` (a second-phase advice column); and ``LookupRangeCircuit``,
the shape of the reference's benches/dev_lookup.rs circuit.
"""

import random

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.plonk.circuit import Constant
from halo2_tpu_torch.poly import Rotation


class EntryCircuit(Circuit):
    """Mul-gate circuit (simple-example.rs shape): out = a^4 at row 0 of the
    instance column, via two mul regions."""

    def __init__(self, constant, a):
        self.constant = constant
        self.a = a

    def without_witnesses(self):
        return EntryCircuit(self.constant, Value.unknown())

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
            return [s * (lhs * rhs - out)]

        meta.create_gate("mul", gate)
        return {"advice": advice, "instance": instance, "s_mul": s_mul}

    def synthesize(self, config, layouter):
        advice = config["advice"]

        def load(value):
            return layouter.assign_region(
                "load", lambda region: region.assign_advice(advice[0], 0, lambda: value)
            )

        def mul(a_cell, b_cell):
            def do(region):
                config["s_mul"].enable(region, 0)
                a_cell.copy_advice(region, advice[0], 0)
                b_cell.copy_advice(region, advice[1], 0)
                return region.assign_advice(advice[0], 1, lambda: a_cell.value * b_cell.value)

            return layouter.assign_region("mul", do)

        a = load(self.a)
        ab = mul(a, a)
        out = mul(ab, ab)
        layouter.constrain_instance(out.cell, config["instance"], 0)


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


FIRST_PHASE = 0
SECOND_PHASE = 1


def shuffled_copy(original, rng: random.Random):
    """Row-shuffle of a column-major W x H array (shuffle.rs:30-44)."""
    out = [list(col) for col in original]
    h = len(original[0])
    for row in range(h - 1, 0, -1):
        rand_row = rng.randrange(row)
        for col in out:
            col[row], col[rand_row] = col[rand_row], col[row]
    return out


class ShuffleCircuit(Circuit):
    """examples/shuffle.py: W first-phase advice column pairs (original /
    shuffled), two challenges usable after the first phase, and a
    second-phase running product z; W and H are class attributes."""

    W = 4
    H = 32

    def __init__(self, p: int, original: Value, shuffled: Value):
        self.p = p  # field modulus, for host-side witness arithmetic
        self.original = original  # Value of [W][H] canonical ints
        self.shuffled = shuffled

    @classmethod
    def rand(cls, p: int, rng: random.Random) -> "ShuffleCircuit":
        original = [[rng.randrange(p) for _ in range(cls.H)] for _ in range(cls.W)]
        return cls(p, Value.known(original), Value.known(shuffled_copy(original, rng)))

    def without_witnesses(self):
        return type(self)(self.p, Value.unknown(), Value.unknown())

    @classmethod
    def configure(cls, meta):
        q_shuffle = meta.selector()
        q_first = meta.selector()
        q_last = meta.selector()
        original = [meta.advice_column_in(FIRST_PHASE) for _ in range(cls.W)]
        shuffled = [meta.advice_column_in(FIRST_PHASE) for _ in range(cls.W)]
        theta = meta.challenge_usable_after(FIRST_PHASE)
        gamma = meta.challenge_usable_after(FIRST_PHASE)
        z = meta.advice_column_in(SECOND_PHASE)

        def z_first(cells):
            q = cells.query_selector(q_first)
            return [q * (Constant(1) - cells.query_advice(z, Rotation.cur()))]

        meta.create_gate("z should start with 1", z_first)

        def z_last(cells):
            q = cells.query_selector(q_last)
            return [q * (Constant(1) - cells.query_advice(z, Rotation.cur()))]

        meta.create_gate("z should end with 1", z_last)

        def z_transition(cells):
            q = cells.query_selector(q_shuffle)
            orig = [cells.query_advice(c, Rotation.cur()) for c in original]
            shuf = [cells.query_advice(c, Rotation.cur()) for c in shuffled]
            th = cells.query_challenge(theta)
            ga = cells.query_challenge(gamma)
            z_cur = cells.query_advice(z, Rotation.cur())
            z_next = cells.query_advice(z, Rotation.next())
            comp_o = orig[0]
            for e in orig[1:]:
                comp_o = comp_o * th + e
            comp_s = shuf[0]
            for e in shuf[1:]:
                comp_s = comp_s * th + e
            return [q * (z_cur * (comp_o + ga) - z_next * (comp_s + ga))]

        meta.create_gate("z should have valid transition", z_transition)

        return {
            "q_shuffle": q_shuffle, "q_first": q_first, "q_last": q_last,
            "original": original, "shuffled": shuffled,
            "theta": theta, "gamma": gamma, "z": z,
        }

    check_telescopes = True  # the witness generator's sanity assert

    def synthesize(self, config, layouter):
        p = self.p
        H = self.H
        theta_v = layouter.get_challenge(config["theta"])
        gamma_v = layouter.get_challenge(config["gamma"])

        def do(region):
            config["q_first"].enable(region, 0)
            config["q_last"].enable(region, H)
            for offset in range(H):
                config["q_shuffle"].enable(region, offset)
            for key, vals_v in (("original", self.original), ("shuffled", self.shuffled)):
                for idx, column in enumerate(config[key]):
                    col = vals_v.map(lambda a, idx=idx: a[idx])
                    for offset in range(H):
                        region.assign_advice(
                            column, offset, lambda v=col, o=offset: v.map(lambda c: c[o])
                        )

            # second phase: the running product z from the squeezed challenges
            # (unknown during the first-phase pass, so skipped there)
            def compute_z(t):
                ((original, shuffled), (theta, gamma)) = t
                zv = [1]
                for i in range(H):
                    comp_o = 0
                    for col in original:
                        comp_o = (comp_o * theta + col[i]) % p
                    comp_s = 0
                    for col in shuffled:
                        comp_s = (comp_s * theta + col[i]) % p
                    zv.append(zv[-1] * (comp_o + gamma) % p * pow((comp_s + gamma) % p, -1, p) % p)
                if self.check_telescopes:
                    assert zv[-1] == 1, "shuffle grand product must telescope"
                return zv

            z_vals = self.original.zip(self.shuffled).zip(theta_v.zip(gamma_v)).map(compute_z)
            for offset in range(H + 1):
                region.assign_advice(
                    config["z"], offset, lambda o=offset: z_vals.map(lambda zs: zs[o])
                )

        layouter.assign_region("Shuffle original into shuffled", do)


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
