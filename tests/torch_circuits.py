"""Test circuits for the halo2_tpu_torch port.

Copies of ``__graft_entry__._EntryCircuit`` (the circuit of the pinned proof
``tests/data/dryrun_proof_k6.hex``) and ``tests/circuits.BenchPlonkCircuit``
(the reference's benches/plonk.rs workload) written against the port's
frontend, so that nothing here imports jax.
"""

from halo2_tpu_torch.circuit import Circuit, Value
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
