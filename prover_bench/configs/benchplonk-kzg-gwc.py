"""``MyCircuit`` of halo2's ``halo2_proofs/benches/plonk.rs``, written against
``halo2_tpu_torch``'s frontend: the circuit that the cells of the
configuration ``benchplonk-kzg-gwc`` prove.

(2^(k-1) - 3) iterations of {raw_multiply, raw_add, two copies} over advice
a, b, c and fixed sa, sb, sc, sm; no lookup and no instance column.  The
witness value ``a`` of each proof is the message read as a little-endian
integer, reduced mod r.
"""

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.fields.spec import BN254_FR
from halo2_tpu_torch.poly import Rotation


class BenchPlonk(Circuit):
    def __init__(self, k: int, a, tamper: bool = False):
        self.k = k
        self.a = a  # Value of a canonical int
        self.tamper = tamper  # the control: the last raw_add's output is off by one

    def without_witnesses(self):
        return BenchPlonk(self.k, Value.unknown())

    @classmethod
    def configure(cls, meta):
        a, b, c = meta.advice_column(), meta.advice_column(), meta.advice_column()
        for col in (a, b, c):
            meta.enable_equality(col)
        sa, sb, sc, sm = (meta.fixed_column() for _ in range(4))

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
        iterations = (1 << (self.k - 1)) - 3
        for i in range(iterations):
            if self.tamper and i == iterations - 1:
                add_vals = add_vals.map(lambda t: (t[0], t[1], (t[2] + 1) % BN254_FR.p))
            a0, _, c0 = raw("raw_multiply", 0, 0, 1, mul_vals)
            a1, b1, _ = raw("raw_add", 1, 1, 0, add_vals)
            copy(a0, a1)
            copy(b1, c0)


def blank(config: dict) -> Circuit:
    """The circuit without its witness, for keygen."""
    return BenchPlonk(config["k"], Value.unknown())


def prove_inputs(config: dict, message: bytes, tamper: bool = False):
    """(circuit, instance columns) of one proof of ``message``."""
    a = int.from_bytes(message, "little") % BN254_FR.p
    return BenchPlonk(config["k"], Value.known(a), tamper), []
