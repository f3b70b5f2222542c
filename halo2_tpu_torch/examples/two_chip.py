"""two-chip.rs analog: d = (a + b) * c with a public output, through a
FieldChip composed of an AddChip and a MulChip that share advice columns but
own their selectors (``examples/two_chip.py`` ported).  MockProver checks the
circuit, then a KZG/GWC proof is made and verified on the card.

    python -m halo2_tpu_torch.examples.two_chip
"""

from __future__ import annotations

from ..circuit import Value
from ..circuit.layouter import SimpleFloorPlanner
from ..poly import Rotation


class AddChip:
    """c = a + b (two-chip.rs AddInstructions/AddChip)."""

    def __init__(self, config):
        self.config = config

    @staticmethod
    def configure(meta, advice):
        s_add = meta.selector()

        def add_gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_add)
            return [s * (lhs + rhs - out)]

        meta.create_gate("add", add_gate)
        return {"advice": advice, "s_add": s_add}

    def add(self, layouter, a, b):
        config = self.config

        def do(region):
            config["s_add"].enable(region, 0)
            a.copy_advice(region, config["advice"][0], 0)
            b.copy_advice(region, config["advice"][1], 0)
            value = a.value.zip(b.value).map(lambda t: t[0] + t[1])
            return region.assign_advice(config["advice"][0], 1, lambda: value)

        return layouter.namespace("add").assign_region("add", do)


class MulChip:
    """c = a * b (two-chip.rs MulInstructions/MulChip)."""

    def __init__(self, config):
        self.config = config

    @staticmethod
    def configure(meta, advice):
        s_mul = meta.selector()

        def mul_gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_mul)
            return [s * (lhs * rhs - out)]

        meta.create_gate("mul", mul_gate)
        return {"advice": advice, "s_mul": s_mul}

    def mul(self, layouter, a, b):
        config = self.config

        def do(region):
            config["s_mul"].enable(region, 0)
            a.copy_advice(region, config["advice"][0], 0)
            b.copy_advice(region, config["advice"][1], 0)
            value = a.value.zip(b.value).map(lambda t: t[0] * t[1])
            return region.assign_advice(config["advice"][0], 1, lambda: value)

        return layouter.namespace("mul").assign_region("mul", do)


class FieldChip:
    """Composes AddChip + MulChip (two-chip.rs FieldChip/FieldInstructions)."""

    def __init__(self, config):
        self.config = config
        self.add_chip = AddChip(config["add"])
        self.mul_chip = MulChip(config["mul"])

    @staticmethod
    def configure(meta, advice, instance):
        meta.enable_equality(instance)
        for column in advice:
            meta.enable_equality(column)
        add_config = AddChip.configure(meta, advice)
        mul_config = MulChip.configure(meta, advice)
        return {"advice": advice, "instance": instance, "add": add_config, "mul": mul_config}

    def load_private(self, layouter, value):
        col = self.config["advice"][0]
        return layouter.namespace("load private").assign_region(
            "load private", lambda region: region.assign_advice(col, 0, lambda: value)
        )

    def add_and_mul(self, layouter, a, b, c):
        ab = self.add_chip.add(layouter.namespace("a + b"), a, b)
        return self.mul_chip.mul(layouter.namespace("(a+b) * c"), ab, c)

    def expose_public(self, layouter, num, row):
        layouter.namespace("expose").constrain_instance(
            num.cell, self.config["instance"], row
        )


class FieldCircuit:
    floor_planner = SimpleFloorPlanner

    def __init__(self, a, b, c):
        self.a, self.b, self.c = a, b, c

    def without_witnesses(self):
        return FieldCircuit(Value.unknown(), Value.unknown(), Value.unknown())

    @classmethod
    def configure(cls, meta):
        advice = [meta.advice_column(), meta.advice_column()]
        instance = meta.instance_column()
        return FieldChip.configure(meta, advice, instance)

    def synthesize(self, config, layouter):
        chip = FieldChip(config)
        a = chip.load_private(layouter, self.a)
        b = chip.load_private(layouter, self.b)
        c = chip.load_private(layouter, self.c)
        d = chip.add_and_mul(layouter, a, b, c)
        chip.expose_public(layouter, d, 0)


def main() -> bool:
    from ..curves.spec import BN254_G1
    from ..dev.mock_prover import MockProver
    from ..plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from ..poly.kzg import ParamsKZG
    from ..poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from ..transcript import Blake2bTranscript
    from ..utils.rng import FieldRng

    spec = BN254_G1.scalar
    a, b, c = 7, 11, 13
    d = (a + b) * c % spec.p
    circuit = FieldCircuit(Value.known(a), Value.known(b), Value.known(c))

    failures = MockProver.run(spec, 4, circuit, [[d]]).verify()
    if failures:
        raise AssertionError("MockProver: " + "\n".join(map(str, failures)))
    print("MockProver: satisfied")

    params = ParamsKZG.setup_host(4, seed=b"two-chip", device="cuda")
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    proof = create_proof(
        params, pk, [circuit], [[[d]]], FieldRng(spec, b"two-chip-rng"),
        Blake2bTranscript(BN254_G1), gwc_create_proof,
    )
    ok = verify_proof(params, vk, [[[d]]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)
    if ok is not True:
        raise AssertionError("the proof was rejected")
    print(f"proof: {len(proof)} bytes, verified")
    return ok


if __name__ == "__main__":
    main()
