"""shuffle.rs analog: multi-phase advice columns and run-time challenges
(``examples/shuffle.py`` ported).

W first-phase advice column pairs (original / shuffled), two challenges
``theta``/``gamma`` usable after the first phase, and a second-phase running
product column ``z`` whose witness reads the squeezed challenges through
``layouter.get_challenge``.  The constraint system proves that ``shuffled`` is
a row permutation of ``original`` with the grand-product argument

    z_{i+1} * (compress(shuffled_i) + gamma) = z_i * (compress(original_i) + gamma)

where compress folds the W columns with powers of theta; z_0 = z_H = 1.
Run as a module to check the circuit with MockProver, then prove and verify
one instance on the card (KZG-GWC, Blake2b):

    python -m halo2_tpu_torch.examples.shuffle
"""

from __future__ import annotations

import random

from ..circuit import Circuit, Value
from ..plonk.circuit import Constant
from ..poly import Rotation

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


def main() -> bool:
    from ..curves.spec import BN254_G1
    from ..dev.mock_prover import MockProver
    from ..plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from ..poly.kzg import ParamsKZG
    from ..poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from ..transcript import Blake2bTranscript
    from ..utils.rng import FieldRng

    spec = BN254_G1.scalar
    k = 8
    circuit = ShuffleCircuit.rand(spec.p, random.Random(0xD15C0))

    failures = MockProver.run(spec, k, circuit, []).verify()
    if failures:
        raise AssertionError("MockProver: " + "\n".join(map(str, failures)))
    print("MockProver: satisfied")

    params = ParamsKZG.setup_host(k, seed=b"shuffle-example", device="cuda")
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    proof = create_proof(params, pk, [circuit], [[]], FieldRng(spec, b"shuffle-rng"),
                         Blake2bTranscript(BN254_G1), gwc_create_proof)
    print(f"proof: {len(proof)} bytes")
    ok = verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)
    if ok is not True:
        raise AssertionError("the proof was rejected")
    print("verify: OK")
    return ok


if __name__ == "__main__":
    main()
