"""Write ``tests/data/poseidon_gwc_k7.hex``: the JAX package's K=7 Poseidon proof.

    python tests/make_poseidon_pin.py

The proof of ``tests/test_poseidon.py::HashCircuit`` (P128Pow5T3 over BN254
Fr, width 3, rate 2, the message [6, 42]) through KZG with GWC and a Blake2b
transcript, with the seeds of ``tests/test_e2e_poseidon.py``:
``ParamsKZG.setup(7, seed=b"poseidon-e2e")`` and
``FieldRng(spec, b"poseidon-rng")``.  Only ``halo2_tpu`` makes it; the port's
tests read the file and never write it.  The script refuses to overwrite an
existing pin, and checks that the proof verifies before it writes.  Not
collected by pytest (its name does not start with ``test_``).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
PIN = os.path.join(HERE, "data", "poseidon_gwc_k7.hex")
K = 7


def main() -> None:
    if os.path.exists(PIN):
        raise SystemExit(f"{PIN} exists: a pin is never overwritten")
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    from test_poseidon import HashCircuit

    from halo2_tpu.circuit import Value
    from halo2_tpu.curves import BN254_G1
    from halo2_tpu.gadgets.poseidon import ConstantLength, hash_message
    from halo2_tpu.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu.poly.kzg import ParamsKZG
    from halo2_tpu.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from halo2_tpu.transcript import Blake2bTranscript
    from halo2_tpu.utils.rng import FieldRng

    spec = BN254_G1.scalar
    message = [6, 42]
    expected = hash_message(HashCircuit.spec, ConstantLength(2), message)
    params = ParamsKZG.setup(K, seed=b"poseidon-e2e")
    circuit = HashCircuit(Value.known(message), Value.known(expected))
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    proof = create_proof(params, pk, [circuit], [[[expected]]], FieldRng(spec, b"poseidon-rng"),
                         Blake2bTranscript(BN254_G1), gwc_create_proof)
    if not verify_proof(params, vk, [[[expected]]], Blake2bTranscript(BN254_G1, proof),
                        gwc_verify_proof):
        raise SystemExit("the JAX package's Poseidon proof does not verify")
    with open(PIN, "x") as f:
        f.write(proof.hex() + "\n")
    print(f"wrote {PIN}: {len(proof)} bytes")


if __name__ == "__main__":
    main()
