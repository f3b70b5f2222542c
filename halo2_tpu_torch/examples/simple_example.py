"""simple-example.rs analog: prove and verify ``out = constant * a^4`` over
KZG with GWC, on the card (``examples/simple_example.py`` ported).

    python -m halo2_tpu_torch.examples.simple_example
"""

from __future__ import annotations

import os
import sys

from ..circuit import Value
from ..curves.spec import BN254_G1
from ..plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from ..poly.kzg import ParamsKZG
from ..poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
from ..transcript import Blake2bTranscript
from ..utils.rng import FieldRng

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "tests")


def main(k: int = 4) -> bool:
    sys.path.insert(0, TESTS)
    from torch_circuits import SimpleCircuit

    spec = BN254_G1.scalar
    constant, a = 7, 5
    c = constant * pow(a, 4, spec.p) % spec.p

    params = ParamsKZG.setup(k, device="cuda")
    circuit = SimpleCircuit(constant, Value.known(a))
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())

    proof = create_proof(params, pk, [circuit], [[[c]]], FieldRng(spec),
                         Blake2bTranscript(BN254_G1), gwc_create_proof)
    print(f"proof: {len(proof)} bytes")
    ok = verify_proof(params, vk, [[[c]]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)
    print("verified:", ok)
    if ok is not True:
        raise AssertionError("the proof was rejected")
    return ok


if __name__ == "__main__":
    main()
