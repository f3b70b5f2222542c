"""serialization.rs analog: write the proving key to bytes, read it back and
prove with it (``examples/serialization.py`` ported, on the card).

    python -m halo2_tpu_torch.examples.serialization
"""

from __future__ import annotations

import sys

from ..circuit import Value
from ..curves.spec import BN254_G1
from ..plonk import create_proof, keygen_pk, keygen_vk
from ..plonk.serde import SerdeFormat, pk_from_bytes, pk_to_bytes
from ..poly.kzg import ParamsKZG
from ..poly.multiopen_gwc import gwc_create_proof
from ..transcript import Blake2bTranscript
from ..utils.rng import FieldRng
from .simple_example import TESTS


def main(k: int = 4) -> None:
    sys.path.insert(0, TESTS)
    from torch_circuits import SimpleCircuit

    fmt = SerdeFormat.PROCESSED
    spec = BN254_G1.scalar
    params = ParamsKZG.setup(k, device="cuda")
    circuit = SimpleCircuit(7, Value.unknown())
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)

    data = pk_to_bytes(pk, BN254_G1, fmt)
    print(f"pk: {len(data)} bytes ({fmt.name})")
    pk2 = pk_from_bytes(data, BN254_G1, SimpleCircuit, fmt=fmt, device="cuda")
    assert pk2.vk.fixed_commitments == pk.vk.fixed_commitments
    assert pk2.vk.permutation_commitments == pk.vk.permutation_commitments
    assert pk2.vk.transcript_repr == pk.vk.transcript_repr
    a = 5
    inst = [[[7 * pow(a, 4, spec.p) % spec.p]]]
    proofs = [create_proof(params, key, [SimpleCircuit(7, Value.known(a))], inst,
                           FieldRng(spec, b"serialization"), Blake2bTranscript(BN254_G1),
                           gwc_create_proof) for key in (pk, pk2)]
    assert proofs[0] == proofs[1]
    print("pk roundtrip OK: the read key proves the same bytes")


if __name__ == "__main__":
    main()
