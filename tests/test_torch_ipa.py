"""IPA proofs in halo2_tpu_torch against the JAX package's pin.

The port's IPA proof of the tests/plonk_api.rs circuit (two circuit
instances, instance columns committed and opened: ``query_instance=True``)
over ``ParamsIPA.setup(5, seed=b"plonk-api-ipa")`` must equal the JAX
package's pinned bytes ``tests/data/plonk_api_ipa_k5.hex``, byte for byte; a
missing pin fails (it is never written here).  Verify must accept it through
``IPASingleStrategy`` and reject a wrong instance through
``IPAAccumulatorStrategy``, and ``BatchVerifier`` must accept two good
proofs and reject a good one beside one whose last byte is flipped.  The
SRS and its pieces are held to the JAX package in test_torch_ipa_srs.py.
"""

import os

import pytest
import torch

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves.spec import PALLAS
from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from halo2_tpu_torch.plonk.batch import BatchVerifier
from halo2_tpu_torch.poly.ipa import IPAAccumulatorStrategy, IPASingleStrategy, ParamsIPA
from halo2_tpu_torch.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
from halo2_tpu_torch.transcript import Blake2bTranscript
from halo2_tpu_torch.utils.rng import FieldRng

from torch_circuits import StandardPlonkCircuit, plonk_api_common

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = PALLAS.scalar
A, INSTANCE, TABLE = plonk_api_common(SPEC)
INSTANCES = [[[INSTANCE]], [[INSTANCE]]]


@pytest.fixture(scope="module")
def ipa():
    params = ParamsIPA.setup(5, seed=b"plonk-api-ipa")
    empty = StandardPlonkCircuit(Value.unknown(), TABLE)
    vk = keygen_vk(params, empty)
    pk = keygen_pk(params, vk, empty)
    circuit = StandardPlonkCircuit(Value.known(A), TABLE)
    proof = create_proof(
        params, pk, [circuit, circuit], INSTANCES, FieldRng(SPEC, b"ipa-rng"),
        Blake2bTranscript(PALLAS), ipa_create_proof, query_instance=True,
    )
    return params, vk, proof


def _verify(ipa, proof, strategy):
    params, vk, _ = ipa
    return verify_proof(params, vk, INSTANCES, Blake2bTranscript(PALLAS, proof),
                        ipa_verify_proof, query_instance=True, strategy=strategy)


def test_plonk_api_ipa_proof_matches_jax_pin(ipa):
    with open(os.path.join(HERE, "data", "plonk_api_ipa_k5.hex")) as f:  # missing: fails
        assert ipa[2] == bytes.fromhex(f.read().strip())


def test_plonk_api_ipa_proof_verifies(ipa):
    assert _verify(ipa, ipa[2], IPASingleStrategy(ipa[0])) is True


def test_accumulator_strategy_rejects_a_wrong_instance(ipa):
    """IPAAccumulatorStrategy's one MSM decides for every proof it took."""
    params, vk, proof = ipa
    strategy = IPAAccumulatorStrategy(params, FieldRng(SPEC, b"accumulate"))
    wrong = [[[INSTANCE]], [[(INSTANCE + 1) % SPEC.p]]]
    assert verify_proof(params, vk, wrong, Blake2bTranscript(PALLAS, proof), ipa_verify_proof,
                        query_instance=True, strategy=strategy) is strategy
    assert strategy.finalize() is False


@pytest.mark.parametrize("tamper", [False, True])
def test_batch_verifier(ipa, tamper):
    params, vk, proof = ipa
    second = bytearray(proof)
    if tamper:
        second[-1] ^= 1  # the final IPA fold scalar
    batch = BatchVerifier()
    batch.add_proof(INSTANCES, proof)
    batch.add_proof(INSTANCES, bytes(second))
    assert batch.finalize(params, vk) is (not tamper)
