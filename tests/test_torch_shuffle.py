"""Multi-phase proving in halo2_tpu_torch: the shuffle argument.

The port's copy of ``examples/shuffle.py``'s circuit (W=2, H=8) has a
second-phase advice column z witnessed from two challenges squeezed after
the first phase, so it drives the prover's phase loop and the verifier's
matching challenge reads.  Setup as tests/test_shuffle.py: k=6,
``setup_host(6, seed=b"shuffle-test")``, ``FieldRng(b"shuffle-test-rng")``
and the witness from ``random.Random(3)``, through GWC.  The proof verifies;
a tampered proof and the proof of a forged (non-permutation) witness are
rejected; and, in the slow tier, the bytes equal the JAX package's
``create_proof`` on the same inputs.
"""

import random

import pytest
import torch

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
from halo2_tpu_torch.transcript import Blake2bTranscript
from halo2_tpu_torch.utils.rng import FieldRng

from torch_circuits import ShuffleCircuit, shuffled_copy

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

SPEC = BN254_G1.scalar
K = 6


class SmallShuffle(ShuffleCircuit):
    W = 2
    H = 8


class NoAssertShuffle(SmallShuffle):
    """The witness generator skips its telescoping assert, so a
    non-permutation reaches the constraint system."""

    check_telescopes = False


@pytest.fixture(scope="module")
def shuffle():
    params = ParamsKZG.setup_host(K, seed=b"shuffle-test")
    circuit = SmallShuffle.rand(SPEC.p, random.Random(3))
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    return params, vk, pk, circuit, _prove(params, pk, circuit)


def _prove(params, pk, circuit):
    return create_proof(params, pk, [circuit], [[]], FieldRng(SPEC, b"shuffle-test-rng"),
                        Blake2bTranscript(BN254_G1), gwc_create_proof)


def _verify(params, vk, proof):
    return verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)


def test_shuffle_proof_verifies(shuffle):
    params, vk, _, _, proof = shuffle
    assert _verify(params, vk, proof) is True


def test_shuffle_tampered_proof_rejected(shuffle):
    params, vk, _, _, proof = shuffle
    bad = bytearray(proof)
    bad[7] ^= 1
    try:
        assert _verify(params, vk, bytes(bad)) is False
    except ValueError:  # the tampered point does not decode: rejected too
        pass


def test_shuffle_forged_witness_proof_rejected(shuffle):
    params, vk, pk, _, _ = shuffle
    rng = random.Random(2)
    original = [[rng.randrange(SPEC.p) for _ in range(SmallShuffle.H)]
                for _ in range(SmallShuffle.W)]
    forged = shuffled_copy(original, rng)
    forged[0][0] = (forged[0][0] + 1) % SPEC.p  # not a permutation any more
    proof = _prove(params, pk, NoAssertShuffle(SPEC.p, Value.known(original), Value.known(forged)))
    assert _verify(params, vk, proof) is False


@pytest.mark.slow
def test_shuffle_proof_matches_jax(shuffle):
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples"))
    from shuffle import ShuffleCircuit as JaxShuffleCircuit

    from halo2_tpu.curves.spec import BN254_G1 as JAX_BN254_G1
    from halo2_tpu.plonk import create_proof as jax_create_proof
    from halo2_tpu.plonk import keygen_pk as jax_keygen_pk
    from halo2_tpu.plonk import keygen_vk as jax_keygen_vk
    from halo2_tpu.poly.kzg import ParamsKZG as JaxParamsKZG
    from halo2_tpu.poly.multiopen_gwc import gwc_create_proof as jax_gwc_create_proof
    from halo2_tpu.transcript import Blake2bTranscript as JaxBlake2bTranscript
    from halo2_tpu.utils.rng import FieldRng as JaxFieldRng

    class JaxSmallShuffle(JaxShuffleCircuit):
        W = 2
        H = 8

    jspec = JAX_BN254_G1.scalar
    circuit = JaxSmallShuffle.rand(jspec.p, random.Random(3))
    params = JaxParamsKZG.setup_host(K, seed=b"shuffle-test")
    vk = jax_keygen_vk(params, circuit.without_witnesses())
    pk = jax_keygen_pk(params, vk, circuit.without_witnesses())
    want = jax_create_proof(params, pk, [circuit], [[]], JaxFieldRng(jspec, b"shuffle-test-rng"),
                            JaxBlake2bTranscript(JAX_BN254_G1), jax_gwc_create_proof)
    assert shuffle[4] == want
