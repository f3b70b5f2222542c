"""Poseidon in halo2_tpu_torch against the JAX package and its pin.

The primitives (Grain constants, MDS, ``permute``, the sponge) equal the
reference's pinned Pallas tables and the JAX package's on seeded inputs; the
Pow5 chip's ``HashCircuit`` gives the JAX package's MockProver outcome on both
paths; and the port's K=7 proof over BN254 with KZG/GWC and a Blake2b
transcript (the seeds of tests/test_e2e_poseidon.py) equals
``tests/data/poseidon_gwc_k7.hex``, which the JAX package made through
``tests/make_poseidon_pin.py``.  The pin is only read here: a missing file
fails.
"""

import os

import numpy as np
import pytest
import torch

import test_poseidon as jposeidon
import torch_circuits as tc
from torch_circuits import failure_summary as summary
from halo2_tpu.circuit import Value as JV
from halo2_tpu.dev import MockProver as JaxMockProver
from halo2_tpu.fields.spec import BN254_FR as JAX_FR
from halo2_tpu.fields.spec import PASTA_FP as JAX_FP
from halo2_tpu.gadgets.poseidon import hash_message as jax_hash_message
from halo2_tpu.gadgets.poseidon import p128_pow5_t3 as jax_p128_pow5_t3
from halo2_tpu.gadgets.poseidon import permute as jax_permute
from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.fields.spec import BN254_FR, PASTA_FP
from halo2_tpu_torch.gadgets.poseidon import (
    ConstantLength,
    PoseidonSpec,
    hash_message,
    p128_pow5_t3,
    permute,
)
from halo2_tpu_torch.gadgets.poseidon.primitives import full_round, mds_mul, partial_round, pow5

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

PIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "poseidon_gwc_k7.hex")
FIELDS = {"bn254": (BN254_FR, JAX_FR), "pasta": (PASTA_FP, JAX_FP)}


class JaxPastaHashCircuit(jposeidon.HashCircuit):
    spec = jax_p128_pow5_t3(JAX_FP)


def test_constants_match_reference_fp():
    """Grain/MDS constants equal the reference's hardcoded Pallas tables
    (halo2_gadgets/src/poseidon/primitives/fp.rs)."""
    rcs, mds, mds_inv = p128_pow5_t3(PASTA_FP).constants()
    assert rcs[0][0] == 0x360D7470611E473D353F628F76D110F34E71162F31003B7057538C2596426303
    assert mds[0][0] == 0x0AB5E5B874A68DE7B3D59FBDC8C9EAD497D7A0AB23850B56323F2486D7E11B63
    assert mds_inv[0][0] == 0x2CC057F3FA14687ACC59FFD00DE864434543705F35E98AB5C6DE463CD1404E6B
    p = PASTA_FP.p
    for i in range(3):
        for j in range(3):
            assert sum(mds[i][k] * mds_inv[k][j] for k in range(3)) % p == (i == j)


@pytest.mark.parametrize("field", list(FIELDS))
def test_constants_equal_jax(field):
    spec, jspec = FIELDS[field]
    ours, theirs = p128_pow5_t3(spec), jax_p128_pow5_t3(jspec)
    assert ours.constants() == theirs.constants()
    assert (ours.t, ours.rate, ours.full_rounds, ours.partial_rounds) == (
        theirs.t, theirs.rate, theirs.full_rounds, theirs.partial_rounds)


@pytest.mark.parametrize("field", list(FIELDS))
def test_permute_and_hash_equal_jax(field):
    spec, jspec = FIELDS[field]
    ours, theirs = p128_pow5_t3(spec), jax_p128_pow5_t3(jspec)
    rs = np.random.default_rng(11)
    for _ in range(4):
        state = [int.from_bytes(rs.bytes(32), "little") % spec.p for _ in range(3)]
        assert permute(ours, state) == jax_permute(theirs, state)
        msg = state[:2]
        assert (hash_message(ours, ConstantLength(2), msg)
                == jax_hash_message(theirs, ConstantLength(2), msg))
    # the sponge's domain: hash([6, 42]) = permute([6, 42, 2 << 64])[0]
    assert hash_message(ours, ConstantLength(2), [6, 42]) == permute(ours, [6, 42, 2 << 64])[0]


def _textbook_permute(spec, state):
    """The permutation as primitives.rs writes it: pow(x, 5, p) and the full
    matrix product, every word reduced after each step."""
    p = spec.field.p
    rcs, mds, _ = spec.constants()
    half = spec.full_rounds // 2
    for r, rc in enumerate(rcs):
        state = [(w + c) % p for w, c in zip(state, rc)]
        if half <= r < half + spec.partial_rounds:
            state[0] = pow(state[0], 5, p)
        else:
            state = [pow(w, 5, p) for w in state]
        state = [sum(m * w for m, w in zip(row, state)) % p for row in mds]
    return state


@pytest.mark.parametrize("width", [3, 4])
def test_rounds_equal_textbook(width):
    """``pow5`` and ``sbox``, ``mds_mul`` (unrolled at width 3, a plain sum at others),
    ``full_round``, ``partial_round`` and ``permute`` equal the textbook
    arithmetic on seeded states, unreduced and negative words included."""
    spec = PoseidonSpec(BN254_FR, width, width - 1, 8, 56, 0)
    p = BN254_FR.p
    rcs, mds, _ = spec.constants()
    rs = np.random.default_rng(width)
    for case in range(6):
        state = [int.from_bytes(rs.bytes(32), "little") % p for _ in range(width)]
        if case == 1:
            state = [w + p for w in state]
        if case == 2:
            state = [-w for w in state]
        assert pow5(state[0], p) == spec.sbox(state[0]) == pow(state[0], 5, p)
        assert mds_mul(mds, state, p) == [sum(m * w for m, w in zip(row, state)) % p for row in mds]
        assert full_round(p, mds, state, rcs[0]) == mds_mul(
            mds, [pow((w + c) % p, 5, p) for w, c in zip(state, rcs[0])], p)
        words = [(w + c) % p for w, c in zip(state, rcs[4])]
        assert partial_round(p, mds, state, rcs[4]) == mds_mul(
            mds, [pow(words[0], 5, p)] + words[1:], p)
        assert permute(spec, state) == _textbook_permute(spec, [w % p for w in state])


@pytest.mark.parametrize("case", ["bn254", "bn254_bad_instance", "pasta", "pasta_bad_instance"])
def test_hash_circuit_mock_prover_equals_jax(case):
    spec, jspec = FIELDS[case.split("_")[0]]
    port_cls, jax_cls = ((tc.HashCircuit, jposeidon.HashCircuit) if spec is BN254_FR
                         else (tc.PastaHashCircuit, JaxPastaHashCircuit))
    digest = hash_message(port_cls.spec, ConstantLength(2), [6, 42])
    inst = [[(digest + case.endswith("bad_instance")) % spec.p]]
    want = summary(JaxMockProver.run(jspec, 7, jax_cls(JV.known([6, 42]), JV.known(digest)),
                                     inst).verify(vectorized=False))
    prover = MockProver.run(spec, 7, port_cls(Value.known([6, 42]), Value.known(digest)), inst,
                            device="cpu")
    assert summary(prover.verify(vectorized=True)) == want
    assert summary(prover.verify(vectorized=False)) == want
    assert [f[0] for f in want] == (["Permutation"] if case.endswith("bad_instance") else [])


def test_poseidon_proof_equals_pin(monkeypatch):
    """The K=7 GWC proof, made with the prover's sanity asserts on, equals the
    JAX package's pin byte for byte; it verifies and a wrong instance is
    rejected."""
    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng

    with open(PIN) as f:  # a missing pin fails here: never re-pinned
        expected = bytes.fromhex(f.read().strip())
    spec = BN254_G1.scalar
    digest = hash_message(tc.HashCircuit.spec, ConstantLength(2), [6, 42])
    params = ParamsKZG.setup_host(7, seed=b"poseidon-e2e", device="cpu")
    circuit = tc.HashCircuit(Value.known([6, 42]), Value.known(digest))
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    monkeypatch.setenv("HALO2_TPU_SANITY_CHECKS", "1")
    proof = create_proof(params, pk, [circuit], [[[digest]]], FieldRng(spec, b"poseidon-rng"),
                         Blake2bTranscript(BN254_G1), gwc_create_proof)
    assert proof == expected
    assert verify_proof(params, vk, [[[digest]]], Blake2bTranscript(BN254_G1, proof),
                        gwc_verify_proof) is True
    assert not verify_proof(params, vk, [[[(digest + 1) % spec.p]]],
                            Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)
