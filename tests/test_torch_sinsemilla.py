"""Sinsemilla in halo2_tpu_torch against the JAX package and its pin.

The host primitives (the 1,024 S generators, ``HashDomain.hash_to_point``,
``CommitDomain.commit``) equal the JAX package's on seeded messages; the hash
circuit and the depth-4 Merkle path give the JAX package's per-row MockProver
outcome on both of the port's paths.  The test circuits of
tests/test_sinsemilla.py witness their message on ``witness_pieces`` and copy
it into the hash region without equality on that column: keygen raises
``ColumnNotInPermutation`` in both packages, and passes in both once the
column has equality.  The commit circuit's verifying key over IPA on Vesta
has the ``transcript_repr`` of ``tests/data/sinsemilla_commit_ipa_k11.vk``,
which the JAX package's keygen wrote through ``tests/make_sinsemilla_pin.py
--vk`` (its prove failed on a CPU, out of JIT memory, so no proof is
pinned); the pin is only read here.
"""

import os

import numpy as np
import pytest
import torch

import test_sinsemilla as jsin
import torch_circuits as tc
from torch_circuits import failure_summary as summary
from halo2_tpu.circuit import Value as JV
from halo2_tpu.circuit.layouter import SimpleFloorPlanner as JaxSimpleFloorPlanner
from halo2_tpu.dev import MockProver as JaxMockProver
from halo2_tpu.fields.spec import PASTA_FP as JAX_FP
from halo2_tpu.gadgets.sinsemilla import primitives as jprim
from halo2_tpu.gadgets.utilities import i2lebsp as jax_i2lebsp
from halo2_tpu.plonk.circuit import ConstraintSystem as JaxConstraintSystem
from halo2_tpu.plonk.error import ColumnNotInPermutation as JaxColumnNotInPermutation
from halo2_tpu.plonk.keygen import KeygenAssembly as JaxKeygenAssembly
from halo2_tpu_torch.circuit import SimpleFloorPlanner
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.fields.spec import PASTA_FP
from halo2_tpu_torch.gadgets.sinsemilla import primitives as prim
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.error import ColumnNotInPermutation
from halo2_tpu_torch.plonk.keygen import KeygenAssembly

torch.set_num_threads(1)  # host-bound synthesis and small limb tensors; xdist runs several workers

PIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "sinsemilla_commit_ipa_k11.vk")
K = prim.K


def test_generators_equal_jax():
    ours = prim.sinsemilla_s()
    assert len(ours) == 1 << K and ours == jprim.sinsemilla_s()
    p = PASTA_FP.p
    assert all((y * y - x ** 3 - 5) % p == 0 for x, y in ours)


def test_hash_and_commit_equal_jax():
    rs = np.random.default_rng(8)
    domain, jdomain = prim.HashDomain("MerkleCRH"), jprim.HashDomain("MerkleCRH")
    commit, jcommit = prim.CommitDomain("z.cash:test-commit"), jprim.CommitDomain("z.cash:test-commit")
    assert domain.Q == jdomain.Q and commit.R == jcommit.R and commit.M.Q == jcommit.M.Q
    for nbits in (K, 3 * K + 4, 25 * K, 52 * K):
        bits = [bool(b) for b in rs.integers(0, 2, nbits)]
        r = int.from_bytes(rs.bytes(32), "little") % (1 << 254)
        assert domain.hash_to_point(bits) == jdomain.hash_to_point(bits) is not None
        assert domain.hash(bits) == jdomain.hash(bits)
        assert commit.commit(bits, r) == jcommit.commit(bits, r) is not None
        assert commit.short_commit(bits, r) == jcommit.short_commit(bits, r)
    assert prim.pad([True] * 13) == jprim.pad([True] * 13)
    assert prim.incomplete_add(domain.Q, domain.Q) is None


def _jax_hash_circuit(nbits: int, seed: int):
    bits = jax_i2lebsp(pow(seed, 5, 1 << nbits), nbits)
    return jsin.HashCircuit([JV.known(b) for b in bits], jsin.DOMAIN.hash_to_point(bits))


def _jax_merkle_circuit(depth: int):
    port = tc.MerkleCircuit.of(depth)
    return jsin.MerkleCircuit(JV.known(port.leaf.value()), JV.known(port.leaf_pos.value()),
                              JV.known(port.path.value()), depth, port.expected_root)


CASES = {
    "hash_2_words": (lambda: tc.SinsemillaHashCircuit.of(2 * K, 3),
                     lambda: _jax_hash_circuit(2 * K, 3)),
    "hash_30_words": (lambda: tc.SinsemillaHashCircuit.of(30 * K, 7),
                      lambda: _jax_hash_circuit(30 * K, 7)),
    "merkle_depth4": (lambda: tc.MerkleCircuit.of(4), lambda: _jax_merkle_circuit(4)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tamper", [False, True])
def test_mock_prover_equals_jax(case, tamper):
    """k = 11: satisfied, and with one x_a cell of the first Sinsemilla
    region changed, the same failure list on all three paths."""
    port_circuit, jax_circuit = (make() for make in CASES[case])
    prover = MockProver.run(PASTA_FP, 11, port_circuit, [], device="cpu")
    jprover = JaxMockProver.run(JAX_FP, 11, jax_circuit, [])
    if tamper:
        for pr in (prover, jprover):
            region = next(r for r in pr.regions if r.name == "hash_to_point")
            row = min(region.rows) + 1
            pr.advice[0][row] = (pr.advice[0][row] + 1) % PASTA_FP.p
    want = summary(jprover.verify(vectorized=False))
    assert summary(prover.verify(vectorized=False)) == want
    assert summary(prover.verify(vectorized=True)) == want
    assert bool(want) == tamper


def _synthesize(cs_cls, assembly_cls, circuit, planner, k: int):
    cs = cs_cls()
    config = type(circuit).configure(cs)
    assembly = assembly_cls(k, cs, 1 << k)
    planner.synthesize(assembly, circuit, config, list(cs.constants))
    return assembly


def _with_equality(cls, pieces):
    class Proved(cls):
        @classmethod
        def configure(klass, meta):
            config = super().configure(meta)
            meta.enable_equality(pieces(config))
            return config

    return Proved


FINDING = {  # name -> (port circuit, JAX circuit, k, the config's witness_pieces)
    "hash": (lambda: tc.SinsemillaHashCircuit.of(2 * K, 3), lambda: _jax_hash_circuit(2 * K, 3),
             11, lambda c: c.witness_pieces),
    "merkle_depth4": (lambda: tc.MerkleCircuit.of(4), lambda: _jax_merkle_circuit(4), 11,
                      lambda c: c.sinsemilla_config.witness_pieces),
}


@pytest.mark.parametrize("name", list(FINDING))
def test_witness_pieces_need_equality_for_keygen(name):
    """The JAX package's behaviour, shared by the port: the test circuits copy
    from ``witness_pieces``, outside the permutation argument, so keygen
    synthesis raises ``ColumnNotInPermutation``; with equality on the column
    it passes, and the two packages' permutation mappings agree."""
    make, make_jax, k, pieces = FINDING[name]
    port, jax = make().without_witnesses(), make_jax().without_witnesses()
    with pytest.raises(ColumnNotInPermutation):
        _synthesize(ConstraintSystem, KeygenAssembly, port, SimpleFloorPlanner, k)
    with pytest.raises(JaxColumnNotInPermutation):
        _synthesize(JaxConstraintSystem, JaxKeygenAssembly, jax, JaxSimpleFloorPlanner, k)
    port.__class__ = _with_equality(type(port), pieces)
    jax.__class__ = _with_equality(type(jax), pieces)
    a = _synthesize(ConstraintSystem, KeygenAssembly, port, SimpleFloorPlanner, k)
    ja = _synthesize(JaxConstraintSystem, JaxKeygenAssembly, jax, JaxSimpleFloorPlanner, k)
    assert a.permutation.mapping.shape == ja.permutation.mapping.shape
    assert np.array_equal(a.permutation.mapping, ja.permutation.mapping)
    assert (a.permutation.mapping != np.arange(a.permutation.mapping.size).reshape(
        a.permutation.mapping.shape)).any()


def test_commit_circuit_needs_equality_for_keygen():
    """The commit circuit (Sinsemilla plus the ECC fixed-base mul), as the pin
    proves it: equality on ``witness_pieces`` makes keygen synthesis pass."""
    with pytest.raises(ColumnNotInPermutation):
        _synthesize(ConstraintSystem, KeygenAssembly, tc.CommitCircuit.of().without_witnesses(),
                    SimpleFloorPlanner, 11)
    circuit = tc.ProvedCommitCircuit.of().without_witnesses()
    a = _synthesize(ConstraintSystem, KeygenAssembly, circuit, SimpleFloorPlanner, 11)
    cs = ConstraintSystem()
    pieces = tc.ProvedCommitCircuit.configure(cs)[0].witness_pieces
    column = a.permutation.columns.index(pieces)
    identity = np.arange(a.permutation.mapping.size).reshape(a.permutation.mapping.shape)
    assert (a.permutation.mapping[column] != identity[column]).any()


def test_commit_circuit_mock_prover():
    """tests/test_sinsemilla.py::test_commit_domain_circuit on the port's two
    paths: satisfied, with and without equality on ``witness_pieces``."""
    for circuit in (tc.CommitCircuit.of(), tc.ProvedCommitCircuit.of()):
        prover = MockProver.run(PASTA_FP, 11, circuit, [], device="cpu")
        assert prover.verify(vectorized=False) == []
        assert prover.verify(vectorized=True) == []


@pytest.mark.slow
def test_commit_vk_equals_pin():
    """The commit circuit's k=11 verifying key over IPA on Vesta (the
    reference's SRS) has the JAX package's ``transcript_repr``; a proof made
    with it verifies and a flipped byte is rejected."""
    from halo2_tpu_torch.curves.spec import VESTA
    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu_torch.poly.ipa import IPASingleStrategy, ParamsIPA
    from halo2_tpu_torch.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng

    with open(PIN) as f:  # a missing pin fails here: never re-pinned
        expected = int(f.read().strip(), 16)
    params = ParamsIPA.setup(11, VESTA, device="cpu")
    circuit = tc.ProvedCommitCircuit.of()
    vk = keygen_vk(params, circuit.without_witnesses())
    assert vk.transcript_repr == expected
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    proof = create_proof(params, pk, [circuit], [[]], FieldRng(VESTA.scalar, b"sinsemilla-rng"),
                         Blake2bTranscript(VESTA), ipa_create_proof, query_instance=True)

    def verify(pr):
        return verify_proof(params, vk, [[]], Blake2bTranscript(VESTA, pr), ipa_verify_proof,
                            query_instance=True, strategy=IPASingleStrategy(params))

    assert verify(proof)
    flipped = bytearray(proof)
    flipped[len(proof) // 2] ^= 1
    assert not verify(bytes(flipped))


def test_vk_pin_is_present():
    """The pin phase 16(d) of chip_smoke.py holds the card's verifying key to:
    one 256-bit transcript_repr below the Vesta scalar field's modulus."""
    from halo2_tpu_torch.curves.spec import VESTA

    with open(PIN) as f:
        text = f.read().strip()
    assert len(text) == 64 and 0 < int(text, 16) < VESTA.scalar.p
