"""Lookups and SHPLONK in halo2_tpu_torch against the JAX package.

The port's proofs of the tests/plonk_api.rs circuit (standard plonk with a
lookup, two circuit instances in one proof) must equal the JAX package's
pinned bytes ``tests/data/plonk_api_{gwc,shplonk}_k5.hex``, byte for byte; a
missing pin fails (it is never written here).  Verify must accept them and
reject a wrong instance, alone and through ``KZGAccumulatorStrategy``.  The
lookup's host permutation, SHPLONK's rotation sets and a two-column lookup's
theta-compressed values are held to the JAX package's on numpy-seeded
inputs: exact (equal ints), since all of it is exact arithmetic.  A
two-column lookup, which folds with theta, is proved and verified at k=4.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.curves.spec import BN254_G1 as JAX_BN254_G1
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.plonk import prover as jprover
from halo2_tpu.plonk.circuit import ConstraintSystem as JaxConstraintSystem
from halo2_tpu.plonk.evaluation import evaluate_on_lagrange as jax_evaluate_on_lagrange
from halo2_tpu.poly import Rotation as JaxRotation
from halo2_tpu.poly import multiopen_shplonk as jshplonk
from halo2_tpu.utils.rng import FieldRng as JaxFieldRng

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from halo2_tpu_torch.plonk import prover
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.error import ConstraintSystemFailure
from halo2_tpu_torch.plonk.evaluation import compress_expressions, evaluate_on_lagrange
from halo2_tpu_torch.plonk.verifier import KZGAccumulatorStrategy
from halo2_tpu_torch.poly import Rotation
from halo2_tpu_torch.poly import multiopen_shplonk as shplonk
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
from halo2_tpu_torch.transcript import Blake2bTranscript
from halo2_tpu_torch.utils.rng import FieldRng

from torch_circuits import (
    StandardPlonkCircuit,
    TupleLookupCircuit,
    configure_tuple_lookup,
    plonk_api_common,
)

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = BN254_G1.scalar
K = 5
A, INSTANCE, TABLE = plonk_api_common(SPEC)
INSTANCES = [[[INSTANCE]], [[INSTANCE]]]
SCHEMES = {
    "gwc": (gwc_create_proof, gwc_verify_proof, b"gwc-rng"),
    "shplonk": (shplonk.shplonk_create_proof, shplonk.shplonk_verify_proof, b"shplonk-rng"),
}


def _pin(name: str) -> bytes:
    with open(os.path.join(HERE, "data", f"{name}.hex")) as f:  # missing: fails
        return bytes.fromhex(f.read().strip())


@pytest.fixture(scope="module")
def kzg():
    params = ParamsKZG.setup_host(K, seed=b"plonk-api")
    empty = StandardPlonkCircuit(Value.unknown(), TABLE)
    vk = keygen_vk(params, empty)
    return params, vk, keygen_pk(params, vk, empty)


@pytest.fixture(scope="module")
def proofs(kzg):
    params, _, pk = kzg
    circuit = StandardPlonkCircuit(Value.known(A), TABLE)
    return {
        name: create_proof(params, pk, [circuit, circuit], INSTANCES, FieldRng(SPEC, seed),
                           Blake2bTranscript(BN254_G1), create)
        for name, (create, _, seed) in SCHEMES.items()
    }


def _verify(kzg, scheme, instances, proof, strategy=None):
    params, vk, _ = kzg
    return verify_proof(params, vk, instances, Blake2bTranscript(BN254_G1, proof),
                        SCHEMES[scheme][1], strategy=strategy)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_plonk_api_proof_matches_jax_pin(proofs, scheme):
    assert proofs[scheme] == _pin(f"plonk_api_{scheme}_k5")


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_plonk_api_proof_verifies(kzg, proofs, scheme):
    assert _verify(kzg, scheme, INSTANCES, proofs[scheme]) is True


@pytest.mark.parametrize("scheme,bad", [("gwc", 1), ("shplonk", 0)])
def test_plonk_api_proof_rejects_wrong_instance(kzg, proofs, scheme, bad):
    instances = [[[INSTANCE]], [[INSTANCE]]]
    instances[bad] = [[(INSTANCE + 1) % SPEC.p]]
    assert _verify(kzg, scheme, instances, proofs[scheme]) is False


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_accumulator_strategy_accepts_two_and_rejects_a_bad_one(kzg, proofs, scheme):
    wrong = [[[INSTANCE]], [[(INSTANCE + 1) % SPEC.p]]]
    for batch, want in (([INSTANCES, INSTANCES], True), ([INSTANCES, wrong], False)):
        strategy = KZGAccumulatorStrategy(kzg[0], FieldRng(SPEC, b"accumulate"))
        for instances in batch:
            assert _verify(kzg, scheme, instances, proofs[scheme], strategy) is strategy
        assert strategy.finalize() is want


# ---------------------------------------------------------------------------
# the pieces, against the JAX package
# ---------------------------------------------------------------------------


def test_permute_expression_pair_matches_jax():
    n, bf = 32, 5
    usable = n - bf - 1
    rs = np.random.default_rng(11)
    table = [int(v) for v in rs.integers(0, 1 << 40, size=usable)]
    table[3] = table[7] = table[9]  # repeated table values
    inputs = [table[int(i)] for i in rs.integers(0, usable, size=usable)]
    got = prover._permute_expression_pair(FieldRng(SPEC, b"perm"), inputs, table, n, bf)
    want = jprover._permute_expression_pair(
        None, JaxFieldRng(JAX_BN254_G1.scalar, b"perm"), inputs, table, n, bf
    )
    assert got == want
    pi, pt = got
    assert pi[:usable] == sorted(inputs) and sorted(pt[:usable]) == sorted(table)
    for row in range(usable):  # a new input value sits on its table value
        assert row == 0 or pi[row] == pi[row - 1] or pi[row] == pt[row]

    missing = inputs[:-1] + [(1 << 41) + 1]
    with pytest.raises(ConstraintSystemFailure):
        prover._permute_expression_pair(FieldRng(SPEC, b"perm"), missing, table, n, bf)


def test_shplonk_rotation_sets_match_jax():
    """Commitments keyed by object identity, point sets compared as sets."""
    rs = np.random.default_rng(12)
    polys = [object() for _ in range(7)]
    points = [int(v) * 0x9E3779B97F4A7C15 % SPEC.p for v in rs.integers(1, 1 << 62, size=4)]

    class Q:
        def __init__(self, poly, point):
            self.poly, self.point = poly, point

    queries = [Q(polys[int(i)], points[int(j)])
               for i, j in zip(rs.integers(0, 7, size=20), rs.integers(0, 4, size=20))]
    got = shplonk.construct_intermediate_sets(queries, lambda q: q.poly, lambda q: q.point)
    want = jshplonk.construct_intermediate_sets(queries, lambda q: q.poly, lambda q: q.point)
    assert got[1] == want[1]
    assert [(pts, [id(c) for c in comms]) for pts, comms in got[0]] == [
        (pts, [id(c) for c in comms]) for pts, comms in want[0]
    ]


def test_tuple_lookup_compressed_values_match_jax():
    k = 4
    n = 1 << k
    cs = ConstraintSystem()
    configure_tuple_lookup(cs, Rotation)
    jcs = JaxConstraintSystem()
    configure_tuple_lookup(jcs, JaxRotation)
    (arg,), (jarg,) = cs.lookups, jcs.lookups
    rs = np.random.default_rng(13)

    def column(seed):
        vals = [int(v) for v in np.random.default_rng(seed).integers(0, 1 << 62, size=n)]
        return limb.ints_to_limbs_np([SPEC.to_mont(v) for v in vals])

    advice = [column(20 + i) for i in range(cs.num_advice_columns)]
    fixed = [column(30 + i) for i in range(cs.num_fixed_columns)]
    theta = int(rs.integers(1, 1 << 62))

    def port(exprs):
        t = [torch.from_numpy(a) for a in advice], [torch.from_numpy(f) for f in fixed]
        return compress_expressions(
            SPEC, exprs, limb.from_int(SPEC, theta).reshape(16, 1),
            lambda e: evaluate_on_lagrange(SPEC, e, n, t[1], t[0], [], [], "cpu").expand(16, n),
        )

    def jax(exprs):
        jspec = JAX_BN254_G1.scalar
        th = jnp.broadcast_to(jlimb.from_int(jspec, theta).reshape(16, 1), (16, n))
        acc = None
        for e in exprs:
            ev = jax_evaluate_on_lagrange(
                jspec, e, n, [jnp.asarray(f.astype(np.uint32)) for f in fixed],
                [jnp.asarray(a.astype(np.uint32)) for a in advice], [], [],
            )
            acc = ev if acc is None else jlimb.fadd(jspec, jlimb.fmul(jspec, acc, th), ev)
        return acc

    for exprs, jexprs in ((arg.input_expressions, jarg.input_expressions),
                          (arg.table_expressions, jarg.table_expressions)):
        assert len(exprs) == 2
        got = limb.to_ints(SPEC, port(exprs))
        want = jlimb.to_ints(JAX_BN254_G1.scalar, jax(jexprs))
        assert got == want


@pytest.fixture(scope="module")
def tuple_lookup():
    params = ParamsKZG.setup_host(4, seed=b"tuple-lookup")
    circuit = TupleLookupCircuit(4)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    return params, vk, pk, circuit, _prove_tuple(params, pk, circuit)


def _prove_tuple(params, pk, circuit):
    return create_proof(params, pk, [circuit], [[]], FieldRng(SPEC, b"tuple-rng"),
                        Blake2bTranscript(BN254_G1), shplonk.shplonk_create_proof)


def test_tuple_lookup_proof_verifies_and_rejects_tampering(tuple_lookup):
    params, vk, _, _, proof = tuple_lookup
    verify = lambda pr: verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, pr),
                                     shplonk.shplonk_verify_proof)
    assert verify(proof) is True
    bad = bytearray(proof)
    bad[-96] ^= 1  # the last evaluation's low byte (before h1, h2): still decodes
    assert verify(bytes(bad)) is False


def test_tuple_lookup_streamed_cosets_give_the_same_proof(tuple_lookup):
    """The lookup cosets through evaluate_h's LRU of one column."""
    params, _, pk, circuit, proof = tuple_lookup
    pk.ev.stream_threshold, pk.ev.coset_budget = 0, 1
    try:
        assert _prove_tuple(params, pk, circuit) == proof
    finally:
        del pk.ev.stream_threshold, pk.ev.coset_budget
