"""The halo2_tpu_torch main path as a whole: keygen -> prove -> verify.

The port's proof of the mul-gate circuit at k=6 must equal the JAX
package's pinned bytes ``tests/data/dryrun_proof_k6.hex`` (a missing pin
fails; it is never written here); verify must accept it, also through the
real pairing, and reject a wrong instance.  A ``BenchPlonkCircuit`` proof at
k=5 runs in a subprocess that shows the port never imports jax.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from halo2_tpu_torch.plonk.error import ConstraintSystemFailure
from halo2_tpu_torch.poly import Rotation
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
from halo2_tpu_torch.transcript import Blake2bTranscript
from halo2_tpu_torch.utils.rng import FieldRng

from torch_circuits import EntryCircuit

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = BN254_G1.scalar
INSTANCE = pow(5, 4, SPEC.p)


class CountingEntryCircuit(EntryCircuit):
    syntheses = 0

    def without_witnesses(self):
        return CountingEntryCircuit(self.constant, Value.unknown())

    def synthesize(self, config, layouter):
        CountingEntryCircuit.syntheses += 1
        return super().synthesize(config, layouter)


@pytest.fixture(scope="module")
def entry():
    params = ParamsKZG.setup_host(6, seed=b"dryrun", device="cpu")
    circuit = CountingEntryCircuit(1, Value.known(5))
    CountingEntryCircuit.syntheses = 0
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    keygen_syntheses = CountingEntryCircuit.syntheses
    proof = create_proof(
        params, pk, [circuit], [[[INSTANCE]]], FieldRng(SPEC, b"dryrun-proof"),
        Blake2bTranscript(BN254_G1), gwc_create_proof,
    )
    return {
        "params": params, "vk": vk, "pk": pk, "circuit": circuit, "proof": proof,
        "keygen_syntheses": keygen_syntheses,
    }


def _verify(params, vk, instance, proof):
    return verify_proof(
        params, vk, [[[instance]]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof
    )


def test_entry_proof_matches_jax_pin(entry):
    with open(os.path.join(HERE, "data", "dryrun_proof_k6.hex")) as f:
        expected = bytes.fromhex(f.read().strip())
    assert entry["proof"] == expected


def test_entry_proof_verifies(entry):
    assert _verify(entry["params"], entry["vk"], INSTANCE, entry["proof"])


def test_entry_proof_rejects_wrong_instance(entry):
    assert not _verify(entry["params"], entry["vk"], INSTANCE + 1, entry["proof"])


def test_entry_proof_verifies_through_real_pairing(entry):
    p = entry["params"]
    no_toxic_waste = ParamsKZG(p.k, p.g, p.g_lagrange, p.g2, p.s_g2)
    assert _verify(no_toxic_waste, entry["vk"], INSTANCE, entry["proof"])


def test_keygen_synthesizes_once(entry):
    assert entry["keygen_syntheses"] == 1


def test_streamed_cosets_give_the_same_proof(entry):
    """evaluate_h's streaming path (cosets recomputed on demand under an LRU
    of one column, as above 2^20 extended rows) leaves the bytes unchanged."""
    pk = entry["pk"]
    pk.ev.stream_threshold, pk.ev.coset_budget = 0, 1
    try:
        proof = create_proof(
            entry["params"], pk, [entry["circuit"]], [[[INSTANCE]]],
            FieldRng(SPEC, b"dryrun-proof"), Blake2bTranscript(BN254_G1), gwc_create_proof,
        )
    finally:
        del pk.ev.stream_threshold, pk.ev.coset_budget
    assert proof == entry["proof"]


_SUBPROCESS = r"""
import json, sys
import halo2_tpu_torch.bench.roofline
from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
from halo2_tpu_torch.transcript import Blake2bTranscript
from halo2_tpu_torch.utils.rng import FieldRng
from torch_circuits import BenchPlonkCircuit

k = 5
spec = BN254_G1.scalar
params = ParamsKZG.setup_host(k, seed=b"bench-prove", device="cpu")
circuit = BenchPlonkCircuit(k, Value.known(2))
vk = keygen_vk(params, circuit.without_witnesses())
pk = keygen_pk(params, vk, circuit.without_witnesses())
proof = create_proof(params, pk, [circuit], [[]], FieldRng(spec, b"bench-prove-rng"),
                     Blake2bTranscript(BN254_G1), gwc_create_proof)
ok = verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)
bad = bytearray(proof)
bad[len(bad) // 2] ^= 1
tampered = verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, bytes(bad)), gwc_verify_proof)
print(json.dumps({"verified": ok, "tampered_verified": tampered, "proof_len": len(proof),
                  "jax_loaded": any(m == "jax" or m.startswith(("jax.", "halo2_tpu.")) or m == "halo2_tpu"
                                    for m in sys.modules)}))
"""


@pytest.fixture(scope="module")
def bench_subprocess():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(HERE), HERE])
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS], capture_output=True, text=True, env=env,
        cwd=os.path.dirname(HERE), timeout=600,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_bench_circuit_k5_proof_verifies(bench_subprocess):
    assert bench_subprocess["verified"] is True
    assert bench_subprocess["proof_len"] > 0


def test_bench_circuit_k5_tampered_proof_rejected(bench_subprocess):
    assert bench_subprocess["tampered_verified"] is False


def test_port_never_imports_jax(bench_subprocess):
    assert bench_subprocess["jax_loaded"] is False


class LookupCircuit(EntryCircuit):
    """One advice value looked up in the 4-row table 0..3."""

    def __init__(self, a):
        self.a = a

    def without_witnesses(self):
        return LookupCircuit(Value.unknown())

    @classmethod
    def configure(cls, meta):
        a = meta.advice_column()
        t = meta.lookup_table_column()
        meta.lookup("a in t", lambda cells: [(cells.query_advice(a, Rotation.cur()), t)])
        return {"a": a, "t": t}

    def synthesize(self, config, layouter):
        layouter.assign_region(
            "a", lambda region: region.assign_advice(config["a"], 0, lambda: self.a)
        )

        def table(tbl):
            for i in range(4):
                tbl.assign_cell(config["t"], i, i)

        layouter.assign_table("t", table)


def test_lookup_circuit_is_refused():
    """A witness outside the lookup table is refused by the prover's
    multiset matching (lookup/prover.rs:391-475)."""
    params = ParamsKZG.setup_host(4, seed=b"lookup", device="cpu")
    circuit = LookupCircuit(Value.known(7))
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    with pytest.raises(ConstraintSystemFailure, match="not in table"):
        create_proof(params, pk, [circuit], [[]], FieldRng(SPEC, b"x"),
                     Blake2bTranscript(BN254_G1), gwc_create_proof)
