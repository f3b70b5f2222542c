"""The configuration ``poseidon-merkle-kzg-shplonk`` on the CPU, over a
depth-2 tree (4 leaves, 3 hashes) at k = 8: the reference's account of the
port's circuit equals the port's keygen (the pinned constraint-system text,
every fixed column after selector compression, the permutation's sigma from
the copies), the reference's Poseidon equals upstream's constants and the
port's hash, and one port proof through ``create_proof`` with
``shplonk_create_proof`` is accepted by the reference's verifier with its
SHPLONK check and rejected with the instance or h' altered.  The degree-6
gates' 8n domain and SHPLONK are the same code at any k.

    python -m pytest prover_bench/tests/test_pb_poseidon.py -q   (~2 min on one core)
"""

import dataclasses

import pytest

from prover_bench.harness import cell as cell_mod
from prover_bench.harness import check, layers, traffic, yardstick
from prover_bench.reference import bn254, keys, multiopen_shplonk, verifier
from prover_bench.reference.transcript_blake2b import Reader

CELL = "poseidon-shplonk-k17-2048leaf"
K = 8
LEAVES = 4
SEED = 2**33 + 22
FIXED_COLUMNS = 9  # rc_a0..2, rc_b0..2, three compressed selector columns
PASTA_FP = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001


@pytest.fixture(scope="module")
def full_cell():
    return cell_mod.load(CELL)


@pytest.fixture(scope="module")
def small(full_cell):
    """The cell over a depth-2 tree at k = K."""
    config = dict(full_cell.config, k=K, leaves=LEAVES, depth=2, hashes=LEAVES - 1)
    mix = dict(full_cell.traffic, message_bytes=32 * LEAVES)
    return dataclasses.replace(full_cell, config=config, traffic=mix)


@pytest.fixture(scope="module")
def accounts(small, torch_threads):
    """(the port's ConstraintSystem after selector compression, its
    KeygenAssembly, the compressed selector columns; the reference's
    constraint system, fixed columns and copies)."""
    from halo2_tpu_torch.plonk.circuit import ConstraintSystem
    from halo2_tpu_torch.plonk.keygen import KeygenAssembly, compress_selectors

    circuit = small.circuit_module().blank(small.config)
    cs = ConstraintSystem()
    circuit_config = type(circuit).configure(cs)
    assembly = KeygenAssembly(K, cs, 1 << K)
    circuit.floor_planner.synthesize(assembly, circuit, circuit_config, list(cs.constants))
    selector_columns = compress_selectors(cs, assembly.selectors)
    ref = small.reference_module()
    fixed, copies = ref.layout(small.config)
    return cs, assembly, selector_columns, ref.constraint_system(small.config), fixed, copies


def test_pinned_text_equals_the_ports(accounts):
    from halo2_tpu_torch.plonk import rust_debug

    cs, _, _, ref_cs, _, _ = accounts
    ported = rust_debug.render(rust_debug.pinned_cs_node(cs), alternate=False)
    assert ref_cs.debug() == ported
    assert "constants: [Column { index: 3, column_type: Fixed }]" in ported
    assert ref_cs.degree() == cs.degree() == 6
    assert ref_cs.blinding_factors() == cs.blinding_factors() == 5
    assert ref_cs.extended_k(K) == K + 3 and ref_cs.permutation_sets() == 2


@pytest.mark.parametrize("column", range(FIXED_COLUMNS))
def test_fixed_column_equals_the_ports_keygen(accounts, column):
    _, a, selector_columns, _, ref_fixed, _ = accounts
    ported = [{r: v.evaluate(bn254.R) for r, v in col.items()} for col in a.fixed]
    ported += [{r: int(v) for r, v in enumerate(sv) if v} for sv in selector_columns]
    assert len(ported) == len(ref_fixed) == FIXED_COLUMNS
    assert ref_fixed[column] == ported[column]
    assert any(ported[column].values())


def test_copies_give_the_ports_sigma(accounts):
    _, a, _, ref_cs, _, ref_copies = accounts
    n = 1 << K
    columns = [(c.kind.lower(), c.index) for c in a.permutation.columns]
    assert columns == ref_cs.permutation and len(columns) == 7
    sigmas = keys.sigma_columns(K, ref_cs.permutation, ref_copies)
    w = bn254.omega(K)
    wpow = [1] * n
    for i in range(1, n):
        wpow[i] = wpow[i - 1] * w % bn254.R
    for c, mapping in enumerate(a.permutation.mapping):
        ported = [pow(bn254.DELTA, int(f) // n, bn254.R) * wpow[int(f) % n] % bn254.R
                  for f in mapping]
        assert ported == [sigmas[c][i] for i in range(n)], c


def test_grain_and_mds_over_pasta_equal_upstream(full_cell):
    """Upstream's hard-coded P128Pow5T3 tables over Pallas Fp
    (halo2_gadgets/src/poseidon/primitives/fp.rs, as tests/test_poseidon.py
    quotes them)."""
    rcs, mds, mds_inv = full_cell.reference_module().constants(PASTA_FP)
    assert len(rcs) == 64 and all(len(row) == 3 for row in rcs)
    assert rcs[0][0] == 0x360D7470611E473D353F628F76D110F34E71162F31003B7057538C2596426303
    assert mds[0][0] == 0x0AB5E5B874A68DE7B3D59FBDC8C9EAD497D7A0AB23850B56323F2486D7E11B63
    assert mds_inv[0][0] == 0x2CC057F3FA14687ACC59FFD00DE864434543705F35E98AB5C6DE463CD1404E6B


def test_hash_and_root_equal_the_ports(small):
    from halo2_tpu_torch.fields.spec import BN254_FR
    from halo2_tpu_torch.gadgets.poseidon import ConstantLength, hash_message, p128_pow5_t3

    ref, port = small.reference_module(), small.circuit_module()
    spec = p128_pow5_t3(BN254_FR)
    for a, b in [(0, 0), (6, 42), (bn254.R - 1, 2**200 + 7)]:
        assert ref.hash2(a, b) == hash_message(spec, ConstantLength(2), [a, b])
    message = traffic.message(small.traffic, SEED, 3)
    leaves = port.leaves_of(small.config, message)
    root = port.merkle_root(leaves)
    assert ref.instance(small.config, message) == [[root]]
    assert root == ref.hash2(ref.hash2(*leaves[:2]), ref.hash2(*leaves[2:]))


@pytest.mark.parametrize("size", [0, 32 * LEAVES - 1, 32 * LEAVES + 1, 65536])
def test_a_message_of_other_length_raises(small, size):
    with pytest.raises(ValueError, match="leaves"):
        small.circuit_module().prove_inputs(small.config, bytes(size))


def test_the_mix_holds_the_configured_leaves(full_cell):
    config, mix = full_cell.config, full_cell.traffic
    assert mix["message_bytes"] == 32 * config["leaves"] == 65536
    assert config["leaves"] == 2 ** config["depth"] == config["hashes"] + 1
    message = traffic.message(mix, 2**40 + 3, 0)
    circuit, instance = full_cell.circuit_module().prove_inputs(config, message)
    tampered, tampered_instance = full_cell.circuit_module().prove_inputs(config, message,
                                                                          tamper=True)
    values = [c.leaves[0].value() for c in (circuit, tampered)]
    assert values[1] == (values[0] + 1) % bn254.R
    assert [v.value() for v in tampered.leaves[1:]] == [v.value() for v in circuit.leaves[1:]]
    assert tampered_instance == instance


def test_the_yardstick_counts_six_lagrange_and_eight_monomial_msms(full_cell):
    cs = full_cell.reference_module().constraint_system(full_cell.config)
    assert yardstick.proof_msms(cs, full_cell.config["multiopen"]) == {"lagrange": 6,
                                                                      "monomial": 8}
    assert multiopen_shplonk.opening_msms(4) == 2


@pytest.fixture(scope="module")
def proof(small, torch_threads):
    """(prover, one proof of the small cell, the reference's key and s)."""
    from prover_bench.harness import prover as prover_mod

    prover = prover_mod.Prover(small, SEED, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prover_mod, "WARMUP_PROOFS", 0)
        prover.setup()
    p = prover.prove(0)
    ref, rvk, s = check.reference_vk(small, SEED)
    return prover, p, ref, rvk, s


def _verify(small, rvk, s, instance, proof_bytes):
    return verifier.verify(rvk, instance, proof_bytes, s, Reader, multiopen_shplonk.verify)


def test_the_reference_accepts_the_ports_shplonk_proof(small, proof):
    prover, p, ref, rvk, s = proof
    assert prover.multiopen.__name__ == "shplonk_create_proof"
    assert check.vk_mismatches(prover.vk_data(), rvk) == 0
    assert p.instance == ref.instance(small.config, p.message)
    assert _verify(small, rvk, s, p.instance, p.proof)
    readings = check.check(small, SEED, prover.vk_data(), [p])
    assert readings == {"vk_mismatches": 0, "proofs_rejected": 0, "duplicate_proofs": 0}


def test_the_proof_ends_with_the_two_shplonk_points(small, proof):
    """Every commitment point of the proof is one MSM of the yardstick's
    count, the openings' two included."""
    _, p, ref, _, _ = proof
    cs = ref.constraint_system(small.config)
    msms = sum(yardstick.proof_msms(cs, "shplonk").values())
    scalars = (len(cs.queries["advice"]) + len(cs.queries["fixed"]) + 1 + len(cs.permutation)
               + 3 * cs.permutation_sets() - 1)
    assert len(p.proof) == 32 * (msms + scalars)


def test_the_reference_rejects_another_instance(small, proof):
    _, p, _, rvk, s = proof
    assert not _verify(small, rvk, s, [[(p.instance[0][0] + 1) % bn254.R]], p.proof)


@pytest.mark.parametrize("byte", [0, 7, 31])
def test_the_reference_rejects_a_flipped_byte_of_h2(small, proof, byte):
    _, p, _, rvk, s = proof
    flipped = bytearray(p.proof)
    flipped[len(flipped) - 32 + byte] ^= 0x01
    assert not _verify(small, rvk, s, p.instance, bytes(flipped))


def test_the_reference_rejects_a_proof_with_bytes_after_h2(small, proof):
    _, p, _, rvk, s = proof
    assert not _verify(small, rvk, s, p.instance, p.proof + bytes(32))


# -- the reader of the "multiopen: shplonk h(X)" span --------------------------------

LEAST = {"seconds": 3e-6}
PHASES = {"multiopen": 1.5, "multiopen: shplonk h(X)": 0.9, "multiopen: shplonk l(X)": 0.3,
          "witness synthesis (host)": 9.0}


def test_shplonk_h_s_reads_its_span():
    data = layers.LayerData(None, PHASES, 3, LEAST)
    read = cell_mod.metric_reader("shplonk_h_s")
    assert read(data) == pytest.approx(0.3)
    assert read(data) <= cell_mod.metric_reader("multiopen_s")(data)


@pytest.mark.parametrize("phases, proofs", [({"multiopen": 1.5}, 3), (PHASES, 0), ({}, 0)])
def test_shplonk_h_s_is_silent_without_its_span(phases, proofs):
    """None on a GWC cell, on a program that has no such span, or without a
    timed proof; ``read_all`` then leaves it out of the line."""
    data = layers.LayerData(None, phases, proofs, LEAST)
    assert cell_mod.metric_reader("shplonk_h_s")(data) is None
    entries = [m for m in cell_mod.load_json(f"{cell_mod.ROOT}/BENCHMARK.json")["per_layer"]
               if m["name"] == "shplonk_h_s"]
    assert len(entries) == 1 and layers.read_all(entries, data) == {}
