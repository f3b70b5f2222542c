"""The configuration ``sha256-table16-kzg-gwc`` on the CPU: the reference's
account of the port's Table16 circuit equals the port's keygen at k = 17 on
one block (the pinned constraint-system text, every fixed column after
selector compression, and the permutation's sigma from the copies), its
statement equals ``hashlib``, its messages pad to the configured blocks, and
the port's MockProver accepts the circuit of a 31-block message and finds the
control's broken copies.

    python -m pytest prover_bench/tests/test_pb_sha256.py -q   (~1 min; -m slow adds
    the MockProver run, several minutes on one core)
"""

import hashlib

import pytest

from pb_sha256_fixtures import K, SEED, one_block, sha256_cell  # noqa: F401
from prover_bench.harness import traffic
from prover_bench.reference import bn254, keys

FIXED_COLUMNS = 11  # add_const, the table's three, constants, six compressed selector columns


def test_pinned_text_equals_the_ports(one_block):  # noqa: F811
    from halo2_tpu_torch.plonk import rust_debug

    ported = rust_debug.render(rust_debug.pinned_cs_node(one_block.cs), alternate=False)
    assert one_block.ref_cs.debug() == ported
    assert "constants: [Column { index: 4, column_type: Fixed }]" in ported
    assert one_block.ref_cs.degree() == one_block.cs.degree() == 5
    assert one_block.ref_cs.blinding_factors() == one_block.cs.blinding_factors()


@pytest.mark.parametrize("column", range(FIXED_COLUMNS))
def test_fixed_column_equals_the_ports_keygen(one_block, column):  # noqa: F811
    """Column for column, the rows the keygen assembly sets (the table padded
    to the usable rows) and the compressed selectors' values."""
    a = one_block.assembly
    ported = [{r: v.evaluate(bn254.R) for r, v in col.items()} for col in a.fixed]
    ported += [{r: int(v) for r, v in enumerate(sv) if v} for sv in one_block.selector_columns]
    assert len(ported) == len(one_block.ref_fixed) == FIXED_COLUMNS
    assert one_block.ref_fixed[column] == ported[column]
    assert ported[column]


def test_copies_give_the_ports_sigma(one_block):  # noqa: F811
    a = one_block.assembly
    n = 1 << K
    columns = [(c.kind, c.index) for c in a.permutation.columns]
    assert [(kind.lower(), i) for kind, i in columns] == one_block.ref_cs.permutation
    sigmas = keys.sigma_columns(K, one_block.ref_cs.permutation, one_block.ref_copies)
    w = bn254.omega(K)
    wpow = [1] * n
    for i in range(1, n):
        wpow[i] = wpow[i - 1] * w % bn254.R
    for c, mapping in enumerate(a.permutation.mapping):
        ported = [pow(bn254.DELTA, int(f) // n, bn254.R) * wpow[int(f) % n] % bn254.R
                  for f in mapping]
        assert ported == [sigmas[c][i] for i in range(n)], c


@pytest.mark.parametrize("size", [0, 3, 55, 1975])
def test_instance_equals_hashlib(sha256_cell, size):  # noqa: F811
    message = hashlib.shake_256(f"instance/{size}".encode()).digest(size)
    digest = hashlib.sha256(message).digest()
    words = [int.from_bytes(digest[4 * i:4 * i + 4], "big") for i in range(8)]
    want = [[h for w in words for h in (w & 0xFFFF, w >> 16)]]
    assert sha256_cell.reference_module().instance(sha256_cell.config, message) == want
    if size == 1975:
        _, instance = sha256_cell.circuit_module().prove_inputs(sha256_cell.config, message)
        assert instance == want


def test_the_mix_pads_to_the_configured_blocks(sha256_cell):  # noqa: F811
    config = sha256_cell.config
    assert config["blocks"] == 31 and sha256_cell.traffic["message_bytes"] == 1975
    message = traffic.message(sha256_cell.traffic, 2**40 + 1, 0)
    circuit, _ = sha256_cell.circuit_module().prove_inputs(config, message)
    assert len(circuit.blocks) == 31 and all(len(b) == 16 for b in circuit.blocks)
    tampered, _ = sha256_cell.circuit_module().prove_inputs(config, message, tamper=True)
    first = [b[0].value() for b in (circuit.blocks[0], tampered.blocks[0])]
    assert first[1] == (first[0] + 1) & 0xFFFFFFFF
    assert [v.value() for v in tampered.blocks[0][1:]] == [v.value() for v in circuit.blocks[0][1:]]


@pytest.mark.parametrize("size", [0, 55, 1911, 1976, 4096])
def test_a_message_of_other_blocks_raises(sha256_cell, size):  # noqa: F811
    """31 blocks hold 1912..1975 message bytes (with the 0x80 byte and the
    8-byte length); every other length pads to another count."""
    with pytest.raises(ValueError, match="blocks"):
        sha256_cell.circuit_module().prove_inputs(sha256_cell.config, bytes(size))


@pytest.mark.slow
@pytest.mark.parametrize("tamper", [False, True])
def test_mock_prover_on_31_blocks(sha256_cell, tamper, torch_threads):  # noqa: F811
    """The port's MockProver over the configuration's circuit of a fresh
    1975-byte message: no failure, and under the control only the instance
    copies fail."""
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.spec import BN254_FR

    message = traffic.message(sha256_cell.traffic, SEED, 0)
    circuit, instance = sha256_cell.circuit_module().prove_inputs(sha256_cell.config, message,
                                                                  tamper)
    prover = MockProver.run(BN254_FR, K, circuit, instance, device="cpu")
    failures = prover.verify(vectorized=True)
    if tamper:
        assert failures and {f.kind for f in failures} == {"Permutation"}
    else:
        assert failures == []
