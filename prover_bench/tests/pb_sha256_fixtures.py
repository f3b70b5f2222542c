"""Fixtures of the CPU tests of the configuration ``sha256-table16-kzg-gwc``
(``test_pb_sha256.py``): the port's keygen synthesis and the reference's
account of the same circuit, at k = 17 (the spread table's least) with a
one-block message made from a seed."""

import dataclasses
import hashlib

import pytest

from prover_bench.harness import cell as cell_mod

CELL = "sha256-gwc-k17-31blk"
K = 17
SEED = 2**33 + 17


@dataclasses.dataclass
class Accounts:
    cs: object  # the port's ConstraintSystem, selectors compressed
    assembly: object  # the port's KeygenAssembly
    selector_columns: list  # the port's compressed selector columns (numpy)
    ref_cs: object  # the reference's cs_selectors.SelectorCS
    ref_fixed: list  # [{row: value}]
    ref_copies: list  # [(column, row, column, row)]


@pytest.fixture(scope="session")
def sha256_cell():
    return cell_mod.load(CELL)


@pytest.fixture(scope="session")
def one_block(sha256_cell, torch_threads):
    """The port's ``KeygenAssembly`` of the configuration's circuit over a
    seeded 40-byte message (one block), its constraint system after selector
    compression and the compressed columns; the reference's constraint system,
    fixed columns and copies for one block."""
    from halo2_tpu_torch.plonk.circuit import ConstraintSystem
    from halo2_tpu_torch.plonk.keygen import KeygenAssembly, compress_selectors

    config = dict(sha256_cell.config, blocks=1)
    assert config["k"] == K
    message = hashlib.shake_256(f"one block/{SEED}".encode()).digest(40)
    circuit, _ = sha256_cell.circuit_module().prove_inputs(config, message)
    cs = ConstraintSystem()
    circuit_config = type(circuit).configure(cs)
    assembly = KeygenAssembly(K, cs, 1 << K)
    circuit.floor_planner.synthesize(assembly, circuit, circuit_config, list(cs.constants))
    selector_columns = compress_selectors(cs, assembly.selectors)
    ref = sha256_cell.reference_module()
    fixed, copies = ref.layout(config)
    return Accounts(cs, assembly, selector_columns, ref.constraint_system(config), fixed, copies)
