"""The plain reference against the port, at a tiny k on the CPU: the same
constants, the same verifying key to the byte, every proof of a window
accepted, and each planted fault caught."""

import dataclasses

import pytest

from prover_bench import faults
from prover_bench.harness import check, traffic, yardstick
from prover_bench.reference import bn254, keys
from prover_bench.reference.transcript_blake2b import Reader


def test_constants_match_the_port():
    from halo2_tpu_torch.curves.spec import BN254_G1

    fr = BN254_G1.scalar
    assert (bn254.P, bn254.R, bn254.B, bn254.G1) == (BN254_G1.base.p, fr.p, BN254_G1.b,
                                                      (BN254_G1.gx, BN254_G1.gy))
    assert bn254.ROOT_OF_UNITY == fr.root_of_unity and bn254.DELTA == fr.delta
    assert bn254.omega(16) == pow(fr.root_of_unity, 1 << (fr.s - 16), fr.p)
    wide = bytes(range(64))
    assert int.from_bytes(wide, "little") % bn254.R == fr.from_bytes_wide(wide)


def test_group_law():
    g2 = bn254.add(bn254.G1, bn254.G1)
    assert g2 == bn254.mul(bn254.G1, 2)
    assert (g2[1] ** 2 - g2[0] ** 3 - bn254.B) % bn254.P == 0
    assert bn254.add(g2, (g2[0], bn254.P - g2[1])) is None
    assert bn254.decompress(bytes(32)) is None
    assert bn254.lincomb([(3, bn254.G1), (bn254.R - 1, g2)]) == bn254.G1
    assert bn254.mul(bn254.G1, bn254.R) is None


def test_toxic_waste_matches_the_program_setup(proved):
    cell, prover, _, _ = proved
    from halo2_tpu_torch.poly.kzg import ParamsKZG

    fr = prover.curve.scalar
    assert keys.toxic_waste(traffic.srs_seed(prover.seed)) == ParamsKZG._toxic_waste(
        fr.p, traffic.srs_seed(prover.seed))


def test_verifying_key_equals_the_ports(proved):
    cell, prover, _, _ = proved
    from halo2_tpu_torch.plonk.rust_debug import pinned_vk_debug

    _, rvk, _ = check.reference_vk(cell, prover.seed)
    ported = pinned_vk_debug(prover.vk, bn254.P, bn254.R, alternate=False)
    assert rvk.debug() == ported
    assert rvk.repr == prover.vk.transcript_repr
    assert check.vk_mismatches(prover.vk_data(), rvk) == 0


def test_window_of_two_proofs(proved):
    _, _, window, _ = proved
    n = len(window.proofs)
    assert n >= 2 and window.counted == n - 1  # the last was in flight at the close
    assert window.proofs[-2].end_s == window.last_end_s < window.proofs[-1].end_s
    assert [p.index for p in window.proofs] == list(range(n))


def test_reference_accepts_every_proof(proved):
    cell, prover, window, _ = proved
    readings = check.check(cell, prover.seed, prover.vk_data(), window.proofs)
    assert readings == {"vk_mismatches": 0, "proofs_rejected": 0, "duplicate_proofs": 0}
    assert check.passed(readings, len(window.proofs))


def test_proof_length_counts_the_yardsticks_msms(proved):
    """Every commitment point of a proof is one MSM of the yardstick's count."""
    cell, _, window, _ = proved
    cs = cell.reference_module().constraint_system(cell.config)
    msms = sum(yardstick.proof_msms(cs, cell.config["multiopen"]).values())
    nsets = cs.permutation_sets()
    scalars = (len(cs.queries["advice"]) + len(cs.queries["fixed"]) + 1 + len(cs.permutation)
               + 3 * nsets - 1)
    assert len(window.proofs[0].proof) == 32 * (msms + scalars)
    assert msms == 12


def test_reference_rejects_each_fault(proved):
    cell, prover, window, _ = proved
    vk = prover.vk_data()
    flipped = [faults.Flip()(p.index, p) for p in window.proofs]
    assert check.check(cell, prover.seed, vk, flipped)["proofs_rejected"] == len(flipped)
    stale_fault = faults.Stale()
    stale = [stale_fault(p.index, p) for p in window.proofs]
    assert check.check(cell, prover.seed, vk, stale)["duplicate_proofs"] == len(stale) - 1
    bad_vk = dict(vk, repr=(vk["repr"] + 1) % bn254.R)
    assert check.check(cell, prover.seed, bad_vk, window.proofs)["vk_mismatches"] == 1
    truncated = [dataclasses.replace(window.proofs[0], proof=window.proofs[0].proof[:-32])]
    assert check.check(cell, prover.seed, vk, truncated)["proofs_rejected"] == 1


def test_control_is_rejected(proved):
    """The control: the circuit proved on a witness that breaks one gate."""
    cell, prover, _, _ = proved
    bad = prover.prove(7, tamper=True)
    assert check.check(cell, prover.seed, prover.vk_data(), [bad])["proofs_rejected"] == 1


def test_reader_refuses_unreduced_scalars():
    with pytest.raises(ValueError):
        Reader(bn254.R.to_bytes(32, "little")).read_scalar()
