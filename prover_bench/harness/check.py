"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``prover_bench/reference``) works out the verifying key from the
configuration's own account of its circuit and the SRS's secret (hashed from
the same seed bytes the program's set-up was given), and verifies every
proof the window made, the one in flight at its close included, for the
instance the reference derives from the proof's message.  Three numbers,
each with the limit 0 (an exact comparison):

  * ``vk_mismatches``: fixed commitments, permutation commitments and the
    key's hash that differ from the reference's, plus any difference in
    their counts;
  * ``proofs_rejected``: proofs the reference's verifier rejects;
  * ``duplicate_proofs``: proofs equal to an earlier one of the run (each
    proof has fresh blinds, so two equal proofs mean a stale answer).

``correct`` needs all three at 0 and at least one proof.
"""

from __future__ import annotations

import importlib

from prover_bench.reference import keys, verifier

from . import traffic

LIMITS = {"vk_mismatches": 0, "proofs_rejected": 0, "duplicate_proofs": 0}


def reference_vk(cell, seed: int):
    ref = cell.reference_module()
    cfg = cell.config
    cs = ref.constraint_system(cfg)
    fixed, copies = ref.layout(cfg)
    s = keys.toxic_waste(traffic.srs_seed(seed))
    return ref, keys.verifying_key(cs, cfg["k"], fixed, copies, s), s


def vk_mismatches(program: dict, rvk) -> int:
    bad = int(program["repr"] != rvk.repr)
    for mine, theirs in ((program["fixed"], rvk.fixed), (program["permutation"], rvk.permutation)):
        mine = [tuple(p) if p is not None else None for p in mine]
        bad += abs(len(mine) - len(theirs)) + sum(a != b for a, b in zip(mine, theirs))
    return bad


def check(cell, seed: int, program_vk: dict, proofs: list) -> dict:
    """{check name: reading} over the window's ``proofs`` (prover.Proof)."""
    ref, rvk, s = reference_vk(cell, seed)
    reader = importlib.import_module(
        f"prover_bench.reference.transcript_{cell.config['transcript']}").Reader
    multiopen = importlib.import_module(
        f"prover_bench.reference.multiopen_{cell.config['multiopen']}").verify
    rejected = sum(
        not verifier.verify(rvk, ref.instance(cell.config, p.message), p.proof, s, reader, multiopen)
        for p in proofs)
    blobs = [p.proof for p in proofs]
    return {"vk_mismatches": vk_mismatches(program_vk, rvk),
            "proofs_rejected": rejected,
            "duplicate_proofs": len(blobs) - len(set(blobs))}


def passed(readings: dict, proofs: int) -> bool:
    return proofs > 0 and all(readings[name] <= limit for name, limit in LIMITS.items())
