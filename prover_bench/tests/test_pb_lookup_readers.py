"""The readers of the prover's lookup spans over a canned phase report:
``lookup_s`` (the four lookup phases) and ``lookup_host_match_s`` (the host
matching inside the first), each None where its data is absent, as on a
circuit with no lookup or on a program that has no such span."""

import pytest

from prover_bench.harness import cell as cell_mod
from prover_bench.harness import layers

READERS = ("lookup_s", "lookup_host_match_s")
LEAST = {"seconds": 3e-6}
PHASES = {"lookup: compress + permute": 1.8, "lookup: host matching": 1.2,
          "lookup: grand product": 0.3, "lookup: permuted commits": 0.6,
          "lookup: product commits": 0.3, "witness synthesis (host)": 9.0}


def read(name, data):
    return cell_mod.metric_reader(name)(data)


def test_readers_of_the_phase_report():
    data = layers.LayerData(None, PHASES, 3, LEAST)
    assert read("lookup_s", data) == pytest.approx(1.0)  # (1.8 + 0.3 + 0.6 + 0.3) / 3
    assert read("lookup_host_match_s", data) == pytest.approx(0.4)
    assert read("lookup_host_match_s", data) <= read("lookup_s", data)


def test_the_parent_has_no_host_matching_span():
    """The parent's program times the lookup phases but not the matching."""
    phases = {k: v for k, v in PHASES.items() if k != "lookup: host matching"}
    data = layers.LayerData(None, phases, 3, LEAST)
    assert read("lookup_s", data) == pytest.approx(1.0)
    assert read("lookup_host_match_s", data) is None


@pytest.mark.parametrize("phases, proofs", [({"witness synthesis (host)": 6.0}, 3),
                                            (PHASES, 0), ({}, 0)])
def test_silent_without_a_lookup_or_a_timed_proof(phases, proofs):
    data = layers.LayerData(None, phases, proofs, LEAST)
    assert all(read(name, data) is None for name in READERS)
    entries = [m for m in cell_mod.load_json(f"{cell_mod.ROOT}/BENCHMARK.json")["per_layer"]
               if m["name"] in READERS]
    assert len(entries) == 2 and layers.read_all(entries, data) == {}
