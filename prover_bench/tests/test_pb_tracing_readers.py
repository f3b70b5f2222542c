"""The readers of the program's own spans over a canned trace and a canned
phase report: ``random_poly_s``, ``synthesis_shape_s``, ``commit_s`` and
``host_syncs_per_proof``; each None where its data is absent, as on a
program that has no such span."""

import gzip
import json

import pytest

from prover_bench.harness import cell as cell_mod
from prover_bench.harness import layers, trace

READERS = ("random_poly_s", "synthesis_shape_s", "commit_s", "host_syncs_per_proof")
LEAST = {"seconds": 3e-6}


def canned_trace(tmp_path, pulls: int):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "vanishing: random poly", "ts": 100,
           "dur": 300},
          {"ph": "X", "cat": "kernel", "name": "ec_window_fold_kernel", "ts": 420, "dur": 50}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "limb: device to host",
            "ts": 500 + 10 * i, "dur": 5} for i in range(pulls)]
    ev.append({"ph": "X", "cat": "user_annotation", "name": "limb: device to host",
               "ts": 2000, "dur": 5})  # after the proof: not counted
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    return trace.reduce(trace.read_events(str(path)))


def read(name, data):
    return cell_mod.metric_reader(name)(data)


def test_readers_of_the_phase_report():
    data = layers.LayerData(None, {"vanishing: random poly": 0.9, "synthesis: region shapes": 3.0,
                                   "commit: msm": 0.36, "witness synthesis (host)": 9.0}, 3, LEAST)
    assert read("random_poly_s", data) == pytest.approx(0.3)
    assert read("synthesis_shape_s", data) == pytest.approx(1.0)
    assert read("commit_s", data) == pytest.approx(0.12)
    assert read("host_syncs_per_proof", data) is None  # no profiled proof


@pytest.mark.parametrize("pulls", [1, 16])
def test_host_syncs_count_the_pulls_in_the_profiled_proof(tmp_path, pulls):
    data = layers.LayerData(canned_trace(tmp_path, pulls), {}, 0, LEAST)
    assert read("host_syncs_per_proof", data) == float(pulls)
    assert all(read(name, data) is None for name in READERS[:3])  # no timed proof


def test_silent_where_the_program_has_no_such_span(tmp_path):
    """The parent's traced run: other phases, no pull span."""
    data = layers.LayerData(canned_trace(tmp_path, 0), {"witness synthesis (host)": 6.0}, 3,
                            LEAST)
    assert all(read(name, data) is None for name in READERS)
    empty = layers.LayerData(None, {}, 0, LEAST)
    assert all(read(name, empty) is None for name in READERS)
    entries = [m for m in cell_mod.load_json(f"{cell_mod.ROOT}/BENCHMARK.json")["per_layer"]
               if m["name"] in READERS]
    assert len(entries) == 4 and layers.read_all(entries, empty) == {}
