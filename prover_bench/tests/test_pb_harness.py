"""The harness on the CPU: the files found by name and within the
benchmark's contract, the metric readers over a canned trace, the shape of
a run's last line, the run with each fault planted, no card, and the no-JAX
check."""

import gzip
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from prover_bench import faults, run
from prover_bench.harness import cell as cell_mod
from prover_bench.harness import layers, trace, traffic, yardstick

ROOT = cell_mod.ROOT
BENCH = cell_mod.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# -- BENCHMARK.json and the files it names -----------------------------------

def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 24 * 180 + 1200 <= 43200
    assert BENCH["paths"] == ["prover_bench"] and len(BENCH["command"]) <= 32
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = cell_mod.load(name)
    traffic.check(cell.traffic)
    w = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cfg = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cfg["file"] == f"prover_bench/configs/{w['config']}.json"
    assert all(k in cell.config for k in cfg["reduced"])
    for fn in ("blank", "prove_inputs"):
        assert callable(getattr(cell.circuit_module(), fn))
    ref = cell.reference_module()
    for fn in ("constraint_system", "layout", "instance"):
        assert callable(getattr(ref, fn))
    assert sum(yardstick.proof_msms(ref.constraint_system(cell.config),
                                    cell.config["multiopen"]).values()) > 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "prove_s"}
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(cell_mod.metric_reader(metric))


def test_files_under_paths_have_legal_names():
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "prover_bench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            assert NAME.match(f), os.path.join(dirpath, f)


def test_reference_imports_nothing_of_the_port():
    """The reference imports neither torch, nor the port, nor the harness."""
    ref_dir = os.path.join(ROOT, "prover_bench", "reference")
    for dirpath, _, files in os.walk(ref_dir):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for bad in ("torch", "jax", "halo2_tpu", "prover_bench.harness",
                            "prover_bench.configs"):
                    assert not re.search(rf"^\s*(from|import)\s+{re.escape(bad)}\b", text, re.M), \
                        (f, bad)


# -- the readers over a canned trace and phase report ------------------------

def canned_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "ec_window_fold_kernel(short)", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "ec_horner_kernel(int)", "ts": 250, "dur": 150},
        {"ph": "X", "cat": "kernel", "name": "mont_mul_kernel", "ts": 500, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 700, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::zeros", "ts": 800, "dur": 190},
        {"ph": "X", "cat": "user_annotation", "name": "witness synthesis (host)", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 300},
    ]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    return trace.reduce(trace.read_events(str(path)))


def test_trace_reduction(tmp_path):
    t = canned_trace(tmp_path)
    assert t.window_s == pytest.approx(1e-3)
    assert len(t.kernels()) == 3
    assert trace.busy_s(t) == pytest.approx(450e-6)
    assert trace.idle_gaps(t) == [(0, 100), (400, 500), (600, 700), (750, 1000)]
    b = trace.breakdown(t)
    assert b["idle_gaps"][0] == ["outside the phases: torch op aten::zeros",
                                 pytest.approx(250e-6)]
    labels = {label for label, _ in b["idle_gaps"]}
    assert "phase witness synthesis (host): host Python" in labels
    assert "outside the phases: host Python" in labels
    assert b["device_ops"][0][0].startswith("ec_window_fold")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_over_the_canned_trace(tmp_path):
    t = canned_trace(tmp_path)
    least = {"seconds": 3e-6}
    data = layers.LayerData(t, {"witness synthesis (host)": 6.0, "quotient: evaluate_h": 0.3,
                                "multiopen": 0.6}, 3, least, 4.5)
    got = {m["name"]: cell_mod.metric_reader(m["name"])(data) for m in BENCH["per_layer"]}
    assert got["synthesis_s"] == pytest.approx(2.0)
    assert got["quotient_s"] == pytest.approx(0.1)
    assert got["multiopen_s"] == pytest.approx(0.2)
    assert got["msm_device_ms"] == pytest.approx(0.3)  # the union of the fold and the Horner
    assert got["msm_roofline"] == pytest.approx(1.0)
    assert got["device_idle"] == pytest.approx(55.0)
    assert got["launches_per_proof"] == 3.0
    assert got["keygen_wall_s"] == 4.5
    empty = layers.LayerData(None, {}, 0, least)
    assert all(cell_mod.metric_reader(m["name"])(empty) is None for m in BENCH["per_layer"])
    out = layers.read_all(BENCH["per_layer"], empty)
    assert out == {}


def test_yardstick_counts():
    cell = cell_mod.load("benchplonk-gwc-k16")
    cs = cell.reference_module().constraint_system(cell.config)
    msms = yardstick.proof_msms(cs, cell.config["multiopen"])
    assert msms == {"lagrange": 6, "monomial": 6}
    least = yardstick.msm_least(16, msms)
    assert least["bound"] == "compute"
    assert least["seconds"] == pytest.approx(least["ops"] / yardstick.PEAK_IMAD_PER_S)


# -- runs of the harness on the CPU ------------------------------------------

class Args:
    def __init__(self, workload, seed, seconds, trace_):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace_


def test_last_line_shape(window_s, tiny_cells):
    res = run.run(Args("benchplonk-gwc-k16", 2**32 + 77, window_s, 0), device="cpu")
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 2 and res["failed"] == 0
    assert res["window"]["proofs_counted"] == res["attempted"] - 1
    assert set(res["metrics"]) == {"prove_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert res["checks"] == {n: {"value": 0, "limit": 0} for n in
                             ("vk_mismatches", "proofs_rejected", "duplicate_proofs")}
    json.loads(json.dumps(res))


@pytest.mark.parametrize("fault", ["tamper", "flip", "stale"])
def test_run_with_a_fault_is_not_correct(fault, window_s, tiny_cells):
    """A whole run on the CPU with the timed path broken underneath."""
    res = run.run(Args("benchplonk-gwc-k16", 2**32 + 78, window_s, 0), device="cpu",
                  fault=faults.FAULTS[fault]())
    assert res["correct"] is False
    key = "duplicate_proofs" if fault == "stale" else "proofs_rejected"
    assert res["checks"][key]["value"] > 0


class StubProver:
    """Stands in for the prover in the traced window: a few torch ops inside
    the synthesis phase, so that the profiler and the phase timers have
    something to record."""

    def __init__(self):
        import torch

        self.device = torch.device("cpu")

    def prove(self, index, tamper=False):
        import torch

        from halo2_tpu_torch.utils import profiling
        from prover_bench.harness.prover import Proof

        with profiling.phase("witness synthesis (host)"):
            x = torch.arange(1000)
            for _ in range(20):
                x = (x * 3 + 1) % 1000003
        return Proof(index, b"", [], bytes([index % 256]) * 32, 0.0)


def test_traced_window_profiles_the_first_proof_and_times_the_rest():
    from prover_bench.harness.prover import run_window

    win = run_window(StubProver(), 5.0, trace=True)  # the profiler takes seconds to start
    assert len(win.proofs) >= 3 and win.phase_proofs == len(win.proofs) - 1
    assert win.trace is not None and win.trace.window_s > 0
    assert any(name.startswith("aten::") for name, _, _ in win.trace.host_ops)
    assert win.trace.device == []  # no card: the device readers stay silent
    assert win.phases["witness synthesis (host)"] > 0
    assert [name for name, _, _ in win.trace.phases] == ["witness synthesis (host)"]
    assert "HALO2_TPU_PROFILE" not in os.environ


def run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "prover_bench/run.py", "--workload", "benchplonk-gwc-k16", "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_cli_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_cli_fails_with_only_the_benchmark(tmp_path):
    """A directory with only BENCHMARK.json and prover_bench/ has no port:
    the run fails and prints no result, even where a card is found."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "prover_bench"), tmp_path / "prover_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from prover_bench import run; "
            "run.card = lambda chips: {'platform': 'gpu', 'kind': 'stub', 'count': chips}; "
            "sys.exit(run.main(['--workload', 'benchplonk-gwc-k16', '--seed', '5', "
            "'--seconds', '1', '--trace', '0']))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "halo2_tpu_torch" in out.stderr


# -- the no-JAX check ----------------------------------------------------------

def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules({"halo2_tpu_torch", "halo2_tpu_torch.plonk", "jaxtyping",
                                  "flaxen", "prover_bench"}) == []
    assert run.forbidden_modules({"jax", "jaxlib.xla_client", "flax.linen", "halo2_tpu.plonk",
                                  "halo2_tpu_torch"}) == ["flax.linen", "halo2_tpu.plonk", "jax",
                                                          "jaxlib.xla_client"]


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from prover_bench import run; "
            "from prover_bench.harness import cell, check, prover, layers; "
            "c = cell.load('benchplonk-gwc-k16'); c.circuit_module(); c.reference_module(); "
            "import halo2_tpu_torch.plonk.prover, halo2_tpu_torch.poly.kzg; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
