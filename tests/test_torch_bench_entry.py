"""The port's entry points and what they need, against the JAX package.

- the radix-2 butterfly ``ops.ntt.ntt`` / ``intt`` equal JAX's at k = 1..6;
- ``curves.point.generator`` and ``is_identity`` equal JAX's on every curve;
- ``utils.profiling.print_report`` prints the JAX package's report lines;
- ``python -m halo2_tpu_torch.bench.full`` on the CPU at k=4 (``--device
  cpu``): every metric name present with a positive value, every proof it
  made verified (it raises otherwise), and nothing written outside the
  directory of ``--out``; the ``--trace`` leg (``prove_busy_share``) writes
  its trace under that directory too;
- ``entry.dryrun_full_proof`` on the CPU equals the pin
  ``tests/data/dryrun_proof_k6.hex``.

Tolerance: exact.
"""

import gzip
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.curves import point as jpoint
from halo2_tpu.curves.spec import ALL_CURVES as J_CURVES
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.fields.spec import BN254_FR as J_FR
from halo2_tpu.ops import ntt as jntt

from halo2_tpu_torch import entry
from halo2_tpu_torch.bench import full
from halo2_tpu_torch.curves import point
from halo2_tpu_torch.curves.spec import ALL_CURVES
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.fields.spec import BN254_FR
from halo2_tpu_torch.ops import ntt
from halo2_tpu_torch.utils import profiling

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _i64(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a).astype(np.int64)


@pytest.mark.parametrize("k", range(1, 7))
def test_butterfly_ntt_and_intt_equal_jax(k):
    spec, n = BN254_FR, 1 << k
    rs = np.random.default_rng(100 + k)
    vals = [int.from_bytes(rs.bytes(32), "little") % spec.p for _ in range(n)]
    omega = pow(spec.root_of_unity, 1 << (spec.s - k), spec.p)
    omega_inv = pow(omega, -1, spec.p)
    n_inv = pow(n, -1, spec.p)

    a = limb.from_ints(spec, vals, "cpu")
    out = ntt.ntt(spec, a, ntt.power_table(spec, omega, n // 2, "cpu"), k)
    back = ntt.intt(spec, out, ntt.power_table(spec, omega_inv, n // 2, "cpu"), k,
                    limb.from_int(spec, n_inv, "cpu"))

    ja = jnp.asarray(jlimb.from_ints(J_FR, vals))
    jout = jntt.ntt(J_FR, ja, jntt.power_table(J_FR, omega, n // 2), k)
    jback = jntt.intt(J_FR, jout, jntt.power_table(J_FR, omega_inv, n // 2), k,
                      jlimb.from_int(J_FR, n_inv))
    np.testing.assert_array_equal(_i64(out), _i64(jout))
    np.testing.assert_array_equal(_i64(back), _i64(jback))
    assert torch.equal(back, a)
    # the DFT itself, on the host: out[i] = sum_j a[j] * omega^(i*j)
    want = [sum(v * pow(omega, i * j, spec.p) for j, v in enumerate(vals)) % spec.p
            for i in range(n)]
    assert limb.to_ints(spec, out) == want


@pytest.mark.parametrize("curve", ALL_CURVES, ids=lambda c: c.name)
def test_generator_and_is_identity_equal_jax(curve):
    (jc,) = [c for c in J_CURVES if c.name == curve.name]
    for ours, theirs in zip(point.generator(curve, "cpu"), jpoint.generator(jc)):
        np.testing.assert_array_equal(_i64(ours), _i64(theirs))
    g = (curve.gx, curve.gy)
    pts = [g, None, g, None]
    got = point.is_identity(point.from_affine_ints(curve, pts, "cpu"))
    want = jpoint.is_identity(jpoint.from_affine_ints(jc, pts))
    assert got.tolist() == np.asarray(want).tolist() == [False, True, False, True]


def test_print_report(monkeypatch, capsys):
    monkeypatch.setenv("HALO2_TPU_PROFILE", "1")
    profiling.report(reset=True)
    for name in ("commit", "commit", "quotient"):
        with profiling.phase(name):
            pass
    profiling.print_report()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("-- halo2_tpu profile (") and lines[0].endswith("s total) --")
    assert len(lines) == 3
    assert lines[1].split()[1:] == ["2x", "commit"] and lines[2].split()[1:] == ["1x", "quotient"]
    assert profiling.report() == []  # printed and reset
    profiling.print_report()
    assert capsys.readouterr().out == ""


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_bench_full_cli_on_the_cpu(tmp_path):
    work, out_dir = tmp_path / "cwd", tmp_path / "out"
    work.mkdir()
    # the JAX package's records at the root, which the bench must never touch
    def records():
        return {f: os.stat(os.path.join(REPO, f)).st_mtime_ns for f in os.listdir(REPO)
                if f.startswith(("BENCH_", "PROFILE_k")) or f == "bench_out"}

    before = records()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("HALO2_TPU_PROFILE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "halo2_tpu_torch.bench.full", "4", "--device", "cpu",
         "--reps", "1", "--rate-k", "3", "--out", str(out_dir / "bench.json")],
        cwd=work, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    payload = json.loads((out_dir / "bench.json").read_text())
    assert (payload["backend"], payload["device"]) == ("cpu", "cpu")
    lines = {r["metric"]: r for r in payload["results"]}
    printed = [json.loads(s) for s in proc.stdout.splitlines() if s.startswith("{")]
    assert [r["metric"] for r in printed] == list(lines)
    names = {"msm_bn254_points_per_sec_k3", "ntt_bn254_points_per_sec_k3",
             "coset_ext_points_per_sec_k3", "keygen_wall_s_k4", "prove_wall_s_k4",
             "verify_wall_s_k4", "srs_write_wall_s_k4", "srs_read_wall_s_k4"}
    names |= {f"pk_{op}_wall_s_k4_{fmt}" for op in ("write", "read")
              for fmt in ("processed", "raw_bytes", "raw_bytes_unchecked")}
    assert set(lines) == names
    assert all(r["value"] > 0 for r in lines.values())
    for name in ("keygen", "prove", "verify"):
        r = lines[f"{name}_wall_s_k4"]
        assert (r["reps"], r["min"], r["samples"]) == (1, r["value"], [r["value"]])
    assert lines["prove_wall_s_k4"]["proof_bytes"] > 0
    assert _files(tmp_path) == ["out/bench.json", "out/srs_k4.bin"]
    assert records() == before


def test_trace_leg_writes_under_out(tmp_path):
    # the --trace leg on a few field products: on the CPU no kernel runs, so
    # the device-busy share is 0; the trace lands beside --out and nowhere else
    spec, out_dir = BN254_FR, tmp_path / "out"
    a = limb.from_ints(spec, list(range(1, 65)), "cpu")
    line = full.prove_busy_share(4, lambda: limb.fmul(spec, a, a), str(out_dir), "cpu")
    assert _files(tmp_path) == ["out/trace/prove_k4/trace.json.gz"]
    assert line["metric"] == "prove_device_busy_share_k4"
    assert line["value"] == line["kernel_s"] == 0.0 and line["wall_s"] > 0
    with gzip.open(out_dir / "trace" / "prove_k4" / "trace.json.gz", "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("cat") == "cpu_op" for ev in events)


def test_dryrun_full_proof_equals_the_pin():
    with open(os.path.join(HERE, "data", "dryrun_proof_k6.hex")) as f:
        expected = bytes.fromhex(f.read().strip())
    assert entry.dryrun_full_proof("cpu", log=lambda msg: None) == expected
