"""One-device benchmark sweep of the port: MSM, NTT and coset rates, and the
BenchPlonk keygen, prove and verify walls over KZG/GWC.

    python -m halo2_tpu_torch.bench.full [k_prove ...] [--prove-only]
        [--out PATH] [--trace] [--reps N] [--rate-k K]

Port of the one-device legs of ``bench_full.py`` (``bench_msm``,
``bench_ntt``, ``bench_coset_ext``, ``bench_prove``, ``main``), with its
metric names.  It runs on the card and raises without one.  One JSON line per
metric is printed, and all of them go to ``--out`` (default
``bench_out/BENCH_torch.json``) with ``backend`` and ``device`` (the card's
name and power limit as ``nvidia-smi`` gives them).  Everything it writes
lies in the directory of ``--out``: the SRS file, ``PROFILE_k{K}.txt`` and
the trace ``trace/prove_k{K}/``.

  * ``msm_bn254_points_per_sec_k{R}``: ``ops.msm.msm`` over 2^R points s^i*G
    (``batch_scalar_mul``) with scalars t^i, R = ``--rate-k`` (16); each rate
    is measured over ``--reps`` (MSM), 4 x ``--reps`` (NTT) or 2 x ``--reps``
    (coset) calls after one warm-up, host clock fenced by a synchronize;
  * ``ntt_bn254_points_per_sec_k{R}``: the radix-2 butterfly ``ops.ntt.ntt``;
  * ``coset_ext_points_per_sec_k{R}``: ``EvaluationDomain.coeff_to_extended``
    (degree-3 gate, so 2^(R+1) extended points), counted in extended points;
  * ``{keygen,prove,verify}_wall_s_k{K}`` for each ``k_prove`` (default 14,
    16): ``BenchPlonkCircuit`` (the reference's benches/plonk.rs workload),
    KZG with GWC and a Blake2b transcript.  ``value`` is the median of
    ``--reps`` (5) warm runs, each after one run that is not counted and
    fenced by ``torch.cuda.synchronize``; ``min`` and ``samples`` are in the
    same line.  Every proof made must verify.  The prove line carries the
    leg's peak device memory;
  * ``{srs,pk}_{write,read}_wall_s_k{K}``: the SRS (the device
    ``ParamsKZG.setup``, whose toxic waste is dropped by a RawBytes write and
    read, so verify runs the real pairing) and the proving key, in each
    ``SerdeFormat``, one run each;
  * with ``--trace``, ``prove_device_busy_share_k{K}``: one more warm prove
    under ``utils.profiling.device_trace``, written to ``trace/prove_k{K}``
    beside ``--out``; the device time of its kernels, copies and fills over
    its wall.

``vs_baseline`` divides by the JAX bench's CPU estimates (BASELINE.md: the
reference publishes no numbers), as that bench does.  ``HALO2_TPU_PROFILE=1``
prints the phase report of one more warm prove and writes it to
``PROFILE_k{K}.txt`` beside ``--out``.  ``--device cpu`` runs the same code
on the CPU (the plain kernel versions) for tests.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import sys
import time

import torch

from ..circuit import Value
from ..curves.point import Point, batch_normalize, generator
from ..curves.spec import BN254_G1
from ..fields import limb
from ..fields.spec import BN254_FR, NLIMBS
from ..ops import ntt as ntt_ops
from ..ops.msm import msm
from ..ops.scalar_mul import batch_scalar_mul
from ..poly.domain import EvaluationDomain
from ..poly.polynomial import COEFF, Poly
from ..utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join("bench_out", "BENCH_torch.json")

CPU_MSM_BASELINE = 1.0e6  # pts/s, BASELINE.md estimate for best_multiexp
CPU_NTT_BASELINE = 2.0e7  # pts/s, typical multicore best_fft at 2^16
CPU_PROVE_K14_BASELINE = 4.0  # s, BASELINE.md's extrapolated plonk-prover k=14 (8-core host)

MSM_S = 0x2F39C57A1F6BC5E7D5A8E2B1C4D3F6A7B8C9D0E1F2A3B4C5D6E7F8091A2B3C4
MSM_T = 0x1D2C3B4A5968778695A4B3C2D1E0F1E2D3C4B5A69788796A5B4C3D2E1F0A1B2


def emit(metric: str, value: float, unit: str, vs: float, **extra) -> dict:
    line = {"metric": metric, "value": value, "unit": unit, "vs_baseline": vs, **extra}
    print(json.dumps(line), flush=True)
    return line


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def on_device(device, *tensors) -> None:
    """Raise unless every timed tensor lies on ``device``."""
    want = torch.device(device).type
    for t in tensors:
        if t.device.type != want:
            raise RuntimeError(f"bench: a timed tensor is on {t.device}, not {want}")


def timed(fn, device):
    """(fn(), its fenced wall in seconds)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def warm_walls(fn, reps: int, device):
    """One uncounted run, then ``reps`` fenced walls; (last output, walls)."""
    out, _ = timed(fn, device)
    walls = []
    for _ in range(reps):
        out, wall = timed(fn, device)
        walls.append(wall)
    return out, walls


def wall_line(metric: str, walls: list, vs: float, **extra) -> dict:
    return emit(metric, statistics.median(walls), "s", vs, min=min(walls), reps=len(walls),
                samples=walls, **extra)


def rate(n_per_call: int, fn, reps: int, device) -> float:
    """Points per second of ``reps`` back-to-back calls after a warm-up."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(device)
    del out
    return n_per_call * reps / (time.perf_counter() - t0)


def msm_operands(k: int, device):
    """2^k bases s^i * G (one batch_scalar_mul, normalized) and scalars t^i."""
    curve = BN254_G1
    fr, n = curve.scalar, 1 << k
    gpt = generator(curve, device)
    g_broad = Point(*(c.reshape(NLIMBS, 1).expand(NLIMBS, n).contiguous() for c in gpt))
    s_pows = ntt_ops.power_table(fr, MSM_S % fr.p, n, device)
    points = batch_normalize(curve, batch_scalar_mul(curve, s_pows, g_broad))
    return ntt_ops.power_table(fr, MSM_T % fr.p, n, device), points


def bench_msm(k: int = 16, reps: int = 5, device="cuda") -> dict:
    scalars, points = msm_operands(k, device)
    on_device(device, scalars, *points)
    r = rate(1 << k, lambda: msm(BN254_G1, scalars, points), reps, device)
    return emit(f"msm_bn254_points_per_sec_k{k}", r, "points/sec", r / CPU_MSM_BASELINE)


def bench_ntt(k: int = 16, reps: int = 20, device="cuda") -> dict:
    spec, n = BN254_FR, 1 << k
    omega = pow(spec.root_of_unity, 1 << (spec.s - k), spec.p)
    tw = ntt_ops.power_table(spec, omega, n // 2, device)
    vals = limb.from_ints(spec, [(i * 7 + 3) % spec.p for i in range(n)], device)
    on_device(device, tw, vals)
    r = rate(n, lambda: ntt_ops.ntt(spec, vals, tw, k), reps, device)
    return emit(f"ntt_bn254_points_per_sec_k{k}", r, "points/sec", r / CPU_NTT_BASELINE)


def bench_coset_ext(k: int = 16, reps: int = 10, device="cuda") -> dict:
    """coeff_to_extended: zeta power distribution, pad and extended NTT, the
    prover's hot transform (reference domain.rs:327-351)."""
    spec = BN254_FR
    domain = EvaluationDomain(spec, 3, k, device)  # degree-3 gate: extended_k = k + 1
    vals = limb.from_ints(spec, [(i * 11 + 5) % spec.p for i in range(1 << k)], device)
    on_device(device, vals)
    r = rate(domain.extended_len, lambda: domain.coeff_to_extended(Poly(vals, COEFF)).values,
             reps, device)
    return emit(f"coset_ext_points_per_sec_k{k}", r, "points/sec", r / CPU_NTT_BASELINE)


def bench_srs(k: int, out_dir: str, device):
    """The device SRS, its toxic waste dropped through a RawBytes write and
    read under ``out_dir``; (params, metric lines)."""
    from ..plonk.serde import SerdeFormat
    from ..poly.kzg import ParamsKZG

    path = os.path.join(out_dir, f"srs_k{k}.bin")
    params, setup_s = timed(lambda: ParamsKZG.setup(k, seed=b"bench-prove", device=device), device)
    print(f"[bench] device SRS k={k}: {setup_s:.3f} s", flush=True)
    _, write_s = timed(lambda: params.write(path, SerdeFormat.RAW_BYTES), device)
    params, read_s = timed(lambda: ParamsKZG.read(path, SerdeFormat.RAW_BYTES, device), device)
    assert params.s is None  # verify runs the real pairing
    return params, [emit(f"srs_write_wall_s_k{k}", write_s, "s", 0.0, bytes=os.path.getsize(path)),
                    emit(f"srs_read_wall_s_k{k}", read_s, "s", 0.0)]


def device_busy(trace_path: str) -> dict:
    """Device time in a Chrome trace: the kernels' and the copies' and
    fills' summed durations, in seconds."""
    with gzip.open(trace_path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    busy = {"kernel": 0.0, "gpu_memcpy": 0.0, "gpu_memset": 0.0}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in busy:
            busy[ev["cat"]] += ev.get("dur", 0) * 1e-6
    return busy


def prove_busy_share(k: int, prove, out_dir: str, device) -> dict:
    """One more ``prove()`` under ``device_trace``, written to
    ``out_dir/trace/prove_k{k}``; its device time over its wall."""
    logdir = os.path.join(out_dir, "trace", f"prove_k{k}")
    with profiling.device_trace(logdir):
        _, wall = timed(prove, device)
    busy = device_busy(os.path.join(logdir, profiling.TRACE_FILE))
    return emit(f"prove_device_busy_share_k{k}", sum(busy.values()) / wall,
                "fraction of the prove wall", 0.0, wall_s=wall, kernel_s=busy["kernel"],
                memcpy_s=busy["gpu_memcpy"], memset_s=busy["gpu_memset"])


def bench_prove(k: int, reps: int, out_dir: str, device, trace: bool = False) -> list:
    """keygen, prove and verify walls of BenchPlonkCircuit at k, KZG-GWC +
    Blake2b on BN254, and the serde walls of the SRS and the proving key."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_circuits import BenchPlonkCircuit

    from ..plonk import create_proof, keygen_pk, keygen_vk, serde, verify_proof
    from ..poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from ..transcript import Blake2bTranscript
    from ..utils.rng import FieldRng

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spec = BN254_G1.scalar
    params, out = bench_srs(k, out_dir, device)
    on_device(device, *params.g, *params.g_lagrange)
    circuit = BenchPlonkCircuit(k, Value.known(0x2B3C4D5E6F | k))

    def keygen():
        vk = keygen_vk(params, circuit.without_witnesses())
        return vk, keygen_pk(params, vk, circuit.without_witnesses())

    def prove():
        return create_proof(params, pk, [circuit], [[]], FieldRng(spec, b"bench-prove-rng"),
                            Blake2bTranscript(BN254_G1), gwc_create_proof)

    def verify():
        if verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, proof),
                        gwc_verify_proof) is not True:
            raise AssertionError(f"bench: the k={k} proof was rejected")
        return True

    (vk, pk), keygen_walls = warm_walls(keygen, reps, device)
    print(f"[bench] keygen k={k}: {statistics.median(keygen_walls):.3f} s", flush=True)
    on_device(device, pk.l0.values, *(p.values for p in pk.fixed_cosets))
    out.append(wall_line(f"keygen_wall_s_k{k}", keygen_walls, 0.0))

    for fmt in serde.SerdeFormat:
        data, write_s = timed(lambda: serde.pk_to_bytes(pk, BN254_G1, fmt), device)
        back, read_s = timed(lambda: serde.pk_from_bytes(data, BN254_G1, BenchPlonkCircuit,
                                                          fmt=fmt, device=device), device)
        if back.vk.transcript_repr != vk.transcript_repr:
            raise AssertionError(f"bench: the k={k} pk read back in {fmt.name} has another vk")
        name = fmt.name.lower()
        out.append(emit(f"pk_write_wall_s_k{k}_{name}", write_s, "s", 0.0, bytes=len(data)))
        out.append(emit(f"pk_read_wall_s_k{k}_{name}", read_s, "s", 0.0))
        del data, back

    profiling.report(reset=True)
    proof, prove_walls = warm_walls(prove, reps, device)
    verify()
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.device(device).type == "cuda" else None)
    scale = 2.0 ** (k - 14)  # the JAX bench's linear extrapolation of its CPU estimate
    out.append(wall_line(f"prove_wall_s_k{k}", prove_walls,
                         CPU_PROVE_K14_BASELINE * scale / statistics.median(prove_walls),
                         proof_bytes=len(proof), peak_device_memory_gib=peak))
    _, verify_walls = warm_walls(verify, reps, device)
    out.append(wall_line(f"verify_wall_s_k{k}", verify_walls, 0.0))

    if profiling.enabled():
        profiling.report(reset=True)
        _, wall = timed(prove, device)
        rows = profiling.report(reset=False)
        with open(os.path.join(out_dir, f"PROFILE_k{k}.txt"), "w") as f:
            f.write(f"halo2_tpu_torch warm prove profile, k={k}, device={device}, "
                    f"wall={wall:.3f}s (phases cover {sum(t for _, _, t in rows):.3f}s)\n")
            for name, calls, secs in rows:
                f.write(f"{secs:8.3f}s  {calls:4d}x  {name}\n")
        profiling.print_report()
    if trace:
        out.append(prove_busy_share(k, prove, out_dir, device))
    return out


def card_name() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("k_prove", nargs="*", type=int, help="prove legs' k (default: 14 16)")
    ap.add_argument("--prove-only", action="store_true", help="skip the MSM / NTT / coset rates")
    ap.add_argument("--out", default=DEFAULT_OUT, help=f"results file (default {DEFAULT_OUT})")
    ap.add_argument("--trace", action="store_true",
                    help="trace one more warm prove per k into trace/ beside --out")
    ap.add_argument("--reps", type=int, default=5,
                    help="warm runs per wall, and per rate x 1 / 4 / 2 (default 5)")
    ap.add_argument("--rate-k", type=int, default=16, help="log2 size of the rate legs (16)")
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA card; torch.cuda.is_available() is False")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    where = card_name() if device.type == "cuda" else "cpu"
    print(where, flush=True)

    results = []
    if not args.prove_only:
        # the JAX bench's 5 / 20 / 10 calls at --reps 5
        results.append(bench_msm(args.rate_k, args.reps, device))
        results.append(bench_ntt(args.rate_k, 4 * args.reps, device))
        results.append(bench_coset_ext(args.rate_k, 2 * args.reps, device))
    for k in args.k_prove or [14, 16]:
        results.extend(bench_prove(k, args.reps, out_dir, device, args.trace))
    payload = {
        "results": results,
        "backend": device.type,
        "device": where,
        "torch": torch.__version__,
        "notes": "walls: median of warm, synchronize-fenced runs (min and samples beside); "
                 "vs_baseline denominators are the JAX bench's CPU estimates (BASELINE.md).",
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return payload


if __name__ == "__main__":
    main()
