#!/usr/bin/env python3
"""Smoke run of the halo2_tpu_torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each, every failure raising (non-zero exit, no result line):

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi``) and the torch / CUDA versions;
2. build the CUDA kernels from ``halo2_tpu_torch/csrc`` (nvcc, sm_90a);
3. K1 (Montgomery multiply) against its plain torch version on the card,
   n = 2^16 BN254 Fr and Fq elements including 0, 1 and p-1: exact equality;
4. K2 / K3 (complete EC add / double) against their plain versions, n = 2^14
   BN254 G1 points including the identity, P+P and P+(-P): exact equality,
   projective limbs and affine coordinates;
5. the mul-gate circuit at k=6: the proof bytes must equal the pinned
   ``tests/data/dryrun_proof_k6.hex``; verify accepts, and rejects a wrong
   instance;
6. the main path at full size: ``BenchPlonkCircuit`` at k=14 (the reference's
   benches/plonk.rs workload), keygen_vk -> keygen_pk -> create_proof ->
   verify_proof through the real pairing; a proof with one flipped byte is
   rejected.  The kernels' launch counters are zeroed just before and read
   just after this phase; K1, K2 and K3 must each be > 0;
7. K4 (lane-tiled Montgomery multiply) against its plain version and against
   K1, n = 4099, 2^18 (the roofline's chained width) and 2^16, BN254 Fr and
   Fq including 0, 1 and p-1: exact equality; then K1, K4, K2 and K3 on the
   roofline's own n = 2^22 operands (``roofline.share_operands``) against
   their plain versions, slice by slice: exact equality;
8. the roofline path: B1 (all three forms) and B2 exactly equal to their plain
   versions on the full (2048, 128) array at 2^10 and 2^16 steps, and 1024
   elements at 2^16 steps equal to a numpy loop on the host; then, with
   every launch counter zeroed just before and read just after,
   ``halo2_tpu_torch.bench.roofline.run()`` prints every roofline metric.
   K1, K4, B1 and B2 must each be launched (a CUDA graph's kernels count
   once per replay); a chained K1 or K4 output that differs from the plain
   chain or from the other's, a rate above 105% of its ceiling, a chained
   loop missing from the SASS, or a K1 instruction mix that differs from
   the model's constants raises.

Then one JSON line with every kernel's launches, error and times, and as the
last line ``{"ok": true, "device": {...}}``.  Times are CUDA-event times on
this card, kernel and plain version measured in turns in the same run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream, CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def random_field(spec, n: int, rs) -> list:
    """n canonical elements of the field from a numpy generator, with 0, 1 and
    p-1 in front."""
    raw = rs.integers(0, 1 << 63, size=(n, 5), dtype=np.int64)
    vals = [0, 1, spec.p - 1]
    for row in raw[: n - 3]:
        v = 0
        for w in row:
            v = (v << 63) | int(w)
        vals.append(v % spec.p)
    return vals


def phase_k1(torch, limb, mont_mul_mod, spec, rs, dev):
    n = 1 << 16
    a = limb.from_ints(spec, random_field(spec, n, rs), dev)
    b = limb.from_ints(spec, random_field(spec, n, rs)[::-1], dev)
    out = mont_mul_mod.mont_mul(spec, a, b)
    ref = mont_mul_mod.mont_mul_plain(spec, a, b)
    torch.cuda.synchronize()
    err = max_abs_err(out, ref)
    if err != 0 or not torch.equal(out, ref):
        raise AssertionError(f"K1 {spec.name}: kernel differs from plain (max |err| {err})")
    # spot check against Python ints
    r_inv = pow(spec.r, -1, spec.p)
    got = limb.limbs_np_to_ints(out[:, :8].cpu().numpy())
    xs = limb.limbs_np_to_ints(a[:, :8].cpu().numpy())
    ys = limb.limbs_np_to_ints(b[:, :8].cpu().numpy())
    if got != [x * y * r_inv % spec.p for x, y in zip(xs, ys)]:
        raise AssertionError(f"K1 {spec.name}: kernel differs from Python ints")
    ms = cuda_ms(lambda: mont_mul_mod.mont_mul(spec, a, b), 50)
    plain_ms = cuda_ms(lambda: mont_mul_mod.mont_mul_plain(spec, a, b), 5)
    ms2 = cuda_ms(lambda: mont_mul_mod.mont_mul(spec, a, b), 50)
    log(f"[3] K1 mont_mul {spec.name} n={n}: exact match; kernel {ms:.4f} / {ms2:.4f} ms, "
        f"plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms}


def random_g1_points(curve, n: int, rs) -> list:
    """n affine BN254 G1 points with seeded x (cofactor 1: every curve point
    is in the group); p = 3 mod 4, so sqrt is one pow."""
    p = curve.base.p
    pts = []
    for x in random_field(curve.base, 4 * n, rs)[3:]:
        rhs = (x * x * x + curve.b) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            pts.append((x, y))
            if len(pts) == n:
                return pts
    raise AssertionError("not enough curve points")


def phase_ec(torch, point_mod, ec, curve, rs, dev):
    n = 1 << 14
    aff = random_g1_points(curve, 2 * n, rs)
    p_aff, q_aff = aff[:n], aff[n:]
    p_aff[0] = None                               # identity + Q
    q_aff[1] = None                               # P + identity
    q_aff[2] = p_aff[2]                           # P + P
    q_aff[3] = (p_aff[3][0], curve.base.p - p_aff[3][1])  # P + (-P)
    q_aff[4] = None
    p_aff[4] = None                               # identity + identity
    # projective inputs with z != 1: double once through the plain version
    P, Q = (
        tuple(c.contiguous() for c in ec.ec_double_plain(curve, tuple(pt)))
        for pt in (point_mod.from_affine_ints(curve, a, dev) for a in (p_aff, q_aff))
    )
    results = {}
    for name, kern, plain, args in (
        ("ec_add", ec.ec_add, ec.ec_add_plain, (P, Q)),
        ("ec_double", ec.ec_double, ec.ec_double_plain, (P,)),
    ):
        out = kern(curve, *args)
        ref = plain(curve, *args)
        torch.cuda.synchronize()
        err = max(max_abs_err(o, r) for o, r in zip(out, ref))
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain (max |err| {err})")
        a_out = point_mod.to_affine_ints(curve, point_mod.Point(*out))
        a_ref = point_mod.to_affine_ints(curve, point_mod.Point(*ref))
        if a_out != a_ref:
            raise AssertionError(f"{name}: affine results differ")
        ms = cuda_ms(lambda: kern(curve, *args), 50)
        plain_ms = cuda_ms(lambda: plain(curve, *args), 3)
        ms2 = cuda_ms(lambda: kern(curve, *args), 50)
        results[name] = {"max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms}
        log(f"[4] K {name} n={n}: exact match (projective and affine); "
            f"kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.3f} ms")
    # the special cases, against host arithmetic
    from halo2_tpu_torch.curves import host

    added = point_mod.to_affine_ints(curve, point_mod.Point(*ec.ec_add(curve, P, Q)))
    for i in range(5):
        want = host.double(curve, host.add(curve, p_aff[i], q_aff[i]))
        if added[i] != want:
            raise AssertionError(f"ec_add special case {i}: {added[i]} != {want}")
    return results


def phase_k4(torch, limb, mont_mul_mod, spec, rs, dev):
    # 2^18 is the roofline's chained width; the timed operands are the last, 2^16
    for n in (4099, 1 << 18, 1 << 16):
        a = limb.from_ints(spec, random_field(spec, n, rs), dev)
        b = limb.from_ints(spec, random_field(spec, n, rs)[::-1], dev)
        out = mont_mul_mod.mont_mul_tiled(spec, a, b)
        ref = mont_mul_mod.mont_mul_plain(spec, a, b)
        k1 = mont_mul_mod.mont_mul(spec, a, b)
        torch.cuda.synchronize()
        err = max(max_abs_err(out, ref), max_abs_err(out, k1))
        if err != 0 or not torch.equal(out, ref) or not torch.equal(out, k1):
            raise AssertionError(f"K4 {spec.name} n={n}: kernel differs from plain or K1 "
                                 f"(max |err| {err})")
        r_inv = pow(spec.r, -1, spec.p)
        got = limb.limbs_np_to_ints(out[:, -8:].cpu().numpy())
        xs = limb.limbs_np_to_ints(a[:, -8:].cpu().numpy())
        ys = limb.limbs_np_to_ints(b[:, -8:].cpu().numpy())
        if got != [x * y * r_inv % spec.p for x, y in zip(xs, ys)]:
            raise AssertionError(f"K4 {spec.name} n={n}: ragged edge differs from Python ints")
    ms = cuda_ms(lambda: mont_mul_mod.mont_mul_tiled(spec, a, b), 50)
    k1_ms = cuda_ms(lambda: mont_mul_mod.mont_mul(spec, a, b), 50)
    plain_ms = cuda_ms(lambda: mont_mul_mod.mont_mul_plain(spec, a, b), 5)
    ms2 = cuda_ms(lambda: mont_mul_mod.mont_mul_tiled(spec, a, b), 50)
    log(f"[7] K4 mont_mul_tiled {spec.name} n=4099, 2^18, 2^16: exact match with plain and K1; "
        f"n=2^16 kernel {ms:.4f} / {ms2:.4f} ms, K1 {k1_ms:.4f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms, "k1_ms": k1_ms}


def phase_shares(torch, roofline, dev, step: int = 1 << 20):
    """The four field kernels on the operands the roofline's kernel_shares
    times at n = 2^22, each against its plain version in column slices."""
    for name, (kern, plain, args) in roofline.share_operands(dev).items():
        out = kern(*args)
        out = out if isinstance(out, tuple) else (out,)
        n = out[0].shape[1]
        err = 0
        for lo in range(0, n, step):
            cut = [tuple(c[:, lo:lo + step] for c in a) if isinstance(a, tuple)
                   else a[:, lo:lo + step] for a in args]
            ref = plain(*cut)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max([err] + [max_abs_err(o[:, lo:lo + step], r) for o, r in zip(out, ref)])
        if err != 0:
            raise AssertionError(f"{name} n={n}: kernel differs from plain (max |err| {err})")
        log(f"[7] {name} n={n} (the roofline's operands): exact match with plain")
        del out


def numpy_chain(name: str, x, iters: int):
    """The chains in numpy uint32 / uint64 arithmetic, which wraps as the card does."""
    x64, m32, s32 = x.astype(np.uint64), np.uint64(0xFFFFFFFF), np.uint64(32)
    y = x.copy()
    if name == "int_muladd":
        for _ in range(iters):
            y = y * x + x
        return y
    if name == "int_muladd_hi":
        for _ in range(iters):
            y = ((y.astype(np.uint64) * x64) >> s32).astype(np.uint32) + x
        return y
    if name == "int_muladd_wide":
        s = x64.copy()
        for _ in range(iters):
            s = (s & m32) * x64 + s
        return ((s & m32) ^ (s >> s32)).astype(np.uint32)
    for _ in range(iters):
        y = (y + x) & np.uint32(0xFFFF)
    return y


def phase_chains(torch, ic, rs, dev):
    x = rs.integers(0, 1 << 32, size=(2048, 128), dtype=np.uint64).astype(np.uint32)
    x[0, :4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    xt = torch.from_numpy(x.view(np.int32)).to(dev)
    idx = np.linspace(0, x.size - 1, 1024).astype(np.int64)
    chains = {
        "int_muladd": (lambda t, k: ic.int_muladd_chain(t, k),
                       lambda t, k: ic.int_muladd_plain(t, k)),
        "int_muladd_wide": (lambda t, k: ic.int_muladd_chain(t, k, "wide"),
                            lambda t, k: ic.int_muladd_plain(t, k, "wide")),
        "int_muladd_hi": (lambda t, k: ic.int_muladd_chain(t, k, "hi"),
                          lambda t, k: ic.int_muladd_plain(t, k, "hi")),
        "int_addmask": (ic.int_addmask_chain, ic.int_addmask_plain),
    }
    results = {}
    for name, (kern, plain) in chains.items():
        out = kern(xt, 1 << 10)
        ref = plain(xt, 1 << 10)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        if err != 0 or not torch.equal(out, ref):
            raise AssertionError(f"{name}: kernel differs from plain at 2^10 steps "
                                 f"(max |err| {err})")
        out = kern(xt, 1 << 16)
        if not torch.equal(out, plain(xt, 1 << 16)):
            raise AssertionError(f"{name}: kernel differs from plain at 2^16 steps")
        got = out.cpu().numpy().view(np.uint32).reshape(-1)[idx]
        want = numpy_chain(name, x.reshape(-1)[idx], 1 << 16)
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: kernel differs from numpy at 2^16 steps")
        ms = cuda_ms(lambda: kern(xt, 1 << 10), 20)
        plain_ms = cuda_ms(lambda: plain(xt, 1 << 10), 2)
        ms2 = cuda_ms(lambda: kern(xt, 1 << 10), 20)
        results[name] = {"max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms}
        log(f"[8] {name} (2048, 128): exact match with plain at 2^10 and 2^16 steps and "
            f"with numpy at 2^16 (1024 elements); 2^10 steps kernel {ms:.4f} / {ms2:.4f} ms, "
            f"plain {plain_ms:.3f} ms")
    return results


def main() -> None:
    import torch

    # ---- 1: the card --------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from halo2_tpu_torch import _cuda
    from halo2_tpu_torch.bench import int_chains as ic
    from halo2_tpu_torch.bench import roofline
    from halo2_tpu_torch.curves import ec_kernels as ec
    from halo2_tpu_torch.curves import point as point_mod
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.fields import limb
    from halo2_tpu_torch.fields import mont_mul as mont_mul_mod
    from halo2_tpu_torch.fields.spec import BN254_FQ, BN254_FR

    # ---- 2: build -----------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    log(f"[2] kernels built/loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.build_seconds:.2f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("    ptxas: " + line.strip())

    # ---- 3 / 4: kernels against their plain versions -------------------------
    rs = np.random.default_rng(SEED)
    k1 = {spec.name: phase_k1(torch, limb, mont_mul_mod, spec, rs, dev)
          for spec in (BN254_FR, BN254_FQ)}
    ec_res = phase_ec(torch, point_mod, ec, BN254_G1, rs, dev)

    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils import profiling
    from halo2_tpu_torch.utils.rng import FieldRng
    from torch_circuits import BenchPlonkCircuit, EntryCircuit

    spec = BN254_G1.scalar

    # ---- 5: the pinned k=6 proof -------------------------------------------
    pin = os.path.join(HERE, "tests", "data", "dryrun_proof_k6.hex")
    with open(pin) as f:  # a missing pin fails here: never re-pinned
        expected = bytes.fromhex(f.read().strip())
    t0 = time.perf_counter()
    params6 = ParamsKZG.setup_host(6, seed=b"dryrun", device=dev)
    circuit = EntryCircuit(1, Value.known(5))
    inst = pow(5, 4, spec.p)
    vk6 = keygen_vk(params6, circuit.without_witnesses())
    pk6 = keygen_pk(params6, vk6, circuit.without_witnesses())
    proof6 = create_proof(
        params6, pk6, [circuit], [[[inst]]], FieldRng(spec, b"dryrun-proof"),
        Blake2bTranscript(BN254_G1), gwc_create_proof,
    )
    if proof6 != expected:
        raise AssertionError("k=6 proof bytes differ from tests/data/dryrun_proof_k6.hex")
    if not verify_proof(params6, vk6, [[[inst]]], Blake2bTranscript(BN254_G1, proof6),
                        gwc_verify_proof):
        raise AssertionError("k=6 proof rejected")
    if verify_proof(params6, vk6, [[[inst + 1]]], Blake2bTranscript(BN254_G1, proof6),
                    gwc_verify_proof):
        raise AssertionError("k=6 proof accepted with a wrong instance")
    log(f"[5] k=6 proof == pinned bytes ({len(proof6)} B); verify accepts, wrong instance "
        f"rejected; {time.perf_counter() - t0:.2f} s")

    # ---- 6: the main path at k=14 --------------------------------------------
    k = 14
    t0 = time.perf_counter()
    params = ParamsKZG.setup_host(k, seed=b"bench-prove", device=dev)
    params.s = None  # drop the toxic waste: verify runs the real pairing
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[6] k={k} SRS (host) {setup_s:.2f} s")
    bench = BenchPlonkCircuit(k, Value.known(2))

    counted = {
        "mont_mul": mont_mul_mod.mont_mul, "ec_add": ec.ec_add, "ec_double": ec.ec_double,
        "mont_mul_tiled": mont_mul_mod.mont_mul_tiled,
        "int_muladd": ic.int_muladd_chain, "int_addmask": ic.int_addmask_chain,
    }
    os.environ["HALO2_TPU_PROFILE"] = "1"
    profiling.report(reset=True)
    for fn in counted.values():
        fn.launches = 0
    walls = {}
    t0 = time.perf_counter()
    vk = keygen_vk(params, bench.without_witnesses())
    pk = keygen_pk(params, vk, bench.without_witnesses())
    torch.cuda.synchronize()
    walls["keygen"] = time.perf_counter() - t0
    for run in ("prove_cold", "prove"):
        profiling.report(reset=True)
        t0 = time.perf_counter()
        proof = create_proof(
            params, pk, [bench], [[]], FieldRng(spec, b"bench-prove-rng"),
            Blake2bTranscript(BN254_G1), gwc_create_proof,
        )
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
    phases = profiling.report(reset=True)
    t0 = time.perf_counter()
    ok = verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)
    walls["verify"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    if not ok:
        raise AssertionError("k=14 proof rejected")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    if verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, bytes(bad)), gwc_verify_proof):
        raise AssertionError("k=14 proof with a flipped byte accepted")
    log(f"[6] k={k} BenchPlonkCircuit: proof {len(proof)} B accepted through the real "
        f"pairing; flipped byte rejected")
    log("[6] walls (s): " + " ".join(f"{k_}={v:.3f}" for k_, v in walls.items()))
    log(f"[6] warm prove phases (synced), {sum(t for _, _, t in phases):.3f} s covered:")
    for name, calls, secs in phases:
        log(f"      {secs:8.3f} s  {calls:3d}x  {name}")
    log(f"[6] launches during keygen + 2 proves + verify: {launches}")
    for name in ("mont_mul", "ec_add", "ec_double"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"[6] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 7: K4 against its plain version and K1 ------------------------------
    k4 = {spec.name: phase_k4(torch, limb, mont_mul_mod, spec, rs, dev)
          for spec in (BN254_FR, BN254_FQ)}
    phase_shares(torch, roofline, dev)

    # ---- 8: the roofline path -------------------------------------------------
    chains = phase_chains(torch, ic, rs, dev)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    roof = roofline.run(emit=lambda line: log("    " + line))
    roof_launches = {name: fn.launches for name, fn in counted.items()}
    log(f"[8] roofline {time.perf_counter() - t0:.2f} s; launches during it: {roof_launches}")
    for name in ("mont_mul", "mont_mul_tiled", "int_muladd", "int_addmask"):
        if roof_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the roofline path")
    mix = roof["sass"]["mont_mul"]
    if (mix["imad"], mix["other"]) != (roofline.K1_IMAD, roofline.K1_OTHER):
        raise AssertionError(f"K1 SASS mix {mix} differs from the model's constants "
                             f"({roofline.K1_IMAD}, {roofline.K1_OTHER})")
    log(f"[8] SASS: K1 {mix['imad']} IMAD-class + {mix['other']} other, as the model says; "
        + "; ".join(f"{k} {v}" for k, v in roof["sass"].items() if k != "mont_mul"))

    kernels = [
        {"name": "mont_mul", "route": "cuda", "source": "halo2_tpu_torch/csrc/mont_mul.cu",
         "replaces": "halo2_tpu/fields/pallas_kernels.py:129",
         "launches": launches["mont_mul"], **k1[BN254_FR.name]},
        {"name": "ec_add", "route": "cuda", "source": "halo2_tpu_torch/csrc/ec.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:161",
         "launches": launches["ec_add"], **ec_res["ec_add"]},
        {"name": "ec_double", "route": "cuda", "source": "halo2_tpu_torch/csrc/ec.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:181",
         "launches": launches["ec_double"], **ec_res["ec_double"]},
        {"name": "mont_mul_tiled", "route": "cuda",
         "source": "halo2_tpu_torch/csrc/mont_mul_tiled.cu",
         "replaces": "halo2_tpu/fields/pallas_kernels.py:80",
         "launches": roof_launches["mont_mul_tiled"],
         **{k: v for k, v in k4[BN254_FR.name].items() if k != "k1_ms"}},
        {"name": "int_muladd", "route": "cuda", "source": "halo2_tpu_torch/csrc/roofline.cu",
         "replaces": "bench_roofline.py:53", "launches": roof_launches["int_muladd"],
         **chains["int_muladd"],
         "max_abs_err": max(chains[f]["max_abs_err"]
                            for f in ("int_muladd", "int_muladd_wide", "int_muladd_hi"))},
        {"name": "int_addmask", "route": "cuda", "source": "halo2_tpu_torch/csrc/roofline.cu",
         "replaces": "bench_roofline.py:85", "launches": roof_launches["int_addmask"],
         **chains["int_addmask"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
