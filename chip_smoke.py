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
   just after this phase (see below);
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
   the model's constants raises;
9. the kernels on the Pasta moduli: K1 on Pasta Fp and Fq (n = 2^16,
   including 0, 1 and p-1), K2 / K3 on Pallas and Vesta points (n = 2^14,
   including the identity, P+P and P+(-P)), each exactly equal to its plain
   version; then the device ``ParamsKZG.setup(14)`` (``batch_scalar_mul``)
   must give the same affine ``g`` and ``g_lagrange`` as phase 6's
   ``setup_host(14)``, both walls printed;
10. the pins and lookups + SHPLONK: the port's proofs of the
   tests/plonk_api.rs circuit (two instances, k=5) must equal
   ``tests/data/plonk_api_{gwc,shplonk,ipa}_k5.hex`` on the card; then
   ``LookupRangeCircuit`` (the reference's benches/dev_lookup.rs shape) at
   k=14 on BN254 through keygen, two proves and SHPLONK verify with the real
   pairing; a flipped byte is rejected;
11. IPA at full width, the reference's criterion workload (benches/plonk.rs,
   ``ParamsIPA::<EqAffine>``): ``BenchPlonkCircuit`` at k=14 over
   ``ParamsIPA.setup(14, VESTA)`` (the SSWU SRS on the host, g_to_lagrange
   on the card), keygen, two proves, verify through ``IPASingleStrategy``; a
   flipped byte is rejected; ``BatchVerifier`` accepts two good proofs and
   rejects a good one beside a tampered one;
12. the chains, each one launch: K1's ``mont_pow`` against ``mont_pow_plain``
   on all four fields at n = 1, 7 and 2^14 (0, 1 and p-1 included), for
   e = p-2 and a short exponent; K3's ``ec_scalar_mul`` against its plain
   version on BN254 G1, Pallas and Vesta at n = 1 and 2^13 (scalars 0, 1 and
   r-1 and the identity point included); K3's ``ec_horner`` at phase 6's
   shapes (c = 5, W = 52, m = 1 and the largest m of a batched commit), at
   c = 4 and on Vesta.  Exact equality, projective limbs and affine form;
13. the MSM entries of ``ops/msm.py`` (``csrc/msm.cu``): ``msm_digits``,
   ``ec_window_table`` and ``ec_window_fold`` against their plain versions
   at the main path's shapes (BN254 n = 2^14 with m = 1
   and the largest m of phase 6, n = 2^10 (c = 4), n = 1 and 3, Vesta n =
   2^13): exact equality, the unpacked table limb for limb; ``msm_many`` equal, in
   projective limbs, to ``ec_horner`` over the plain window sums, and in
   affine form to the host MSM where n <= 2^10; then one ``msm_many`` at n =
   2^18, m = 7 (the k = 18 keygen's commit shape) with its time and peak
   device memory, checked by linearity (column 2 = column 0 + column 1,
   column 3 = 0);
14. the entry points and key I/O: ``entry.entry()``'s k=10 prover round and
   ``entry.dryrun_full_proof()`` (the k=6 proof equal to its pin); phase 6's
   k=14 vk and pk through ``plonk.serde`` in all three formats (the vk's
   ``transcript_repr`` equal, the read pk's proof with the same rng
   byte-equal to phase 6's, write and read walls printed); phase 6's SRS
   through ``ParamsKZG.write`` / ``read`` in every format (g and g_lagrange
   equal, limb for limb) and a RawBytes file with one flipped coordinate
   rejected; ``bench/full.py``'s MSM, NTT and coset legs and a prove leg at
   k=10, their metric names checked and every value positive;
15. the dev tools and Poseidon: (a) MockProver of ``BenchPlonkCircuit`` at
   k=17 with its columns on the card: ``verify()`` (the vectorised gate
   check, every product K1) finds nothing, K1 launched during it; one advice
   cell changed, it reports exactly the product gate and the copy at that
   row, Display strings included; (b) at k=11 (n = 2048, the vectorised
   path) the card's failure list and its strings equal the per-row host
   path's for every failure kind (ConstraintNotSatisfied,
   ConstraintPoisoned, Lookup, Permutation, CellNotAssigned); (c)
   ``LookupRangeCircuit`` at k=14 under MockProver is satisfied, and one
   value out of the table gives exactly one Lookup failure at its row; (d)
   the Pow5 Poseidon ``HashCircuit`` (width 3, rate 2, BN254) at K=7 over
   KZG/GWC: MockProver satisfied, the proof equal to the JAX package's pin
   ``tests/data/poseidon_gwc_k7.hex``, a wrong instance rejected; (e) the
   reference's benches/poseidon.rs (P128Pow5T3 over Pallas Fp, K=7) over
   ``ParamsIPA`` on Vesta: proof verified, a flipped byte rejected; the
   keygen, prove and verify walls of (d) and (e), warm, fenced, the median of
   3; (f) the examples ``two_chip`` and ``shuffle`` prove on the card, and
   the files ``circuit_layout`` writes (into a temporary directory) hold the
   strings the host renders;
16. the gadgets, every MockProver with its columns on the card and its
   vectorised ``verify()`` (K1) held to the per-row host path: (a) SHA-256
   (Table16) at k=17 on "abc" and on the reference bench's 31-block message
   (1,975 bytes from a seed) satisfied against ``hashlib``'s digest, K1
   launched in ``verify()``; one flipped digest half-word gives the per-row
   path's Permutation failures (that path, pure host Python over every row,
   runs on the CPU in a worker process beside (a)-(d)); (b) the 31-block circuit proved at k=17 over
   KZG/GWC on the device SRS: a wrong instance and a flipped byte rejected,
   keygen / prove / verify walls warm, fenced, the median of 2 after one
   cold, then one prove's synced phases; (c) ECC on Pallas Fp: the add cases
   (off-curve rejected), the variable-base mul at k=11 (a non-boolean bit
   rejected), the fixed-base full-width, short (an oversized magnitude
   rejected) and base-field-element muls (a wrong point fails synthesis),
   and the short range check's soundness regression over IPA at k=6 (the
   forged multiplier rejected); (d) Sinsemilla over IPA on Vesta with
   equality on ``witness_pieces``: the commit circuit at k=11, its verifying
   key's ``transcript_repr`` equal to the JAX package's pin
   ``tests/data/sinsemilla_commit_ipa_k11.vk``, and the Merkle path at depth
   32 at k=12; walls as in (b), a flipped byte rejected;
17. multi-device proving (``halo2_tpu_torch/parallel/``) on meshes of 2, 4
   and 8 shards over the visible cards in turn (distinct cards up to their
   count, then repeats: on one card, ``cuda:0`` D times, a proxy that
   measures the sharding's overhead, not scaling; a mesh device that is no
   card raises); the distinct cards and, with two or more, their peer access
   printed: (a) BN254 Fr ``sharded_ntt`` / ``sharded_intt`` at n = 2^16 and
   2^18 exactly equal to ``ntt_sixstep`` / ``intt_sixstep`` (and the round
   trip), ``sharded_msm`` and ``sharded_msm_many`` (m = 4) at n = 2^16 equal
   to ``msm`` / ``msm_many`` in affine form, for D = 2, 4, 8, and the gather
   path once (n = 2^5, D = 8): times sharded beside one device, each
   kernel's launches per call (K2, the MSM entries and ``ec_horner`` must
   run in a sharded MSM); (b) ``entry.dryrun_multichip(D)`` for D = 2, 4, 8
   equal to the k=6 pin; (c) ``BenchPlonkCircuit`` at k=16 over KZG/GWC and
   Blake2b on the device SRS with D = 4: ``keygen_vk`` with the mesh gives
   the same ``transcript_repr``, ``create_proof`` with and without it the
   same bytes from one ``FieldRng`` seed, the sharded proof verifies through
   the real pairing and a flipped byte is rejected, the sharded keys proved
   again without a mesh give the same bytes and leave none on the params or
   the domain; keygen and prove walls warm, fenced on every card, the median
   of 2 after one cold run, each side's peak device memory, and the bytes
   one sharded prove exchanges between shards; (d) ``bench.full.bench_scaling(k=12)``'s
   ``scaling_efficiency_{2,4,8}dev`` lines with their devices;
18. K1's field and transform entries: ``field_add``, ``field_sub`` and
   ``field_neg`` (``csrc/field_ops.cu``) against their plain carry chains on
   BN254 Fr at n = 2^15, 2^16 and 2^21 (0, 1 and p-1 included), with both
   operands full and with one operand of one element read in place, and K1
   with such an operand; ``stockham_axis`` (``csrc/ntt.cu``) against the
   plain stage loop on (16, m, B) at m = 1, 2, 2^7, 2^8 and 2^11 (the
   six-step's axis shapes at 2^15, 2^16 and 2^21); ``ntt_sixstep`` at 2^15
   and 2^16 on it against the six-step on the plain loop.  Exact equality;
   kernel and plain times and each bound.

Phases 6, 10, 11, 14, 15, 16 and 17 each zero the kernels' launch counters (and
the calls of ``limb.finv`` and ``msm_many``) just before they start and read
them just after; K1, ``mont_pow``, ``ec_horner`` and the three MSM entries
must each have been launched (and K2 and ``ec_scalar_mul`` in phases 11, 15
and 16, K2 in 10, through ``gntt`` and the IPA rounds, K2 in 17, where it
folds the shards' partial MSMs); on each,
``msm_digits``, ``ec_window_table`` and ``ec_horner`` launches must equal the
``msm_many`` calls and ``ec_window_fold`` launches lie between one and three
times them, and on phase 6 ``mont_pow`` launches must equal the ``finv`` calls,
the standalone K2 / K3 launches be 0, ``field_add``, ``field_sub``,
``field_neg`` and ``stockham_axis`` each be launched, and no plain version
(the carry chains, the stage loop, K1's) be called on a CUDA tensor. Then one JSON line with every
kernel's launches by phase, error, times and bound, and as the last line
``{"ok": true, "device": {...}}``. Times are CUDA-event times on this card,
kernel and plain version measured in the same run. A bound is the larger of
the bytes the function must move over 3.35 TB/s and its 32-bit multiply-adds
(136 per Montgomery product: an 8-word CIOS product) over the card's 32-bit
integer rate (SMs x 64 lanes x the maximum SM clock, ``bench/roofline.py``),
for this run's inputs. No PyTorch call computes a Montgomery product, a
field addition modulo p, an NTT over these fields, an EC operation or the
integer chains, so ``library_ms`` is null throughout.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import statistics
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


def timed_once(torch, fn):
    """(fn(), its milliseconds on the current stream, CUDA events): for the
    plain chains, which are too slow to repeat."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


PRODUCT_MULS = 2 * 8 * 8 + 8  # 32-bit multiply-adds of one 8-word CIOS Montgomery product
HBM_BYTES_PER_SEC = 3.35e12   # H100 SXM data sheet


def bound(peaks: dict, nbytes: float, muls: float) -> dict:
    """The least time for the work: bytes over HBM or multiply-adds over the
    32-bit integer rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_SEC, muls / peaks["int32_per_sec"]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pow_products(e: int) -> int:
    """Montgomery products of square-and-multiply for exponent e >= 1."""
    return e.bit_length() - 1 + bin(e).count("1") - 1


def scalar_mul_products(scalars) -> int:
    """Montgomery products double-and-add needs for these scalars: 8 per
    doubling below the top bit, 12 per add after the first."""
    return sum(8 * max(k.bit_length() - 1, 0) + 12 * max(bin(k).count("1") - 1, 0)
               for k in scalars)


class CallCounter:
    """Counts the calls of a function in every module that holds it by name
    (``limb.finv``; ``msm_many``, imported by name into the commitment
    modules), and the largest ``batch_of(args)`` seen."""

    def __init__(self, name: str, modules, batch_of=lambda args: 0):
        orig = getattr(modules[0], name)
        self.calls = self.max_batch = 0

        def counted(*args, **kwargs):
            self.calls += 1
            self.max_batch = max(self.max_batch, batch_of(args))
            return orig(*args, **kwargs)

        for mod in modules:
            if getattr(mod, name) is not orig:
                raise RuntimeError(f"{mod.__name__}.{name} is not the function counted")
            setattr(mod, name, counted)

    def reset(self) -> None:
        self.calls = self.max_batch = 0


def phase_k1(torch, limb, mont_mul_mod, spec, rs, dev, tag="[3]"):
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
    log(f"{tag} K1 mont_mul {spec.name} n={n}: exact match; kernel {ms:.4f} / {ms2:.4f} ms, "
        f"plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms}


def chained_points(curve, n: int, rs) -> list:
    """n distinct affine points R + i*S for seeded multiples R, S of the
    generator: one host add each (no square roots)."""
    from halo2_tpu_torch.curves import host

    g = host.generator(curve)
    r, s = (host.mul(curve, g, int(v)) for v in rs.integers(1, 1 << 62, size=2))
    pts = [r]
    for _ in range(n - 1):
        pts.append(host.add(curve, pts[-1], s))
    return pts


def phase_ec(torch, point_mod, ec, curve, rs, dev, tag="[4]"):
    n = 1 << 14
    aff = chained_points(curve, 2 * n, rs)
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
        log(f"{tag} K {name} {curve.name} n={n}: exact match (projective and affine); "
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


def rejects_flipped(verify, proof: bytes, at: int) -> bool:
    """verify() on the proof with one byte flipped: rejected means False, or
    the transcript's decode error (ValueError), caught for this call only."""
    bad = bytearray(proof)
    bad[at] ^= 1
    try:
        return verify(bytes(bad)) is False
    except ValueError:
        return True


MSM_KERNELS = ("msm_digits", "ec_window_table", "ec_window_fold")
PATH_KERNELS = ("mont_mul", "mont_pow", "ec_horner") + MSM_KERNELS
# K1's field and transform entries
ENTRY_KERNELS = ("field_add", "field_sub", "field_neg", "stockham_axis")


def start_counting(torch, counted, calls=()) -> None:
    for fn in counted.values():
        fn.launches = 0
    for c in calls:
        c.reset()
    torch.cuda.reset_peak_memory_stats()


def read_counts(torch, counted, tag: str, calls: dict, names=PATH_KERNELS) -> dict:
    launches = {name: fn.launches for name, fn in counted.items()}
    log(f"{tag} launches: {launches}")
    log(f"{tag} calls: " + ", ".join(f"{k} {c.calls} (largest batch {c.max_batch})"
                                     for k, c in calls.items()))
    log(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{tag} kernel {name} was not launched")
    return launches


def check_msm_launches(tag: str, launches: dict, calls: dict) -> None:
    """Each msm_many is msm_digits, ec_window_table, 1-3 ec_window_fold
    passes and ec_horner: 4-6 launches, and nothing else of it is a kernel."""
    c = calls["msm_many"].calls
    for name in ("msm_digits", "ec_window_table", "ec_horner"):
        if launches[name] != c:
            raise AssertionError(f"{tag} {name} launches {launches[name]} != msm_many calls {c}")
    if not c <= launches["ec_window_fold"] <= 3 * c:
        raise AssertionError(f"{tag} ec_window_fold launches {launches['ec_window_fold']} outside "
                             f"[{c}, {3 * c}] for {c} msm_many calls")
    per_call = sum(launches[k] for k in MSM_KERNELS + ("ec_horner",)) / c
    log(f"{tag} msm_many: {c} calls, {per_call:.2f} CUDA launches per call "
        f"(msm_digits, ec_window_table, ec_window_fold {launches['ec_window_fold']}, ec_horner)")


def log_walls(tag: str, walls: dict, phases) -> None:
    log(f"{tag} walls (s): " + " ".join(f"{k}={v:.3f}" for k, v in walls.items()))
    log(f"{tag} warm prove phases (synced), {sum(t for _, _, t in phases):.3f} s covered:")
    for name, calls, secs in phases:
        log(f"      {secs:8.3f} s  {calls:3d}x  {name}")


def keygen_and_prove(torch, profiling, params, circuit, prove):
    """keygen_vk + keygen_pk, then a cold and a warm prove; (vk, pk, proof,
    walls, the warm prove's synced phases)."""
    from halo2_tpu_torch.plonk import keygen_pk, keygen_vk

    walls = {}
    t0 = time.perf_counter()
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    torch.cuda.synchronize()
    walls["keygen"] = time.perf_counter() - t0
    for run in ("prove_cold", "prove"):
        profiling.report(reset=True)
        t0 = time.perf_counter()
        proof = prove(pk)
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
    return vk, pk, proof, walls, profiling.report(reset=True)


def phase_pins(torch, dev) -> None:
    """The tests/plonk_api.rs proofs (two instances, k=5) on the card must
    equal the JAX package's pins; verify accepts each."""
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.curves.spec import BN254_G1, PALLAS
    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu_torch.poly import multiopen_gwc, multiopen_ipa, multiopen_shplonk
    from halo2_tpu_torch.poly.ipa import IPASingleStrategy, ParamsIPA
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng
    from torch_circuits import StandardPlonkCircuit, plonk_api_common

    kzg = ParamsKZG.setup_host(5, seed=b"plonk-api", device=dev)
    ipa = ParamsIPA.setup(5, seed=b"plonk-api-ipa", device=dev)
    schemes = (
        ("gwc", kzg, BN254_G1, multiopen_gwc.gwc_create_proof, multiopen_gwc.gwc_verify_proof,
         b"gwc-rng", {}),
        ("shplonk", kzg, BN254_G1, multiopen_shplonk.shplonk_create_proof,
         multiopen_shplonk.shplonk_verify_proof, b"shplonk-rng", {}),
        ("ipa", ipa, PALLAS, multiopen_ipa.ipa_create_proof, multiopen_ipa.ipa_verify_proof,
         b"ipa-rng", {"query_instance": True}),
    )
    for name, params, curve, create, verify, seed, opts in schemes:
        t0 = time.perf_counter()
        with open(os.path.join(HERE, "tests", "data", f"plonk_api_{name}_k5.hex")) as f:
            expected = bytes.fromhex(f.read().strip())  # a missing pin fails: never re-pinned
        spec = curve.scalar
        a, inst, table = plonk_api_common(spec)
        empty = StandardPlonkCircuit(Value.unknown(), table)
        vk = keygen_vk(params, empty)
        pk = keygen_pk(params, vk, empty)
        circuit = StandardPlonkCircuit(Value.known(a), table)
        instances = [[[inst]], [[inst]]]
        proof = create_proof(params, pk, [circuit, circuit], instances, FieldRng(spec, seed),
                             Blake2bTranscript(curve), create, **opts)
        if proof != expected:
            raise AssertionError(f"plonk_api {name} k=5 proof differs from its pin")
        strategy = IPASingleStrategy(params) if name == "ipa" else None
        if verify_proof(params, vk, instances, Blake2bTranscript(curve, proof), verify,
                        strategy=strategy, **opts) is not True:
            raise AssertionError(f"plonk_api {name} k=5 proof rejected")
        log(f"[10] plonk_api {name} k=5 (two instances, lookup) == pinned bytes "
            f"({len(proof)} B); verify accepts; {time.perf_counter() - t0:.2f} s")


def phase_lookup(torch, profiling, params, dev) -> None:
    """LookupRangeCircuit at k=14 on BN254 through SHPLONK, the real pairing."""
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.plonk import create_proof, verify_proof
    from halo2_tpu_torch.poly import multiopen_shplonk as shplonk
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng
    from torch_circuits import LookupRangeCircuit

    assert params.s is None  # verify runs the real pairing
    spec = BN254_G1.scalar
    circuit = LookupRangeCircuit(params.k)
    vk, _, proof, walls, phases = keygen_and_prove(torch, profiling, params, circuit, lambda pk: (
        create_proof(params, pk, [circuit], [[]], FieldRng(spec, b"lookup-range-rng"),
                     Blake2bTranscript(BN254_G1), shplonk.shplonk_create_proof)))

    def verify(pr):
        return verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, pr),
                            shplonk.shplonk_verify_proof)

    t0 = time.perf_counter()
    ok = verify(proof)
    walls["verify"] = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"k={params.k} lookup proof rejected")
    if not rejects_flipped(verify, proof, len(proof) // 2):
        raise AssertionError(f"k={params.k} lookup proof with a flipped byte accepted")
    log(f"[10] k={params.k} LookupRangeCircuit (SHPLONK): proof {len(proof)} B accepted "
        f"through the real pairing; flipped byte rejected")
    log_walls("[10]", walls, phases)


def phase_ipa(torch, profiling, dev, k: int = 14) -> None:
    """benches/plonk.rs: BenchPlonkCircuit at k=14 over ParamsIPA<EqAffine>."""
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.curves.spec import VESTA
    from halo2_tpu_torch.plonk import create_proof, verify_proof
    from halo2_tpu_torch.plonk.batch import BatchVerifier
    from halo2_tpu_torch.poly.ipa import IPASingleStrategy, ParamsIPA
    from halo2_tpu_torch.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng
    from torch_circuits import BenchPlonkCircuit

    spec = VESTA.scalar
    profiling.report(reset=True)
    t0 = time.perf_counter()
    params = ParamsIPA.setup(k, VESTA, device=dev)  # the reference's "Halo2-Parameters"
    torch.cuda.synchronize()
    srs = {name: secs for name, _, secs in profiling.report(reset=True)}
    log(f"[11] k={k} SSWU SRS on the host {srs['ipa setup: SRS points (host)']:.2f} s")
    log(f"[11] k={k} g_to_lagrange on the card {srs['ipa setup: g_to_lagrange']:.2f} s; "
        f"ParamsIPA.setup {time.perf_counter() - t0:.2f} s")
    circuit = BenchPlonkCircuit(k, Value.known(2))
    vk, _, proof, walls, phases = keygen_and_prove(torch, profiling, params, circuit, lambda pk: (
        create_proof(params, pk, [circuit], [[]], FieldRng(spec, b"bench-ipa-rng"),
                     Blake2bTranscript(VESTA), ipa_create_proof, query_instance=True)))

    def verify(pr):
        return verify_proof(params, vk, [[]], Blake2bTranscript(VESTA, pr), ipa_verify_proof,
                            query_instance=True, strategy=IPASingleStrategy(params))

    t0 = time.perf_counter()
    ok = verify(proof)
    walls["verify"] = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"k={k} IPA proof rejected")
    if not rejects_flipped(verify, proof, len(proof) // 2):
        raise AssertionError(f"k={k} IPA proof with a flipped byte accepted")
    t0 = time.perf_counter()
    for tamper in (False, True):
        second = bytearray(proof)
        second[-1] ^= int(tamper)  # the final IPA fold scalar
        batch = BatchVerifier()
        batch.add_proof([[]], proof)
        batch.add_proof([[]], bytes(second))
        if batch.finalize(params, vk) is tamper:
            raise AssertionError(f"k={k} BatchVerifier got it wrong (tampered: {tamper})")
    walls["batch_verify_x2"] = time.perf_counter() - t0
    log(f"[11] k={k} BenchPlonkCircuit (IPA, Vesta): proof {len(proof)} B accepted "
        f"(IPASingleStrategy); flipped byte rejected; BatchVerifier accepts two good proofs "
        f"and rejects a tampered one")
    log_walls("[11]", walls, phases)


def exact(torch, what: str, got, want) -> int:
    """Raise unless every tensor of ``got`` equals its ``want``; max |err| (0)."""
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: kernel differs from plain (max |err| {err})")
    return err


def phase_mont_pow(torch, limb, mm, specs, rs, dev, peaks, ns=(1, 7, 1 << 14)) -> dict:
    """K1's chain entry on every field at widths ``ns``; e = p-2 and e = 5."""
    shapes, err = [], 0
    for spec in specs:
        r_inv = pow(spec.r, -1, spec.p)
        for n in ns:
            vals = random_field(spec, max(n, 8), rs)
            vals = vals[:n] if n >= 3 else vals[-n:]  # 0, 1, p-1 from n = 7 up
            a = limb.from_ints(spec, vals, dev)
            for e in (spec.p - 2, 5):
                out = mm.mont_pow(spec, a, e)
                ref, plain_ms = timed_once(torch, lambda: mm.mont_pow_plain(spec, a, e))
                err = max(err, exact(torch, f"mont_pow {spec.name} n={n} e bits {e.bit_length()}",
                                     out, ref))
                got = [v * r_inv % spec.p for v in limb.limbs_np_to_ints(out[:, :8].cpu().numpy())]
                if got != [pow(v, e, spec.p) for v in vals[:8]]:
                    raise AssertionError(f"mont_pow {spec.name} n={n}: differs from Python ints")
                if e == spec.p - 2:
                    ms = cuda_ms(lambda: mm.mont_pow(spec, a, e), 20)
                    shapes.append({"field": spec.name, "n": n, "e": "p-2", "ms": ms,
                                   "plain_ms": plain_ms,
                                   **bound(peaks, 128 * n, PRODUCT_MULS * n * pow_products(e))})
        log(f"[12] mont_pow {spec.name} n={', '.join(map(str, ns))}, e=p-2 and 5: exact match "
            f"with plain and Python ints; e=p-2 kernel / plain ms: " + ", ".join(
                f"n={r['n']} {r['ms']:.4f} / {r['plain_ms']:.1f}" for r in shapes[-len(ns):]))
    return {"shapes": shapes, "max_abs_err": err}


def phase_scalar_mul(torch, point_mod, ec, limb, curves, rs, dev, peaks,
                     ns=(1 << 13, 1)) -> dict:
    """K3's double-and-add chain at widths ``ns``, scalars 0, 1, r-1 and the
    identity point included where n > 1."""
    from halo2_tpu_torch.curves import host

    shapes, err = [], 0
    for curve in curves:
        for n in ns:
            aff = chained_points(curve, n, rs)
            fr = curve.scalar
            scalars = [int(v) ** 3 % fr.p for v in rs.integers(1, 1 << 62, size=n)]
            if n > 1:
                aff[0] = None
                scalars[:4] = [0, 1, fr.p - 1, scalars[3]]
            pts = tuple(c.contiguous() for c in ec.ec_double_plain(
                curve, tuple(point_mod.from_affine_ints(curve, aff, dev))))  # z != 1
            k = torch.from_numpy(limb.ints_to_limbs_np(scalars)).to(dev)
            out = ec.ec_scalar_mul(curve, k, pts)
            ref, plain_ms = timed_once(torch, lambda: ec.ec_scalar_mul_plain(curve, k, pts))
            err = max(err, exact(torch, f"ec_scalar_mul {curve.name} n={n}", out, ref))
            got = point_mod.to_affine_ints(curve, point_mod.Point(*out))
            if got != point_mod.to_affine_ints(curve, point_mod.Point(*ref)):
                raise AssertionError(f"ec_scalar_mul {curve.name} n={n}: affine results differ")
            want = [host.mul(curve, host.double(curve, q), s) for q, s in zip(aff[:4], scalars)]
            if got[:4] != want:
                raise AssertionError(f"ec_scalar_mul {curve.name} n={n}: differs from the host")
            ms = cuda_ms(lambda: ec.ec_scalar_mul(curve, k, pts), 5)
            shapes.append({"curve": curve.name, "n": n, "ms": ms, "plain_ms": plain_ms,
                           **bound(peaks, 448 * n, PRODUCT_MULS * scalar_mul_products(scalars))})
            log(f"[12] ec_scalar_mul {curve.name} n={n}: exact match (projective and affine); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    return {"shapes": shapes, "max_abs_err": err}


def phase_horner(torch, point_mod, ec, cases, rs, dev, peaks) -> dict:
    """K3's window fold at msm_many's shapes: (curve, c, W, m) per case."""
    shapes, err = [], 0
    for curve, c, w, m in cases:
        aff = chained_points(curve, m * w, rs)
        aff[-1] = None  # an identity window sum
        flat = ec.ec_double_plain(curve, tuple(point_mod.from_affine_ints(curve, aff, dev)))
        sums = tuple(t.reshape(16, m, w).contiguous() for t in flat)
        out = ec.ec_horner(curve, sums, c)
        ref, plain_ms = timed_once(torch, lambda: ec.ec_horner_plain(curve, sums, c))
        err = max(err, exact(torch, f"ec_horner {curve.name} c={c} W={w} m={m}", out, ref))
        if (point_mod.to_affine_ints(curve, point_mod.Point(*out))
                != point_mod.to_affine_ints(curve, point_mod.Point(*ref))):
            raise AssertionError(f"ec_horner {curve.name} c={c} m={m}: affine results differ")
        ms = cuda_ms(lambda: ec.ec_horner(curve, sums, c), 5)
        shapes.append({"curve": curve.name, "c": c, "W": w, "m": m, "ms": ms,
                       "plain_ms": plain_ms,
                       **bound(peaks, 192 * (m * w + m),
                               PRODUCT_MULS * m * (w - 1) * (8 * c + 12))})
        log(f"[12] ec_horner {curve.name} c={c} W={w} m={m}: exact match (projective and affine); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    return {"shapes": shapes, "max_abs_err": err}


def msm_operands(torch, point_mod, limb, curve, n: int, m: int, rs, dev):
    """(affine points, identity first; scalar columns with 0, 1 and r-1
    rotated through them; (m, 16, n) Montgomery scalars; the points)."""
    aff = chained_points(curve, n, rs)
    if n > 1:
        aff[0] = None
    cols = []
    for j in range(m):
        vals = random_field(curve.scalar, max(n, 3), rs)
        vals = vals[:n] if n >= 3 else vals[-n:]  # r-1 alone at n = 1
        cols.append(vals[j % n:] + vals[:j % n])
    scal = torch.stack([limb.from_ints(curve.scalar, col, dev) for col in cols])
    return aff, cols, scal, point_mod.from_affine_ints(curve, aff, dev)


def phase_msm(torch, point_mod, limb, msm_ops, ec, cases, rs, dev, peaks) -> dict:
    """The MSM entries against their plain versions at the main path's
    shapes, (curve, n, m) per case; msm_many against ec_horner over the plain
    window sums."""
    from halo2_tpu_torch.curves import host

    res = {name: {"shapes": [], "max_abs_err": 0} for name in MSM_KERNELS}
    res["msm_many"] = []
    for curve, n, m in cases:
        c = msm_ops.choose_window(n)
        h, w, npad = 1 << (c - 1), msm_ops.num_windows(c), msm_ops.padded(n)
        aff, cols, scal, pts = msm_operands(torch, point_mod, limb, curve, n, m, rs, dev)
        shape = {"curve": curve.name, "n": n, "m": m, "c": c}

        digits = msm_ops.msm_digits(curve, scal, c)
        ref, plain_ms = timed_once(torch, lambda: msm_ops.msm_digits_plain(curve, scal, c))
        err = exact(torch, f"msm_digits {shape}", digits, ref)
        res["msm_digits"]["shapes"].append({
            **shape, "ms": cuda_ms(lambda: msm_ops.msm_digits(curve, scal, c), 20),
            "plain_ms": plain_ms,
            **bound(peaks, 64 * m * n + 2 * m * w * npad, PRODUCT_MULS * m * n)})

        table = msm_ops.ec_window_table(curve, pts, c)
        plain_table, plain_ms = timed_once(
            torch, lambda: msm_ops.ec_window_table_plain(curve, pts, c))
        err = max(err, exact(torch, f"ec_window_table {shape}", msm_ops.table_unpack(table),
                             plain_table))
        products = 8 + 12 * (h - 2) if h >= 2 else 0
        res["ec_window_table"]["shapes"].append({
            **shape, "ms": cuda_ms(lambda: msm_ops.ec_window_table(curve, pts, c), 10),
            "plain_ms": plain_ms,
            **bound(peaks, 192 * n + 96 * n * (h + 1), PRODUCT_MULS * products * n)})

        # the plain fold one column at a time: a column's select is (16, 1, W, npad)
        def plain_fold():
            parts = [msm_ops.ec_window_fold_plain(curve, plain_table, digits[j:j + 1])
                     for j in range(m)]
            return tuple(torch.cat([p[ci] for p in parts], dim=1) for ci in range(3))

        ref, plain_ms = timed_once(torch, plain_fold)
        sums = msm_ops.ec_window_fold(curve, table, digits)
        err = max(err, exact(torch, f"ec_window_fold {shape}", sums, ref))
        res["ec_window_fold"]["shapes"].append({
            **shape, "ms": cuda_ms(lambda: msm_ops.ec_window_fold(curve, table, digits), 5),
            "plain_ms": plain_ms,
            **bound(peaks, 2 * m * w * npad + 96 * n * (h + 1) + 192 * m * w,
                    12 * PRODUCT_MULS * m * w * (npad - 1))})

        out = msm_ops.msm_many(curve, scal, pts)
        err = max(err, exact(torch, f"msm_many {shape}", tuple(out), ec.ec_horner(curve, ref, c)))
        if n <= 1 << 10 and (point_mod.to_affine_ints(curve, out)
                             != [host.msm(curve, col, aff) for col in cols]):
            raise AssertionError(f"msm_many {shape}: differs from the host MSM")
        fused = cuda_ms(lambda: msm_ops.ec_window_fold(curve, msm_ops.ec_window_table(
            curve, pts, c), msm_ops.msm_digits(curve, scal, c)), 5)
        res["msm_many"].append({**shape, "ms_without_horner": fused,
                                "ms": cuda_ms(lambda: msm_ops.msm_many(curve, scal, pts), 3)})
        for name in MSM_KERNELS:
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        log(f"[13] MSM entries {shape}: exact match with plain; "
            f"msm_many == ec_horner(plain sums)"
            + (" and the host MSM" if n <= 1 << 10 else "") + "; kernel / plain ms: "
            + ", ".join(f"{k} {res[k]['shapes'][-1]['ms']:.4f} / {res[k]['shapes'][-1]['plain_ms']:.1f}"
                        for k in MSM_KERNELS)
            + f"; digits + table + fold {fused:.4f} ms, msm_many {res['msm_many'][-1]['ms']:.4f} ms")
    return res


def phase_msm_k18(torch, point_mod, limb, msm_ops, params, rs, dev) -> dict:
    """One msm_many at n = 2^18, m = 7 on the kernel path: phase 6's k = 14
    SRS points 16 times over, random scalars below p made on the host in
    numpy; column 2 = column 0 + column 1, column 3 = 0."""
    from halo2_tpu_torch.curves import host
    from halo2_tpu_torch.curves.spec import BN254_G1

    curve, n, m = BN254_G1, 1 << 18, 7
    fr = curve.scalar
    pts = point_mod.Point(*(torch.cat([t] * (n // t.shape[1]), dim=1) for t in params.g))
    raw = rs.integers(0, 1 << 16, size=(m, 16, n), dtype=np.int64)
    raw[:, 15] %= fr.p >> 240  # below p: a valid Montgomery form
    scal = torch.from_numpy(raw.astype(np.int32)).to(dev)
    scal[2] = limb.fadd(fr, scal[0], scal[1])
    scal[3] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, ms = timed_once(torch, lambda: msm_ops.msm_many(curve, scal, pts))
    peak = torch.cuda.max_memory_allocated()
    aff = point_mod.to_affine_ints(curve, out)
    if aff[2] != host.add(curve, aff[0], aff[1]) or aff[3] is not None:
        raise AssertionError("msm_many n=2^18 m=7: not linear in the scalars")
    res = {"n": n, "m": m, "ms": ms, "peak_gib": peak / 2**30,
           "peak_above_operands_gib": (peak - before) / 2**30}
    log(f"[13] msm_many n=2^18 m=7: {ms:.2f} ms (one call, CUDA events); peak device memory "
        f"{res['peak_gib']:.3f} GiB, {res['peak_above_operands_gib']:.3f} GiB above the "
        f"operands; column 0 + column 1 == column 2, column 3 the identity")
    return res


def phase_entry(torch, dev) -> None:
    """entry()'s prover round at k=10, and the k=6 dry run against its pin."""
    from halo2_tpu_torch import entry

    t0 = time.perf_counter()
    fn, args = entry.entry(dev)
    out = fn(*args)
    torch.cuda.synchronize()
    if [tuple(o.shape) for o in out] != [(16,), (16,)] or not all(o.is_cuda for o in out):
        raise AssertionError(f"entry(): unexpected outputs {[(o.shape, o.device) for o in out]}")
    if not all(bool(((o >= 0) & (o < 1 << 16)).all()) for o in out):
        raise AssertionError("entry(): an output limb lies outside [0, 2^16)")
    log(f"[14] entry() k=10 prover round on the card: outputs (16,) x 2; "
        f"{time.perf_counter() - t0:.2f} s with the device SRS")
    entry.dryrun_full_proof(dev, log=lambda msg: log("[14] " + msg))


def phase_serde(torch, params, vk, pk, proof, prove, circuit_cls, dev) -> dict:
    """Phase 6's k=14 vk and pk through every SerdeFormat: the vk's
    transcript_repr and the read pk's proof (same rng) must equal the
    originals; then the SRS through every format, a flipped RawBytes
    coordinate rejected."""
    import tempfile

    from halo2_tpu_torch.bench.full import timed
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.plonk import serde
    from halo2_tpu_torch.poly.kzg import ParamsKZG

    walls = {}
    for fmt in serde.SerdeFormat:
        name = fmt.name.lower()
        vk_bytes = serde.vk_to_bytes(vk, BN254_G1, fmt)
        if serde.vk_from_bytes(vk_bytes, BN254_G1, circuit_cls, fmt=fmt,
                               device=dev).transcript_repr != vk.transcript_repr:
            raise AssertionError(f"[14] vk read back in {fmt.name} has another transcript_repr")
        data, walls[f"pk_write_{name}"] = timed(
            lambda: serde.pk_to_bytes(pk, BN254_G1, fmt), dev)
        back, walls[f"pk_read_{name}"] = timed(lambda: serde.pk_from_bytes(
            data, BN254_G1, circuit_cls, fmt=fmt, device=dev), dev)
        if not back.l0.values.is_cuda or back.vk.transcript_repr != vk.transcript_repr:
            raise AssertionError(f"[14] pk read back in {fmt.name}: wrong device or vk")
        if prove(back) != proof:
            raise AssertionError(f"[14] the pk read back in {fmt.name} proves other bytes")
        log(f"[14] k={params.k} pk {fmt.name}: {len(data)} B, write "
            f"{walls[f'pk_write_{name}']:.3f} s, read {walls[f'pk_read_{name}']:.3f} s; "
            f"vk transcript_repr equal; the read pk's proof == the original's")
        del data, back
    # an unchecked read keeps v mod p, also for v >= p (K1 by R mod p)
    fr = BN254_G1.scalar
    over = [fr.p, fr.p + 5, (1 << 256) - 1, 7]
    data = b"".join(v.to_bytes(32, "little") for v in over)
    got = serde.scalars_from_bytes(fr, data, len(over), serde.SerdeFormat.RAW_BYTES_UNCHECKED, dev)
    ref = serde.scalars_from_bytes(fr, data, len(over), serde.SerdeFormat.RAW_BYTES_UNCHECKED,
                                   "cpu")
    exact(torch, "unchecked scalar read", got.cpu(), ref)
    if serde.scalars_to_bytes(fr, got, serde.SerdeFormat.RAW_BYTES_UNCHECKED) != b"".join(
            (v % fr.p).to_bytes(32, "little") for v in over):
        raise AssertionError("[14] an unchecked scalar read did not reduce mod p")
    with tempfile.TemporaryDirectory() as tmp:
        for fmt in serde.SerdeFormat:
            name = fmt.name.lower()
            path = os.path.join(tmp, f"srs_{name}.bin")
            _, walls[f"srs_write_{name}"] = timed(lambda: params.write(path, fmt), dev)
            back, walls[f"srs_read_{name}"] = timed(
                lambda: ParamsKZG.read(path, fmt, device=dev), dev)
            for part in ("g", "g_lagrange"):
                if not all(torch.equal(a, b) for a, b in zip(getattr(back, part),
                                                             getattr(params, part))):
                    raise AssertionError(f"[14] ParamsKZG {part} read back in {fmt.name} differs")
            if (back.g2, back.s_g2) != (params.g2, params.s_g2):
                raise AssertionError(f"[14] ParamsKZG G2 points read back in {fmt.name} differ")
            log(f"[14] k={params.k} ParamsKZG {fmt.name}: {os.path.getsize(path)} B, write "
                f"{walls[f'srs_write_{name}']:.3f} s, read {walls[f'srs_read_{name}']:.3f} s; "
                f"g and g_lagrange equal, limbs too")
        path = os.path.join(tmp, "srs_raw_bytes.bin")
        with open(path, "r+b") as f:
            f.seek(4 + 64 * 1000)  # the x of g[1000]
            byte = f.read(1)
            f.seek(4 + 64 * 1000)
            f.write(bytes([byte[0] ^ 1]))
        try:
            ParamsKZG.read(path, serde.SerdeFormat.RAW_BYTES, device=dev)
        except ValueError as exc:
            log(f"[14] RawBytes SRS with a flipped coordinate rejected: {exc}")
        else:
            raise AssertionError("[14] RawBytes SRS read accepted a flipped coordinate")
    return walls


def phase_bench(torch, dev, k: int = 10) -> list:
    """bench/full.py's legs at k=10: names and values checked."""
    import tempfile

    from halo2_tpu_torch.bench import full

    with tempfile.TemporaryDirectory() as tmp:
        lines = [full.bench_msm(k, 5, dev), full.bench_ntt(k, 20, dev),
                 full.bench_coset_ext(k, 10, dev)] + full.bench_prove(k, 2, tmp, dev)
    names = {line["metric"] for line in lines}
    want = {f"{leg}_k{k}" for leg in ("msm_bn254_points_per_sec", "ntt_bn254_points_per_sec",
                                      "coset_ext_points_per_sec", "keygen_wall_s",
                                      "prove_wall_s", "verify_wall_s")}
    if not want <= names or not all(line["value"] > 0 for line in lines):
        raise AssertionError(f"[14] bench/full.py at k={k}: names {sorted(names)}")
    log(f"[14] bench/full.py k={k}: {len(lines)} metrics, every value > 0")
    return lines


def phase_mock_k17(torch, counted, dev, k: int = 17) -> dict:
    """MockProver of BenchPlonkCircuit at k=17 with its columns on the card:
    verify() finds nothing; then one changed advice cell gives exactly the
    failures tamper_bench_plonk names."""
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.spec import BN254_FR
    from torch_circuits import BenchPlonkCircuit, tamper_bench_plonk

    t0 = time.perf_counter()
    prover = MockProver.run(BN254_FR, k, BenchPlonkCircuit(k, Value.known(2)), [], device=dev)
    res = {"k": k, "run_s": time.perf_counter() - t0}
    cols = prover._vec_columns()
    if not all(v.is_cuda and m.is_cuda for group in cols for v, m in group):
        raise AssertionError("[15] the vectorised MockProver columns are not on the card")
    del cols
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counted["mont_mul"].launches
    t0 = time.perf_counter()
    failures = prover.verify()
    torch.cuda.synchronize()
    res["verify_s"] = time.perf_counter() - t0
    res["k1_launches_in_verify"] = counted["mont_mul"].launches - before
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if failures:
        raise AssertionError(f"[15] k={k} MockProver: {len(failures)} failures, first {failures[0]}")
    if res["k1_launches_in_verify"] <= 0:
        raise AssertionError(f"[15] k={k} MockProver.verify() launched no K1")
    want = tamper_bench_plonk(prover, 1000)
    t0 = time.perf_counter()
    got = [(f.kind, f.row, str(f)) for f in prover.verify()]
    res["verify_tampered_s"] = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"[15] k={k} tampered cell: {got} != {want}")
    log(f"[15] (a) MockProver k={k} BenchPlonkCircuit, columns on the card: run {res['run_s']:.2f} s, "
        f"verify() {res['verify_s']:.3f} s with {res['k1_launches_in_verify']} K1 launches, "
        f"peak device memory {res['peak_gib']:.3f} GiB, satisfied; one changed cell: exactly "
        f"{[f[0] for f in got]} at row {want[0][1]} ({res['verify_tampered_s']:.3f} s)")
    return res


def phase_mock_kinds(dev) -> None:
    """Card equals host: every failure kind at k=11 (the vectorised path on
    the card against the per-row path), then the lookup at k=14."""
    import torch_circuits
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.spec import BN254_FR
    from torch_circuits import LookupRangeCircuit, failure_summary

    def out_of_table(prover):
        prover.advice[0][700] = 300

    cases = torch_circuits.failure_cases(torch_circuits, Value)
    cases["lookup_range"] = (LookupRangeCircuit(11), [], out_of_table, {"Lookup"})
    for name, (circuit, instances, tamper, kinds) in cases.items():
        prover = MockProver.run(BN254_FR, 11, circuit, instances, device=dev)
        if tamper is not None:
            tamper(prover)
        card = failure_summary(prover.verify())
        host = failure_summary(prover.verify(vectorized=False))
        if card != host or {f[0] for f in card} != kinds:
            raise AssertionError(f"[15] k=11 {name}: the card's failures differ from the host's "
                                 f"or from {sorted(kinds)}")
        log(f"[15] (b) k=11 {name}: the card's {len(card)} failures ({', '.join(sorted(kinds)) or 'none'}) "
            f"== the per-row host path's, strings included")
    t0 = time.perf_counter()
    prover = MockProver.run(BN254_FR, 14, LookupRangeCircuit(14), [], device=dev)
    if prover.verify():
        raise AssertionError("[15] k=14 LookupRangeCircuit: MockProver not satisfied")
    row = 5000
    prover.advice[0][row] = 300
    got = [(f.kind, f.row) for f in prover.verify()]
    if got != [("Lookup", row)]:
        raise AssertionError(f"[15] k=14 one value out of the table: {got}")
    log(f"[15] (c) k=14 LookupRangeCircuit: satisfied; one value out of the table: exactly one "
        f"Lookup failure at row {row}; {time.perf_counter() - t0:.2f} s")


def prove_walls(torch, profiling, params, circuit, instances, create, verify, dev,
                reps: int = 3, tag: str = "[15]") -> tuple:
    """keygen, prove and verify of one circuit: one cold run each, then
    ``reps`` warm, fenced walls, the median reported; then one more prove with
    its synced phases; (vk, proof, walls, the phases)."""
    from halo2_tpu_torch.bench.full import warm_walls
    from halo2_tpu_torch.plonk import keygen_pk, keygen_vk

    def keygen():
        vk = keygen_vk(params, circuit.without_witnesses())
        return vk, keygen_pk(params, vk, circuit.without_witnesses())

    (vk, pk), kw = warm_walls(keygen, reps, dev)
    proof, pw = warm_walls(lambda: create(pk), reps, dev)
    ok, vw = warm_walls(lambda: verify(vk, proof, instances), reps, dev)
    if ok is not True:
        raise AssertionError(f"{tag} a proof was rejected")
    walls = {name: {"median_s": statistics.median(w), "samples_s": w}
             for name, w in (("keygen", kw), ("prove", pw), ("verify", vw))}
    profiling.report(reset=True)
    create(pk)
    torch.cuda.synchronize()
    return vk, proof, walls, profiling.report(reset=True)


def phase_poseidon(torch, profiling, smi: str, dev) -> dict:
    """The Pow5 Poseidon hash circuit at K=7: BN254 over KZG/GWC against the
    pin, and the reference's bench (Pallas Fp) over IPA on Vesta."""
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.curves.spec import BN254_G1, VESTA
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.gadgets.poseidon import ConstantLength, hash_message
    from halo2_tpu_torch.plonk import create_proof, verify_proof
    from halo2_tpu_torch.poly.ipa import IPASingleStrategy, ParamsIPA
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from halo2_tpu_torch.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng
    from torch_circuits import HashCircuit, PastaHashCircuit

    k = 7
    with open(os.path.join(HERE, "tests", "data", "poseidon_gwc_k7.hex")) as f:
        expected = bytes.fromhex(f.read().strip())  # a missing pin fails: never re-pinned
    res = {}
    for name, cls, curve in (("gwc_bn254", HashCircuit, BN254_G1),
                             ("ipa_vesta", PastaHashCircuit, VESTA)):
        spec = curve.scalar
        digest = hash_message(cls.spec, ConstantLength(2), [6, 42])
        circuit = cls(Value.known([6, 42]), Value.known(digest))
        mock = MockProver.run(spec, k, circuit, [[digest]], device=dev)
        if mock.verify() or mock.verify(vectorized=True):
            raise AssertionError(f"[15] Poseidon {name}: MockProver not satisfied")
        if name == "gwc_bn254":
            params = ParamsKZG.setup(k, seed=b"poseidon-e2e", device=dev)
            opts, strategy = {}, lambda: None
            create_mo, verify_mo, seed = gwc_create_proof, gwc_verify_proof, b"poseidon-rng"
        else:
            params = ParamsIPA.setup(k, VESTA, device=dev)  # the reference's "Halo2-Parameters"
            opts, strategy = {"query_instance": True}, lambda: IPASingleStrategy(params)
            create_mo, verify_mo, seed = ipa_create_proof, ipa_verify_proof, b"poseidon-ipa-rng"

        def create(pk):
            return create_proof(params, pk, [circuit], [[[digest]]], FieldRng(spec, seed),
                                Blake2bTranscript(curve), create_mo, **opts)

        def verify(vk, proof, instances):
            return verify_proof(params, vk, instances, Blake2bTranscript(curve, proof), verify_mo,
                                strategy=strategy(), **opts)

        vk, proof, walls, phases = prove_walls(torch, profiling, params, circuit, [[[digest]]],
                                               create, verify, dev)
        if name == "gwc_bn254":
            if proof != expected:
                raise AssertionError("[15] the K=7 Poseidon GWC proof differs from its pin")
            if verify(vk, proof, [[[(digest + 1) % spec.p]]]):
                raise AssertionError("[15] the Poseidon GWC proof accepted a wrong instance")
            check = "== pinned bytes; wrong instance rejected"
        else:
            if not rejects_flipped(lambda pr: verify(vk, pr, [[[digest]]]), proof, len(proof) // 2):
                raise AssertionError("[15] the Poseidon IPA proof accepted a flipped byte")
            check = "flipped byte rejected"
        res[name] = {"proof_bytes": len(proof), **walls}
        tag = f"[15] ({'d' if name == 'gwc_bn254' else 'e'})"
        log(f"{tag} Poseidon K={k} {name}: MockProver satisfied; proof {len(proof)} B verified, "
            f"{check}; warm fenced median of 3 (s): "
            + ", ".join(f"{w} {walls[w]['median_s']:.4f}" for w in ("keygen", "prove", "verify"))
            + f"; {smi}")
        log_walls(tag, {w: walls[w]["median_s"] for w in walls}, phases)
    return res


def phase_examples(dev) -> None:
    """two_chip and shuffle on the card; circuit_layout's files against the
    strings the host renders."""
    import tempfile

    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.dev import CircuitLayout, circuit_dot_graph
    from halo2_tpu_torch.examples import circuit_layout, shuffle, two_chip
    from torch_circuits import StandardPlonkCircuit, plonk_api_common

    for name, example in (("two_chip", two_chip), ("shuffle", shuffle)):
        t0 = time.perf_counter()
        if example.main() is not True:
            raise AssertionError(f"[15] example {name} failed")
        log(f"[15] (f) example {name} on the card: {time.perf_counter() - t0:.2f} s")
    spec = BN254_G1.scalar
    _, inst, table = plonk_api_common(spec)
    circuit = StandardPlonkCircuit(Value.unknown(), table)
    want = {"layout.svg": CircuitLayout().render(spec, 5, circuit, [[inst]]),
            "circuit.dot": circuit_dot_graph(spec, circuit)}
    with tempfile.TemporaryDirectory() as out:
        circuit_layout.main(out)
        for fname, text in want.items():
            with open(os.path.join(out, fname)) as f:
                if f.read() != text:
                    raise AssertionError(f"[15] circuit_layout's {fname} differs from the host's "
                                         f"render")
    log("[15] (f) circuit_layout: layout.svg and circuit.dot == the host's render")


def mock_on_card(torch, counted, spec, k, circuit, instances, dev, tag, tamper=None) -> dict:
    """MockProver.run with the columns on the card, then the vectorised
    ``verify()`` (K1 on the card) and the per-row host path on the same
    prover: their failure lists, Display strings included, must be equal."""
    from halo2_tpu_torch.dev import MockProver
    from torch_circuits import failure_summary

    t0 = time.perf_counter()
    prover = MockProver.run(spec, k, circuit, instances, device=dev)
    res = {"k": k, "run_s": time.perf_counter() - t0}
    if tamper is not None:
        tamper(prover)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counted["mont_mul"].launches
    t0 = time.perf_counter()
    card = failure_summary(prover.verify(vectorized=True))
    torch.cuda.synchronize()
    res["verify_s"] = time.perf_counter() - t0
    res["k1_launches_in_verify"] = counted["mont_mul"].launches - before
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if res["k1_launches_in_verify"] <= 0:
        raise AssertionError(f"{tag} MockProver.verify() launched no K1")
    t0 = time.perf_counter()
    host = failure_summary(prover.verify(vectorized=False))
    res["verify_per_row_s"] = time.perf_counter() - t0
    if card != host:
        raise AssertionError(f"{tag} the card's failures differ from the per-row host path's: "
                             f"{card[:2]} != {host[:2]}")
    res["failures"] = card
    return res


def verify_stages(torch, prover) -> tuple:
    """The vectorised ``verify()`` stage by stage, in its own order, fenced:
    the assigned-cell check and the copies on the host, the gates on the
    card, the lookups' table and inputs evaluated on the card and matched
    as a host set over the usable rows.  Returns the seconds of each and the
    failures, which must equal ``verify()``'s."""
    failures, secs = [], {}
    t0 = time.perf_counter()
    prover._check_cells_assigned(failures)
    secs["cells_assigned_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols = prover._verify_gates_vec(failures)
    torch.cuda.synchronize()
    secs["gates_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prover._verify_lookups_vec(failures, cols)
    secs["lookups_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prover._check_copies(failures)
    secs["copies_s"] = time.perf_counter() - t0
    return secs, failures


def per_row_wrong_digest(k: int = 17) -> tuple:
    """(failure list, seconds) of MockProver's per-row host path for SHA-256
    "abc" at k with one flipped digest half-word: phase 16(a)'s reference,
    pure host Python over every row (40-80 s), run on the CPU in a worker
    process beside the card's phases 16(a)-(d)."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.spec import BN254_FR
    from torch_circuits import Sha256Circuit, failure_summary, sha256_instance

    bad = sha256_instance(b"abc")
    bad[0] ^= 1
    prover = MockProver.run(BN254_FR, k, Sha256Circuit.of(b"abc"), [bad], device="cpu")
    t0 = time.perf_counter()
    failures = failure_summary(prover.verify(vectorized=False))
    return failures, time.perf_counter() - t0


def phase_sha256_mock(torch, counted, dev, k: int = 17) -> tuple:
    """SHA-256 (Table16) under MockProver at k=17 with its columns on the
    card: "abc" and the reference bench's 31-block message are satisfied
    against hashlib's digest; one flipped digest half-word gives Permutation
    failures, held to the per-row path's list (``per_row_wrong_digest``) by
    the caller.  (results, the card's failure list)."""
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.spec import BN254_FR
    from halo2_tpu_torch.gadgets.sha256 import pad_message
    from torch_circuits import Sha256Circuit, failure_summary, sha256_bench_message, sha256_instance

    res = {}
    for name, msg, blocks in (("abc", b"abc", 1), ("bench_31_blocks", sha256_bench_message(), 31)):
        if len(pad_message(msg)) != blocks:
            raise AssertionError(f"[16] SHA-256 {name}: not {blocks} blocks")
        t0 = time.perf_counter()
        prover = MockProver.run(BN254_FR, k, Sha256Circuit.of(msg), [sha256_instance(msg)],
                                device=dev)
        r = {"k": k, "blocks": blocks, "run_s": time.perf_counter() - t0}
        cols = prover._vec_columns()
        if not all(v.is_cuda and m.is_cuda for group in cols for v, m in group):
            raise AssertionError("[16] the vectorised MockProver columns are not on the card")
        del cols
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counted["mont_mul"].launches
        t0 = time.perf_counter()
        failures = prover.verify()
        torch.cuda.synchronize()
        r["verify_s"] = time.perf_counter() - t0
        r["k1_launches_in_verify"] = counted["mont_mul"].launches - before
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if failures:
            raise AssertionError(f"[16] SHA-256 {name} k={k}: {len(failures)} failures, first "
                                 f"{failures[0]}")
        if r["k1_launches_in_verify"] <= 0:
            raise AssertionError(f"[16] SHA-256 {name}: MockProver.verify() launched no K1")
        stages, again = verify_stages(torch, prover)
        if again:
            raise AssertionError(f"[16] SHA-256 {name}: verify()'s stages found {again[0]}")
        r["verify_stages"] = stages
        res[name] = r
        log(f"[16] (a) SHA-256 {name} ({blocks} block{'s' * (blocks > 1)}) k={k} MockProver, "
            f"columns on the card: run {r['run_s']:.2f} s, verify() {r['verify_s']:.3f} s with "
            f"{r['k1_launches_in_verify']} K1 launches, peak device memory {r['peak_gib']:.3f} GiB; "
            f"satisfied against hashlib's digest; its stages again (s): "
            + ", ".join(f"{key[:-2]} {v:.3f}" for key, v in stages.items()))
    bad = sha256_instance(b"abc")
    bad[0] ^= 1
    prover = MockProver.run(BN254_FR, k, Sha256Circuit.of(b"abc"), [bad], device=dev)
    t0 = time.perf_counter()
    card = failure_summary(prover.verify())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if {f[0] for f in card} != {"Permutation"}:
        raise AssertionError(f"[16] SHA-256 wrong digest: the card's {card[:2]} are not "
                             f"Permutation failures")
    res["wrong_digest"] = {"verify_s": card_s, "failures": len(card)}
    return res, card


def check_wrong_digest(res: dict, card: list, per_row) -> None:
    """Phase 16(a)'s wrong digest: the card's failure list against the per-row
    host path's (``per_row``, the worker's future)."""
    host, host_s = per_row.result()
    if card != host:
        raise AssertionError(f"[16] SHA-256 wrong digest: the card's {card[:2]} != the per-row "
                             f"path's {host[:2]}")
    res["wrong_digest"]["verify_per_row_s"] = host_s
    log(f"[16] (a) SHA-256 \"abc\" with one digest half-word flipped: the card's {len(card)} "
        f"Permutation failures ({res['wrong_digest']['verify_s']:.3f} s) == the per-row host "
        f"path's ({host_s:.2f} s in a worker process beside (a)-(d)), strings included")


def phase_sha256_prove(torch, profiling, smi: str, dev, k: int = 17, reps: int = 2) -> dict:
    """The SHA-256 circuit on the reference bench's 31-block message at k=17
    over KZG/GWC with a Blake2b transcript, on the device SRS; its instance is
    hashlib's digest.  A wrong instance and a flipped byte are rejected."""
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.plonk import create_proof, verify_proof
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng
    from torch_circuits import Sha256Circuit, sha256_bench_message, sha256_instance

    msg = sha256_bench_message()
    instances = [[sha256_instance(msg)]]
    spec = BN254_G1.scalar
    t0 = time.perf_counter()
    params = ParamsKZG.setup(k, seed=b"sha256-k17", device=dev)
    params.s = None  # drop the toxic waste: verify runs the real pairing
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    circuit = Sha256Circuit.of(msg)

    def create(pk):
        return create_proof(params, pk, [circuit], instances, FieldRng(spec, b"sha256-rng"),
                            Blake2bTranscript(BN254_G1), gwc_create_proof)

    def verify(vk, proof, inst):
        return verify_proof(params, vk, inst, Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)

    torch.cuda.reset_peak_memory_stats()
    vk, proof, walls, phases = prove_walls(torch, profiling, params, circuit, instances, create,
                                           verify, dev, reps=reps, tag="[16] (b)")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    bad = [[list(instances[0][0])]]
    bad[0][0][0] ^= 1
    if verify(vk, proof, bad):
        raise AssertionError("[16] (b) the SHA-256 proof accepted a wrong instance")
    if not rejects_flipped(lambda pr: verify(vk, pr, instances), proof, len(proof) // 2):
        raise AssertionError("[16] (b) the SHA-256 proof accepted a flipped byte")
    log(f"[16] (b) SHA-256 31 blocks k={k} BN254 KZG/GWC: device SRS {setup_s:.2f} s; proof "
        f"{len(proof)} B verified through the real pairing; wrong instance and flipped byte "
        f"rejected; warm fenced median of {reps} after one cold (s): "
        + ", ".join(f"{w} {walls[w]['median_s']:.3f}" for w in ("keygen", "prove", "verify"))
        + f"; peak device memory {peak_gib:.3f} GiB; {smi}")
    log_walls("[16] (b)", {w: walls[w]["median_s"] for w in walls}, phases)
    return {"k": k, "setup_s": setup_s, "proof_bytes": len(proof), "peak_gib": peak_gib, **walls,
            "prove_phases": [list(p) for p in phases]}


def phase_ecc_mock(torch, counted, dev) -> dict:
    """The ECC gadget on Pallas Fp under MockProver, the vectorised check on
    the card against the per-row path: the add cases at k=5 (off-curve
    rejected), the variable-base mul at k=11 (a 2 in the bit column fails
    "bit boolean"), the fixed-base full-width and short muls at k=9 (an
    oversized short magnitude rejected) and the base-field-element mul at
    k=11 (a wrong point fails its synthesis); then the short range check's
    soundness regression over IPA at k=6: honest verifies, forged rejected."""
    import torch_circuits as tc
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.curves import host
    from halo2_tpu_torch.curves.spec import PALLAS
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.spec import PASTA_FP
    from halo2_tpu_torch.gadgets.ecc.mul_fixed import FQ

    t0 = time.perf_counter()
    cases = [(f"add {name}", 5, circuit, None, name == "off_curve")
             for name, circuit in tc.add_cases().items()]
    mul = tc.MulCircuit(Value.known(tc.VAR_MUL_SCALAR), Value.known(tc.G),
                        host.mul(PALLAS, tc.G, tc.VAR_MUL_SCALAR))
    cases += [("variable-base mul", 11, mul, None, False),
              ("variable-base mul, bit 2", 11, mul, tc.flip_mul_bit, True),
              ("fixed-base full width", 9, tc.fixed_mul_full(0xABCDEF0123456789), None, False),
              ("fixed-base full width q-1", 9, tc.fixed_mul_full(FQ - 1), None, False),
              ("fixed-base full width 2^254+", 9, tc.fixed_mul_full((1 << 254) + 12345), None,
               False),
              ("fixed-base short +", 9, tc.fixed_mul_short(0xFFFFFFFFFFFFFFFF, 1), None, False),
              ("fixed-base short -", 9, tc.fixed_mul_short(12345678, -1), None, False),
              ("fixed-base short oversized", 9, tc.FixedMulCircuit(
                  Value.known(((1 << 64) + 3, 1)), None, short=True), None, True),
              ("base-field element", 11, tc.BaseFieldMulCircuit.of(0x123456789ABCDEF), None,
               False),
              ("base-field element p-1", 11, tc.BaseFieldMulCircuit.of(PASTA_FP.p - 1), None,
               False)]
    res = {}
    for name, k, circuit, tamper, rejected in cases:
        r = mock_on_card(torch, counted, PASTA_FP, k, circuit, [], dev, f"[16] (c) {name}", tamper)
        if bool(r["failures"]) != rejected:
            raise AssertionError(f"[16] (c) {name}: {len(r['failures'])} failures, expected "
                                 f"{'some' if rejected else 'none'}")
        if tamper is tc.flip_mul_bit and ("ConstraintNotSatisfied", "bit boolean") not in {
                (f[0], f[2]) for f in r["failures"]}:
            raise AssertionError("[16] (c) the flipped bit did not fail \"bit boolean\"")
        res[name] = {k_: v for k_, v in r.items() if k_ != "failures"} | {
            "failures": len(r["failures"])}
        log(f"[16] (c) ECC {name} k={k}: {'rejected, ' if rejected else 'satisfied, '}"
            f"the card's {len(r['failures'])} failures == the per-row path's; run "
            f"{r['run_s']:.2f} s, verify() {r['verify_s']:.3f} s ({r['k1_launches_in_verify']} "
            f"K1), per row {r['verify_per_row_s']:.2f} s")
    try:
        MockProver.run(PASTA_FP, 11, tc.BaseFieldMulCircuit.of(67890, host.mul(
            PALLAS, tc.FIXED_BASE, 12345)), [], device=dev)
    except AssertionError:
        pass
    else:
        raise AssertionError("[16] (c) the base-field mul accepted a wrong point")
    res["soundness_ipa_k6"] = phase_soundness(dev)
    log(f"[16] (c) base-field element with a wrong point: synthesis rejects it; ECC "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def phase_soundness(dev) -> dict:
    """tests/test_soundness_regressions.py on the card: the short range
    check at k=6 over IPA (Pallas, seeded SRS); the honest proof verifies, the
    forged multiplier's proof is rejected."""
    import torch_circuits as tc
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu_torch.poly.ipa import IPASingleStrategy, ParamsIPA
    from halo2_tpu_torch.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng

    t0 = time.perf_counter()
    params = ParamsIPA.setup(6, seed=b"soundness-test", device=dev)
    empty = tc.ShortCheckCircuit(Value.unknown())
    vk = keygen_vk(params, empty)
    pk = keygen_pk(params, vk, empty)
    verdicts = {}
    for name, circuit in (("honest", tc.ShortCheckCircuit(Value.known(5))),
                          ("forged", tc.ForgedShortCheckCircuit(Value.unknown()))):
        proof = create_proof(params, pk, [circuit], [[]],
                             FieldRng(params.curve.scalar, b"soundness-rng"),
                             Blake2bTranscript(params.curve), ipa_create_proof,
                             query_instance=True)
        verdicts[name] = verify_proof(params, vk, [[]], Blake2bTranscript(params.curve, proof),
                                      ipa_verify_proof, query_instance=True,
                                      strategy=IPASingleStrategy(params))
    if verdicts != {"honest": True, "forged": False}:
        raise AssertionError(f"[16] (c) soundness regression: {verdicts}")
    wall = time.perf_counter() - t0
    log(f"[16] (c) short range check k=6 over IPA: honest proof verifies, forged multiplier "
        f"rejected; {wall:.2f} s")
    return {"wall_s": wall}


def sinsemilla_cell(torch, counted, profiling, smi: str, dev, name: str, k: int, circuit,
                    seed: bytes, reps: int = 2) -> tuple:
    """One Sinsemilla circuit with equality on ``witness_pieces``, on Pallas
    Fp over IPA on Vesta (the reference's SRS): MockProver (card == host)
    satisfied, then keygen, prove and verify with their walls; a flipped byte
    rejected.  (the cell's numbers, the verifying key)."""
    from halo2_tpu_torch.curves.spec import VESTA
    from halo2_tpu_torch.fields.spec import PASTA_FP
    from halo2_tpu_torch.plonk import create_proof, verify_proof
    from halo2_tpu_torch.poly.ipa import IPASingleStrategy, ParamsIPA
    from halo2_tpu_torch.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng

    tag = f"[16] (d) {name}"
    mock = mock_on_card(torch, counted, PASTA_FP, k, circuit, [], dev, tag)
    if mock["failures"]:
        raise AssertionError(f"{tag}: MockProver not satisfied")
    t0 = time.perf_counter()
    params = ParamsIPA.setup(k, VESTA, device=dev)  # the reference's "Halo2-Parameters"
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def create(pk):
        return create_proof(params, pk, [circuit], [[]], FieldRng(VESTA.scalar, seed),
                            Blake2bTranscript(VESTA), ipa_create_proof, query_instance=True)

    def verify(vk, proof, inst):
        return verify_proof(params, vk, inst, Blake2bTranscript(VESTA, proof), ipa_verify_proof,
                            query_instance=True, strategy=IPASingleStrategy(params))

    torch.cuda.reset_peak_memory_stats()
    vk, proof, walls, phases = prove_walls(torch, profiling, params, circuit, [[]], create, verify,
                                           dev, reps=reps, tag=tag)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not rejects_flipped(lambda pr: verify(vk, pr, [[]]), proof, len(proof) // 2):
        raise AssertionError(f"{tag}: a flipped byte was accepted")
    log(f"{tag} k={k} over Vesta IPA: MockProver satisfied (run {mock['run_s']:.2f} s, the "
        f"card's verify() {mock['verify_s']:.3f} s == per row); SRS {setup_s:.2f} s; proof "
        f"{len(proof)} B verified, flipped byte rejected; warm fenced median of {reps} after "
        f"one cold (s): "
        + ", ".join(f"{w} {walls[w]['median_s']:.3f}" for w in ("keygen", "prove", "verify"))
        + f"; peak device memory {peak_gib:.3f} GiB; {smi}")
    log_walls(tag, {w: walls[w]["median_s"] for w in walls}, phases)
    return {"k": k, "setup_s": setup_s, "proof_bytes": len(proof), "peak_gib": peak_gib,
            "mock_run_s": mock["run_s"], "mock_verify_s": mock["verify_s"],
            "prove_phases": [list(p) for p in phases], **walls}, vk


def phase_sinsemilla(torch, counted, profiling, smi: str, dev) -> dict:
    """Sinsemilla on Pallas Fp over IPA on Vesta: the commit circuit
    (Sinsemilla hash + ECC fixed-base mul) at k=11, its verifying key's
    ``transcript_repr`` equal to the JAX package's pin
    ``sinsemilla_commit_ipa_k11.vk``; the Merkle path at depth 32 (the
    reference's MERKLE_DEPTH) at k=12."""
    import torch_circuits as tc

    with open(os.path.join(HERE, "tests", "data", "sinsemilla_commit_ipa_k11.vk")) as f:
        expected = int(f.read().strip(), 16)  # a missing pin fails: never re-pinned
    res = {}
    res["commit"], vk = sinsemilla_cell(torch, counted, profiling, smi, dev, "commit", 11,
                                        tc.ProvedCommitCircuit.of(), b"sinsemilla-rng")
    if vk.transcript_repr != expected:
        raise AssertionError(f"[16] (d) the Sinsemilla commit vk's transcript_repr "
                             f"{vk.transcript_repr:#x} differs from its pin {expected:#x}")
    log(f"[16] (d) commit: the verifying key's transcript_repr == the JAX package's pin "
        f"({expected:#x})")
    res["merkle_depth32"], _ = sinsemilla_cell(torch, counted, profiling, smi, dev,
                                               "merkle_depth32", 12, tc.ProvedMerkleCircuit.of(32),
                                               b"merkle-rng")
    return res


PARALLEL_D = (2, 4, 8)


def card_meshes(torch, sizes=PARALLEL_D) -> dict:
    """A mesh of each size over the visible cards in turn: distinct cards up
    to their count, then repeats (on one card, cuda:0 d times).  A mesh device
    that is not a card raises."""
    from halo2_tpu_torch.parallel import default_mesh

    count = torch.cuda.device_count()
    meshes = {}
    for d in sizes:
        mesh = default_mesh(d, [torch.device("cuda", i % count) for i in range(d)])
        if any(dev.type != "cuda" for dev in mesh.devices):
            raise AssertionError(f"[17] mesh of {d}: {mesh.devices} holds a device that is no card")
        meshes[d] = mesh
        log(f"[17] mesh of {d}: " + (f"{d} distinct cards" if len(mesh.distinct) == d else
                                     f"{len(mesh.distinct)} distinct card(s), repeated: "
                                     + ", ".join(map(str, mesh.devices))))
    return meshes


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() on a mesh: one warm-up, then ``reps`` calls
    between two synchronizes of every card (host clock)."""
    fn()
    sync_all(torch)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all(torch)
    return (time.perf_counter() - t0) * 1e3 / reps


def per_call(counted, fn) -> tuple:
    """(fn(), the launches of each counted kernel during it): the counters
    keep counting for the phase."""
    before = {name: f.launches for name, f in counted.items()}
    out = fn()
    return out, {name: f.launches - before[name] for name, f in counted.items()
                 if f.launches != before[name]}


def random_limbs(torch, spec, shape, rs, dev):
    """Montgomery limbs of random elements below p (numpy, no host ints)."""
    raw = rs.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
    raw[15] %= spec.p >> 240
    return torch.from_numpy(raw.astype(np.int32)).to(dev)


def phase_parallel_kernels(torch, counted, meshes, params, rs, dev,
                           ntt_ks=(16, 18), msm_k: int = 16, m: int = 4) -> dict:
    """(a) the sharded NTT, iNTT and MSM against the one-device ones, exact:
    BN254 Fr sharded_ntt / sharded_intt at 2^k for ``ntt_ks`` against
    ntt_sixstep / intt_sixstep, sharded_msm and sharded_msm_many (m columns)
    at 2^msm_k over ``params``' Lagrange SRS against msm / msm_many in
    affine form, each for every mesh; the gather path once (n = 2^5, D = 8).
    Times on the host clock between synchronizes, sharded beside one device;
    each kernel's launches in one sharded call."""
    from halo2_tpu_torch.curves.point import Point, to_affine_ints
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.fields import limb
    from halo2_tpu_torch.ops import msm as msm_ops
    from halo2_tpu_torch.ops import ntt as ntt_ops
    from halo2_tpu_torch.parallel import sharded_intt, sharded_msm, sharded_msm_many, sharded_ntt

    curve = BN254_G1
    fr = curve.scalar
    res = {"ntt": [], "msm": []}
    for k in (5,) + tuple(ntt_ks):
        n = 1 << k
        omega = pow(fr.root_of_unity, 1 << (fr.s - k), fr.p)
        inv = pow(omega, -1, fr.p)
        tw, tw_inv = (ntt_ops.power_table(fr, w, n // 2, dev) for w in (omega, inv))
        wc, wc_inv = (ntt_ops.cross_twiddles(fr, w, k, dev) for w in (omega, inv))
        n_inv = limb.from_int(fr, pow(n, -1, fr.p), dev)
        a = random_limbs(torch, fr, (n,), rs, dev)
        want = ntt_ops.ntt_sixstep(fr, a, tw, wc, k)
        want_inv = ntt_ops.intt_sixstep(fr, a, tw_inv, wc_inv, k, n_inv)
        one_ms = mesh_ms(torch, lambda: ntt_ops.ntt_sixstep(fr, a, tw, wc, k), 3)
        one_inv_ms = mesh_ms(torch, lambda: ntt_ops.intt_sixstep(fr, a, tw_inv, wc_inv, k, n_inv), 3)
        for d in ((8,) if k == 5 else PARALLEL_D):
            mesh = meshes[d]
            got, launches = per_call(counted, lambda: sharded_ntt(fr, a, k, omega, mesh))
            exact(torch, f"[17] sharded_ntt n=2^{k} D={d}", got, want)
            back, inv_launches = per_call(counted, lambda: sharded_intt(fr, a, k, omega, mesh))
            exact(torch, f"[17] sharded_intt n=2^{k} D={d}", back, want_inv)
            exact(torch, f"[17] sharded_intt(sharded_ntt) n=2^{k} D={d}",
                  sharded_intt(fr, got, k, omega, mesh), a)
            r = {"n": n, "D": d, "path": "gather" if n < d * d else "four-step",
                 "ms": mesh_ms(torch, lambda: sharded_ntt(fr, a, k, omega, mesh), 2),
                 "one_device_ms": one_ms, "launches": launches,
                 "intt_ms": mesh_ms(torch, lambda: sharded_intt(fr, a, k, omega, mesh), 2),
                 "intt_one_device_ms": one_inv_ms, "intt_launches": inv_launches}
            res["ntt"].append(r)
            log(f"[17] (a) sharded_ntt / sharded_intt n=2^{k} D={d} ({r['path']}): exact against "
                f"ntt_sixstep / intt_sixstep, round trip exact; {r['ms']:.2f} / {r['intt_ms']:.2f} "
                f"ms against one device {one_ms:.2f} / {one_inv_ms:.2f} ms; launches per call "
                f"{launches}")
    n = 1 << msm_k
    pts = Point(*(c[:, :n] for c in params.g_lagrange))
    scal = random_limbs(torch, fr, (m, n), rs, dev).transpose(0, 1).contiguous()  # (m, 16, n)
    want = to_affine_ints(curve, msm_ops.msm_many(curve, scal, pts))
    want1 = to_affine_ints(curve, msm_ops.msm(curve, scal[0], pts))
    one_ms = mesh_ms(torch, lambda: msm_ops.msm_many(curve, scal, pts), 3)
    one1_ms = mesh_ms(torch, lambda: msm_ops.msm(curve, scal[0], pts), 3)
    for d in PARALLEL_D:
        mesh = meshes[d]
        got, launches = per_call(counted, lambda: sharded_msm_many(curve, scal, pts, mesh))
        got1, launches1 = per_call(counted, lambda: sharded_msm(curve, scal[0], pts, mesh))
        if to_affine_ints(curve, got) != want or to_affine_ints(curve, got1) != want1:
            raise AssertionError(f"[17] sharded_msm(_many) n=2^{msm_k} D={d}: differs from one device")
        for name in ("ec_add",) + MSM_KERNELS + ("ec_horner",):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"[17] sharded_msm_many D={d}: {name} was not launched")
        r = {"n": n, "m": m, "D": d,
             "ms": mesh_ms(torch, lambda: sharded_msm_many(curve, scal, pts, mesh), 3),
             "one_device_ms": one_ms, "launches": launches,
             "m1_ms": mesh_ms(torch, lambda: sharded_msm(curve, scal[0], pts, mesh), 3),
             "m1_one_device_ms": one1_ms, "m1_launches": launches1}
        res["msm"].append(r)
        log(f"[17] (a) sharded_msm_many (m={m}) / sharded_msm n=2^{msm_k} D={d}: equal to msm_many / "
            f"msm in affine form; {r['ms']:.2f} / {r['m1_ms']:.2f} ms against one device "
            f"{one_ms:.2f} / {one1_ms:.2f} ms; launches per call {launches} / {launches1}")
    return res


def phase_parallel_dryrun(meshes) -> dict:
    """(b) entry.dryrun_multichip on every mesh: the k=6 proof equal to the pin."""
    from halo2_tpu_torch import entry

    walls = {}
    for d, mesh in meshes.items():
        t0 = time.perf_counter()
        entry.dryrun_multichip(d, devices=list(mesh.devices), log=lambda msg: log("[17] (b) " + msg))
        walls[d] = time.perf_counter() - t0
    return walls


def phase_parallel_prove(torch, mesh, params, reps: int = 2) -> dict:
    """(c) BenchPlonkCircuit at ``params.k`` over KZG/GWC and Blake2b, sharded over
    ``mesh`` and on one device: equal transcript_repr and proof bytes, the
    sharded proof verified through the real pairing and a flipped byte
    rejected, the sharded keys proved once more without a mesh give the same
    bytes and leave no mesh on the params or the domain; keygen and prove walls
    warm, fenced on every card, the median of ``reps`` after one cold run,
    and each side's peak device memory (also above what was held before it:
    the SRS, and the sharded side's keys); the bytes one sharded prove moves
    between shards."""
    from halo2_tpu_torch.circuit import Value
    from halo2_tpu_torch.curves.spec import BN254_G1
    from halo2_tpu_torch.parallel import mesh as mesh_mod
    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng
    from torch_circuits import BenchPlonkCircuit

    spec, k = BN254_G1.scalar, params.k
    circuit = BenchPlonkCircuit(k, Value.known(0x2B3C4D5E6F | k))
    res = {"k": k, "D": mesh.size, "devices": [str(x) for x in mesh.devices]}

    def fenced(fn):
        sync_all(torch)
        t0 = time.perf_counter()
        out = fn()
        sync_all(torch)
        return out, time.perf_counter() - t0

    out = {}
    for side, m in (("sharded", mesh), ("one_device", None)):
        sync_all(torch)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the SRS, and the other side's keys

        def keygen():
            vk = keygen_vk(params, circuit.without_witnesses(), mesh=m)
            return vk, keygen_pk(params, vk, circuit.without_witnesses(), mesh=m)

        def prove():
            return create_proof(params, pk, [circuit], [[]], FieldRng(spec, b"bench-prove-rng"),
                                Blake2bTranscript(BN254_G1), gwc_create_proof, mesh=m)

        kw, pw = [], []
        for _ in range(reps + 1):
            (vk, pk), wall = fenced(keygen)
            kw.append(wall)
        for i in range(reps + 1):
            if m is not None and i == reps:
                mesh_mod.traffic.update(bytes=0, copies=0)
            proof, wall = fenced(prove)
            pw.append(wall)
        if m is not None:
            res["prove_exchanged"] = dict(mesh_mod.traffic)
        out[side] = (vk, pk, proof)
        res[side] = {"keygen_s": statistics.median(kw[1:]), "keygen_cold_s": kw[0],
                     "keygen_samples_s": kw[1:], "prove_s": statistics.median(pw[1:]),
                     "prove_cold_s": pw[0], "prove_samples_s": pw[1:],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "peak_above_held_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}
    (vk_s, pk_s, proof_s), (vk_1, _, proof_1) = out["sharded"], out["one_device"]
    if vk_s.transcript_repr != vk_1.transcript_repr:
        raise AssertionError(f"[17] (c) k={k} sharded keygen: another transcript_repr")
    if proof_s != proof_1:
        raise AssertionError(f"[17] (c) k={k} the sharded proof differs from the one-device proof")
    # the sharded keys, proved once more without a mesh: none may stick
    again = create_proof(params, pk_s, [circuit], [[]], FieldRng(spec, b"bench-prove-rng"),
                         Blake2bTranscript(BN254_G1), gwc_create_proof)
    if params.mesh is not None or pk_s.vk.domain.mesh is not None or again != proof_s:
        raise AssertionError("[17] (c) a mesh stuck to the params or the domain after a prove "
                             "without one")

    def verify(pr):
        return verify_proof(params, vk_s, [[]], Blake2bTranscript(BN254_G1, pr), gwc_verify_proof)

    if verify(proof_s) is not True:
        raise AssertionError(f"[17] (c) k={k} the sharded proof was rejected")
    if not rejects_flipped(verify, proof_s, len(proof_s) // 2):
        raise AssertionError(f"[17] (c) k={k} the sharded proof with a flipped byte was accepted")
    res["proof_bytes"] = len(proof_s)
    log(f"[17] (c) BenchPlonkCircuit k={k} KZG/GWC sharded over {mesh.size} shards "
        f"({len(mesh.distinct)} distinct card(s)): transcript_repr and proof bytes "
        f"({len(proof_s)} B) equal to one device; verified through the real pairing, flipped byte "
        f"rejected; the sharded keys proved without a mesh: the same bytes, no mesh left")
    for side in ("sharded", "one_device"):
        r = res[side]
        log(f"[17] (c) {side}: keygen {r['keygen_s']:.3f} s (cold {r['keygen_cold_s']:.3f}), "
            f"prove {r['prove_s']:.3f} s (cold {r['prove_cold_s']:.3f}), warm median of {reps}; "
            f"peak device memory {r['peak_gib']:.3f} GiB, {r['peak_above_held_gib']:.3f} GiB above "
            f"what was held before it")
    log(f"[17] (c) one warm sharded prove exchanged {res['prove_exchanged']['bytes']} bytes "
        f"between shards in {res['prove_exchanged']['copies']} copies")
    return res


def phase_parallel_scaling(meshes) -> list:
    """(d) bench.full.bench_scaling at k=12 on meshes of the visible cards in turn."""
    from halo2_tpu_torch.bench import full

    lines = full.bench_scaling(k=12, reps=3, devices=list(meshes[8].devices))
    names = [line["metric"] for line in lines]
    if names != [f"scaling_efficiency_{d}dev" for d in PARALLEL_D] or not all(
            line["value"] > 0 and "distinct_devices" in line for line in lines):
        raise AssertionError(f"[17] (d) bench_scaling lines {names}")
    log(f"[17] (d) bench_scaling k=12: T_1 {lines[0]['t1_s'] * 1e3:.2f} ms, "
        + ", ".join(f"T_{line['devices'].__len__()} {line['td_s'] * 1e3:.2f} ms"
                    for line in lines)
        + f"; {lines[0]['distinct_devices']}-{lines[-1]['distinct_devices']} distinct device(s)")
    return lines


class PlainOnCard:
    """Counts the calls, with a tensor on the card, of plain versions that
    their wrappers call by name (``field_add_plain`` and the like): on the
    main path every such call would be a kernel not taken."""

    def __init__(self, targets):
        self.calls = {}
        for mod, name in targets:
            orig = getattr(mod, name)

            def counted(*args, _orig=orig, _name=name, **kwargs):
                if any(getattr(a, "is_cuda", False) for a in args):
                    self.calls[_name] += 1
                return _orig(*args, **kwargs)

            setattr(mod, name, counted)
            self.calls[name] = 0

    def reset(self) -> None:
        for name in self.calls:
            self.calls[name] = 0


def special_limbs(torch, limb, spec, n: int, rs, dev):
    """(16, n) Montgomery limbs of random elements with 0, 1 and p-1 in front."""
    a = random_limbs(torch, spec, (n,), rs, dev)
    a[:, :3] = limb.from_ints(spec, [0, 1, spec.p - 1], dev)
    return a


def phase_field_entries(torch, limb, field_ops, mm, spec, rs, dev, peaks,
                        ns=(1 << 15, 1 << 16, 1 << 21)) -> dict:
    """K1's field entries against their plain chains at widths ``ns``, with
    both operands full and with one of one element (stride 0); and K1 itself
    with such an operand.  Exact; CUDA-event times."""
    res = {name: {"shapes": [], "max_abs_err": 0}
           for name in ("field_add", "field_sub", "field_neg", "mont_mul_broadcast")}
    for n in ns:
        a = special_limbs(torch, limb, spec, n, rs, dev)
        b = special_limbs(torch, limb, spec, n, rs, dev).flip(1).contiguous()
        one = b[:, 7:8]  # one element of a wider array: limb stride n
        cases = [("field_add", field_ops.field_add, field_ops.field_add_plain, (a, b), 192, 0),
                 ("field_add", field_ops.field_add, field_ops.field_add_plain, (a, one), 128, 0),
                 ("field_sub", field_ops.field_sub, field_ops.field_sub_plain, (a, b), 192, 0),
                 ("field_sub", field_ops.field_sub, field_ops.field_sub_plain, (one, a), 128, 0),
                 ("field_neg", field_ops.field_neg, field_ops.field_neg_plain, (a,), 128, 0),
                 ("mont_mul_broadcast", mm.mont_mul, mm.mont_mul_plain, (a, one), 128,
                  PRODUCT_MULS)]
        for name, kern, plain, args, per_elem, muls in cases:
            err = exact(torch, f"[18] {name} {spec.name} n={n}", kern(spec, *args),
                        plain(spec, *args))
            ms = cuda_ms(lambda: kern(spec, *args), 50)
            plain_ms = cuda_ms(lambda: plain(spec, *args), 3)
            ms2 = cuda_ms(lambda: kern(spec, *args), 50)
            r = {"n": n, "broadcast": args[-1] is one or args[0] is one, "ms": min(ms, ms2),
                 "plain_ms": plain_ms, **bound(peaks, per_elem * n, muls * n)}
            res[name]["shapes"].append(r)
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            log(f"[18] {name} {spec.name} n=2^{n.bit_length() - 1}"
                f"{' (one operand of one element)' if r['broadcast'] else ''}: exact; kernel "
                f"{ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.3f} ms, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})")
    return res


def stockham_bound(peaks, m: int, b: int) -> dict:
    """Read and write each element once (64 B each), read the twiddle table;
    k m/2 products per column."""
    k = m.bit_length() - 1
    return bound(peaks, 128 * m * b + 64 * (m // 2), PRODUCT_MULS * k * (m // 2) * b)


def sixstep_bound(peaks, k: int) -> dict:
    """The six-step at 2^k as one function: read the input and the (16, n2,
    n1) cross-twiddle table once, write the output once (64 B an element
    each), read the two axis tables; k n/2 + n products."""
    n = 1 << k
    n1, n2 = 1 << (k // 2), 1 << (k - k // 2)
    return bound(peaks, 192 * n + 64 * (n1 // 2 + n2 // 2), PRODUCT_MULS * (k * n // 2 + n))


def phase_stockham(torch, limb, ntt_ops, spec, rs, dev, peaks,
                   shapes=((1 << 8, 1 << 7), (1 << 7, 1 << 8), (1 << 8, 1 << 8),
                           (1 << 11, 1 << 10), (1, 1 << 14), (2, 1 << 14)),
                   sixstep_ks=(15, 16)) -> dict:
    """K1's transform entry against the plain stage loop on (16, m, B) at the
    six-step's axis shapes (2^15: 2^8 x 2^7 then 2^7 x 2^8; 2^16; the 2^21
    of k=20's extended domain: 2^11 x 2^10; m = 1 and 2, the axes of the
    smallest domains; the first shape heads the kernels line), then the six-step at 2^15 and
    2^16 on it against the six-step on the plain loop.  Exact; CUDA events."""
    res = {"shapes": [], "max_abs_err": 0, "sixstep": []}
    for m, b in shapes:
        k = m.bit_length() - 1
        x = special_limbs(torch, limb, spec, m * b, rs, dev).reshape(16, m, b)
        omega = pow(spec.root_of_unity, 1 << (spec.s - k), spec.p)
        tw = ntt_ops.power_table(spec, omega, m // 2, dev)
        err = exact(torch, f"[18] stockham_axis m={m} B={b}", ntt_ops.stockham_axis(spec, x, tw, k),
                    ntt_ops.stockham_axis_plain(spec, x, tw, k))
        ms = cuda_ms(lambda: ntt_ops.stockham_axis(spec, x, tw, k), 20)
        plain_ms = cuda_ms(lambda: ntt_ops.stockham_axis_plain(spec, x, tw, k), 3)
        ms2 = cuda_ms(lambda: ntt_ops.stockham_axis(spec, x, tw, k), 20)
        r = {"m": m, "B": b, "ms": min(ms, ms2), "plain_ms": plain_ms,
             **stockham_bound(peaks, m, b)}
        res["shapes"].append(r)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        log(f"[18] stockham_axis {spec.name} m={m} B={b}: exact; kernel {ms:.4f} / {ms2:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    kernel_axis = ntt_ops.stockham_axis
    for k in sixstep_ks:
        n = 1 << k
        omega = pow(spec.root_of_unity, 1 << (spec.s - k), spec.p)
        tw = ntt_ops.power_table(spec, omega, n // 2, dev)
        wc = ntt_ops.cross_twiddles(spec, omega, k, dev)
        axes = ntt_ops.sixstep_twiddles(tw, k)
        a = special_limbs(torch, limb, spec, n, rs, dev)

        def sixstep():
            return ntt_ops.ntt_sixstep(spec, a, tw, wc, k, axes)

        got = sixstep()
        ms = cuda_ms(sixstep, 20)
        ntt_ops.stockham_axis = ntt_ops.stockham_axis_plain  # the same six-step on the plain loop
        try:
            want = sixstep()
            plain_ms = cuda_ms(sixstep, 3)
        finally:
            ntt_ops.stockham_axis = kernel_axis
        ms2 = cuda_ms(sixstep, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            sixstep()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 20
        err = exact(torch, f"[18] ntt_sixstep n=2^{k}", got, want)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        r = {"n": n, "ms": min(ms, ms2), "plain_ms": plain_ms, "host_wall_ms": wall_ms,
             **sixstep_bound(peaks, k)}
        res["sixstep"].append(r)
        log(f"[18] ntt_sixstep n=2^{k} on stockham_axis: exact against the plain stage loop; "
            f"{ms:.4f} / {ms2:.4f} ms (host wall {wall_ms:.4f} ms), plain {plain_ms:.3f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return res


def main() -> None:
    import torch

    t_start = time.perf_counter()

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
    from halo2_tpu_torch.curves.spec import BN254_G1, PALLAS, VESTA
    from halo2_tpu_torch.fields import field_ops, limb
    from halo2_tpu_torch.fields import mont_mul as mont_mul_mod
    from halo2_tpu_torch.fields.spec import BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ
    from halo2_tpu_torch.ops import msm as msm_ops
    from halo2_tpu_torch.ops import ntt as ntt_ops
    from halo2_tpu_torch.poly import ipa as ipa_mod
    from halo2_tpu_torch.poly import kzg as kzg_mod

    calls = {"finv": CallCounter("finv", [limb]),
             "msm_many": CallCounter("msm_many", [msm_ops, kzg_mod, ipa_mod],
                                     batch_of=lambda args: int(args[1].shape[0]))}

    # ---- 2: build -----------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    log(f"[2] kernels built/loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.build_seconds:.2f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("    ptxas: " + line.strip())
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    peaks = {"int32_per_sec": roofline.arch_int32_per_sec(sms, clock_mhz)}
    log(f"[2] bounds: {sms} SMs x 64 lanes x {clock_mhz:.0f} MHz = "
        f"{peaks['int32_per_sec']:.4e} 32-bit multiply-adds/s; HBM {HBM_BYTES_PER_SEC:.3e} B/s")

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
        "mont_pow": mont_mul_mod.mont_pow, "ec_scalar_mul": ec.ec_scalar_mul,
        "ec_horner": ec.ec_horner, "mont_mul_tiled": mont_mul_mod.mont_mul_tiled,
        "int_muladd": ic.int_muladd_chain, "int_addmask": ic.int_addmask_chain,
        "msm_digits": msm_ops.msm_digits, "ec_window_table": msm_ops.ec_window_table,
        "ec_window_fold": msm_ops.ec_window_fold,
        "field_add": field_ops.field_add, "field_sub": field_ops.field_sub,
        "field_neg": field_ops.field_neg, "stockham_axis": ntt_ops.stockham_axis,
    }
    plain_on_card = PlainOnCard(
        [(field_ops, "field_add_plain"), (field_ops, "field_sub_plain"),
         (field_ops, "field_neg_plain"), (ntt_ops, "stockham_axis_plain"),
         (mont_mul_mod, "mont_mul_plain")])
    os.environ["HALO2_TPU_PROFILE"] = "1"
    start_counting(torch, counted, calls.values())
    plain_on_card.reset()
    def prove6(key):
        return create_proof(params, key, [bench], [[]], FieldRng(spec, b"bench-prove-rng"),
                            Blake2bTranscript(BN254_G1), gwc_create_proof)

    vk, pk, proof, walls, phases = keygen_and_prove(torch, profiling, params, bench, prove6)

    def verify(pr):
        return verify_proof(params, vk, [[]], Blake2bTranscript(BN254_G1, pr), gwc_verify_proof)

    t0 = time.perf_counter()
    ok = verify(proof)
    walls["verify"] = time.perf_counter() - t0
    launches = read_counts(torch, counted, "[6] keygen + 2 proves + verify:", calls,
                           PATH_KERNELS + ENTRY_KERNELS)
    log(f"[6] plain versions called on the card: {plain_on_card.calls}")
    if any(plain_on_card.calls.values()):
        raise AssertionError(f"[6] a plain version ran on a CUDA tensor: {plain_on_card.calls}")
    commit_m = calls["msm_many"].max_batch
    for kern, fn in (("mont_pow", "finv"), ("ec_horner", "msm_many")):
        if launches[kern] != calls[fn].calls:
            raise AssertionError(f"[6] {kern} launches {launches[kern]} != {fn} calls "
                                 f"{calls[fn].calls}: a chain did not run as one launch")
    log(f"[6] one launch per chain: mont_pow {launches['mont_pow']} = finv calls, "
        f"ec_horner {launches['ec_horner']} = msm_many calls (largest m {commit_m})")
    check_msm_launches("[6]", launches, calls)
    if launches["ec_add"] or launches["ec_double"]:
        raise AssertionError(f"[6] standalone K2 / K3 launched ({launches['ec_add']}, "
                             f"{launches['ec_double']}): every MSM add belongs to its entries")
    if ok is not True:
        raise AssertionError(f"k={k} proof rejected")
    if not rejects_flipped(verify, proof, len(proof) // 2):
        raise AssertionError(f"k={k} proof with a flipped byte accepted")
    log(f"[6] k={k} BenchPlonkCircuit: proof {len(proof)} B accepted through the real "
        f"pairing; flipped byte rejected")
    log_walls("[6]", walls, phases)

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

    # ---- 9: the kernels on the Pasta moduli; the device KZG setup ------------
    pasta_k1 = {s.name: phase_k1(torch, limb, mont_mul_mod, s, rs, dev, "[9]")
                for s in (PASTA_FP, PASTA_FQ)}
    pasta_ec = {c.name: phase_ec(torch, point_mod, ec, c, rs, dev, "[9]") for c in (PALLAS, VESTA)}
    t0 = time.perf_counter()
    dev_params = ParamsKZG.setup(k, seed=b"bench-prove", device=dev)
    torch.cuda.synchronize()
    dev_setup_s = time.perf_counter() - t0
    for name in ("g", "g_lagrange"):
        ours, theirs = getattr(dev_params, name), getattr(params, name)
        if (point_mod.to_affine_ints(BN254_G1, ours) != point_mod.to_affine_ints(BN254_G1, theirs)
                or not all(torch.equal(a, b) for a, b in zip(ours, theirs))):
            raise AssertionError(f"k={k} device ParamsKZG.setup {name} differs from setup_host")
    if dev_params.s_g2 != params.s_g2:
        raise AssertionError(f"k={k} device ParamsKZG.setup s_g2 differs from setup_host")
    log(f"[9] k={k} ParamsKZG.setup on the card == setup_host: affine g and g_lagrange, limbs "
        f"too; device {dev_setup_s:.2f} s, host {setup_s:.2f} s (phase 6)")
    del dev_params

    # ---- 10: the pins; lookups + SHPLONK at k=14 -------------------------------
    start_counting(torch, counted, calls.values())
    phase_pins(torch, dev)
    phase_lookup(torch, profiling, params, dev)
    launches10 = read_counts(torch, counted, "[10]", calls, PATH_KERNELS + ("ec_add",))
    check_msm_launches("[10]", launches10, calls)

    # ---- 11: IPA at k=14 ---------------------------------------------------------
    start_counting(torch, counted, calls.values())
    phase_ipa(torch, profiling, dev)
    launches11 = read_counts(torch, counted, "[11]", calls,
                             PATH_KERNELS + ("ec_add", "ec_scalar_mul"))
    check_msm_launches("[11]", launches11, calls)

    # ---- 12: the chains against their plain versions -------------------------------
    t0 = time.perf_counter()
    pows = phase_mont_pow(torch, limb, mont_mul_mod, (BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ),
                          rs, dev, peaks)
    smuls = phase_scalar_mul(torch, point_mod, ec, limb, (VESTA, BN254_G1, PALLAS), rs, dev,
                             peaks)
    horners = phase_horner(torch, point_mod, ec, [
        (BN254_G1, 5, 52, 1), (BN254_G1, 5, 52, commit_m), (BN254_G1, 4, 65, 1),
        (VESTA, 5, 52, 1)], rs, dev, peaks)
    funcs = roofline.parse_sass(_cuda.sass())
    log("[12] SASS instructions per kernel: " + ", ".join(
        f"{k} {len(roofline.kernel_sass(funcs, k))}"
        for k in ("mont_pow_kernel", "ec_scalar_mul_kernel", "ec_horner_kernel",
                  "ec_add_kernel", "ec_double_kernel", "msm_digits_kernel",
                  "ec_window_table_kernel")))
    log(f"[12] the chains: {time.perf_counter() - t0:.1f} s")

    # ---- 13: the MSM entries against their plain versions; n = 2^18 -----------
    t0 = time.perf_counter()
    msm_res = phase_msm(torch, point_mod, limb, msm_ops, ec, [
        (BN254_G1, 1 << 14, 1), (BN254_G1, 1 << 14, commit_m), (BN254_G1, 1 << 10, 1),
        (BN254_G1, 1, 1), (BN254_G1, 3, 2), (VESTA, 1 << 13, 1)], rs, dev, peaks)
    msm_res["k18"] = phase_msm_k18(torch, point_mod, limb, msm_ops, params, rs, dev)
    log(f"[13] the MSM entries: {time.perf_counter() - t0:.1f} s")

    # ---- 14: the entry points, serde, and the bench's legs at k=10 ------------
    t0 = time.perf_counter()
    start_counting(torch, counted, calls.values())
    phase_entry(torch, dev)
    serde_walls = phase_serde(torch, params, vk, pk, proof, prove6, BenchPlonkCircuit, dev)
    bench_lines = phase_bench(torch, dev)
    launches14 = read_counts(torch, counted, "[14]", calls)
    check_msm_launches("[14]", launches14, calls)
    log(f"[14] entry, serde and bench: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"serde_walls_s": serde_walls, "bench_k10": bench_lines}))

    # ---- 15: the dev tools and Poseidon -----------------------------------------
    t0 = time.perf_counter()
    start_counting(torch, counted, calls.values())
    mock_k17 = phase_mock_k17(torch, counted, dev)
    phase_mock_kinds(dev)
    poseidon = phase_poseidon(torch, profiling, smi, dev)
    phase_examples(dev)
    launches15 = read_counts(torch, counted, "[15]", calls,
                             PATH_KERNELS + ("ec_add", "ec_scalar_mul"))
    check_msm_launches("[15]", launches15, calls)
    log(f"[15] dev tools, Poseidon and examples: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"mock_prover_k17": mock_k17, "poseidon_k7": poseidon}))

    # ---- 16: the gadgets: SHA-256 (Table16), ECC, Sinsemilla ----------------------
    t0 = time.perf_counter()
    start_counting(torch, counted, calls.values())
    # the per-row host check of (a) runs on the CPU in a worker process, beside
    # the card's (a)-(d); the pool is shut down when the block ends
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        per_row = pool.submit(per_row_wrong_digest)
        sha256_mock, wrong_digest = phase_sha256_mock(torch, counted, dev)
        t1 = time.perf_counter()
        sha256_proof = phase_sha256_prove(torch, profiling, smi, dev)
        sha256_proof["phase_s"] = time.perf_counter() - t1
        ecc = phase_ecc_mock(torch, counted, dev)
        sinsemilla = phase_sinsemilla(torch, counted, profiling, smi, dev)
        check_wrong_digest(sha256_mock, wrong_digest, per_row)
    launches16 = read_counts(torch, counted, "[16]", calls,
                             PATH_KERNELS + ("ec_add", "ec_scalar_mul"))
    check_msm_launches("[16]", launches16, calls)
    log(f"[16] SHA-256, ECC and Sinsemilla: {time.perf_counter() - t0:.1f} s "
        f"((b) {sha256_proof['phase_s']:.1f} s)")
    log(json.dumps({"sha256_mock_k17": sha256_mock, "sha256_gwc_k17": sha256_proof, "ecc": ecc,
                    "sinsemilla_ipa": sinsemilla}))

    # ---- 17: multi-device proving on meshes of the visible cards ----------------
    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    log(f"[17] {count} distinct CUDA device(s)")
    if count >= 2:
        log("[17] peer access: " + ", ".join(
            f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
            for i in range(count) for j in range(count) if i != j))
    meshes = card_meshes(torch)
    params16 = ParamsKZG.setup(16, seed=b"bench-prove", device=dev)
    params16.s = None  # verify runs the real pairing
    start_counting(torch, counted, calls.values())
    t1 = time.perf_counter()
    sharded = phase_parallel_kernels(torch, counted, meshes, params16, rs, dev)
    sharded["phase_s"] = {"a": time.perf_counter() - t1}
    t1 = time.perf_counter()
    sharded["dryrun_walls_s"] = phase_parallel_dryrun(meshes)
    sharded["phase_s"]["b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    sharded["bench_plonk_k16"] = phase_parallel_prove(torch, meshes[4], params16)
    sharded["phase_s"]["c"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    sharded["scaling"] = phase_parallel_scaling(meshes)
    sharded["phase_s"]["d"] = time.perf_counter() - t1
    launches17 = read_counts(torch, counted, "[17]", calls, PATH_KERNELS + ("ec_add",))
    check_msm_launches("[17]", launches17, calls)
    del params16
    log(f"[17] multi-device proving: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in sharded["phase_s"].items()) + ")")
    log(json.dumps({"parallel": sharded}))

    # ---- 18: K1's field and transform entries against their plain versions ----
    t0 = time.perf_counter()
    entries = phase_field_entries(torch, limb, field_ops, mont_mul_mod, BN254_FR, rs, dev, peaks)
    stockham = phase_stockham(torch, limb, ntt_ops, BN254_FR, rs, dev, peaks)
    log(f"[18] K1's field and transform entries: {time.perf_counter() - t0:.1f} s")
    log(f"[18] phases 1-18: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"sixstep": stockham["sixstep"],
                    "mont_mul_broadcast": entries["mont_mul_broadcast"]}))

    def main_path(name):
        """A prove-path kernel's launches in phases 6, 10, 11, 14, 15, 16 and 17."""
        by_phase = {"6": launches[name], "10": launches10[name], "11": launches11[name],
                    "14": launches14[name], "15": launches15[name], "16": launches16[name],
                    "17": launches17[name]}
        return {"launches": sum(by_phase.values()), "launches_by_phase": by_phase}

    def roofline_path(name):
        """A roofline kernel's launches (phase 8); phases 6, 10, 11, 14, 15, 16 and 17 run none."""
        return {"launches": roof_launches[name],
                "launches_by_phase": {**main_path(name)["launches_by_phase"],
                                      "8": roof_launches[name]}}

    def with_pasta(bn254, pasta):
        return {**bn254, "max_abs_err": max(r["max_abs_err"] for r in [bn254, *pasta.values()]),
                "pasta": pasta}

    def chain(res):
        """A chain entry's line: its first shape's numbers, and every shape."""
        first = res["shapes"][0]
        return {k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")} | {
            "max_abs_err": res["max_abs_err"], "shapes": res["shapes"]}

    n16, n14 = 1 << 16, 1 << 14
    cells = 2048 * 128  # B1 / B2's (2048, 128) u32 block, 2^10 steps timed
    kernels = [
        {"name": "mont_mul", "route": "cuda", "source": "halo2_tpu_torch/csrc/mont_mul.cu",
         "replaces": "halo2_tpu/fields/pallas_kernels.py:129", **main_path("mont_mul"),
         **with_pasta(k1[BN254_FR.name], pasta_k1),
         **bound(peaks, 192 * n16, PRODUCT_MULS * n16)},
        {"name": "mont_pow", "route": "cuda", "source": "halo2_tpu_torch/csrc/mont_mul.cu",
         "replaces": "halo2_tpu/fields/pallas_kernels.py:129", **main_path("mont_pow"),
         **chain(pows)},
        {"name": "ec_add", "route": "cuda", "source": "halo2_tpu_torch/csrc/ec.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:161", **main_path("ec_add"),
         **with_pasta(ec_res["ec_add"], {c: r["ec_add"] for c, r in pasta_ec.items()}),
         **bound(peaks, 576 * n14, 12 * PRODUCT_MULS * n14)},
        {"name": "ec_double", "route": "cuda", "source": "halo2_tpu_torch/csrc/ec.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:181", **main_path("ec_double"),
         **with_pasta(ec_res["ec_double"], {c: r["ec_double"] for c, r in pasta_ec.items()}),
         **bound(peaks, 384 * n14, 8 * PRODUCT_MULS * n14)},
        {"name": "ec_scalar_mul", "route": "cuda", "source": "halo2_tpu_torch/csrc/ec.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:181", **main_path("ec_scalar_mul"),
         **chain(smuls)},
        {"name": "ec_horner", "route": "cuda", "source": "halo2_tpu_torch/csrc/ec.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:181", **main_path("ec_horner"),
         **chain(horners)},
        {"name": "msm_digits", "route": "cuda", "source": "halo2_tpu_torch/csrc/msm.cu",
         "replaces": "halo2_tpu/fields/pallas_kernels.py:129", **main_path("msm_digits"),
         **chain(msm_res["msm_digits"])},
        {"name": "ec_window_table", "route": "cuda", "source": "halo2_tpu_torch/csrc/msm.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:161", **main_path("ec_window_table"),
         **chain(msm_res["ec_window_table"])},
        {"name": "ec_window_fold", "route": "cuda", "source": "halo2_tpu_torch/csrc/msm.cu",
         "replaces": "halo2_tpu/curves/pallas_ec.py:161", **main_path("ec_window_fold"),
         **chain(msm_res["ec_window_fold"]), "msm_many": msm_res["msm_many"],
         "msm_many_n2e18_m7": msm_res["k18"]},
        *({"name": name, "route": "cuda", "source": "halo2_tpu_torch/csrc/field_ops.cu",
           "replaces": "halo2_tpu/fields/pallas_kernels.py:129", **main_path(name),
           **chain(entries[name])} for name in ("field_add", "field_sub", "field_neg")),
        {"name": "stockham_axis", "route": "cuda", "source": "halo2_tpu_torch/csrc/ntt.cu",
         "replaces": "halo2_tpu/fields/pallas_kernels.py:129", **main_path("stockham_axis"),
         **chain(stockham), "sixstep": stockham["sixstep"]},
        {"name": "mont_mul_tiled", "route": "cuda",
         "source": "halo2_tpu_torch/csrc/mont_mul_tiled.cu",
         "replaces": "halo2_tpu/fields/pallas_kernels.py:80", **roofline_path("mont_mul_tiled"),
         **{k: v for k, v in k4[BN254_FR.name].items() if k != "k1_ms"},
         **bound(peaks, 192 * n16, PRODUCT_MULS * n16)},
        {"name": "int_muladd", "route": "cuda", "source": "halo2_tpu_torch/csrc/roofline.cu",
         "replaces": "bench_roofline.py:53", **roofline_path("int_muladd"),
         **chains["int_muladd"],
         "max_abs_err": max(chains[f]["max_abs_err"]
                            for f in ("int_muladd", "int_muladd_wide", "int_muladd_hi")),
         **bound(peaks, 8 * cells, cells * (1 << 10))},
        {"name": "int_addmask", "route": "cuda", "source": "halo2_tpu_torch/csrc/roofline.cu",
         "replaces": "bench_roofline.py:85", **roofline_path("int_addmask"),
         **chains["int_addmask"], **bound(peaks, 8 * cells, 2 * cells * (1 << 10))},
    ]
    for kern in kernels:
        kern["library_ms"] = None  # no PyTorch call computes these functions
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
