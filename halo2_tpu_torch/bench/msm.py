"""Device time of ``ops.msm.msm_many`` at the main path's MSM shapes, stage by stage.

    python -m halo2_tpu_torch.bench.msm [--out PATH]

On one CUDA card (it raises without one), for each shape below, it makes
seeded operands (points R + i*S by host adds, random Montgomery scalars
below the modulus, seed 5), runs ``msm_many`` once to warm up and then five
times, and prints one JSON line per shape:

- ``ms``: CUDA-event milliseconds of each call, from the first launch to the
  last; host gaps between launches count, as they do on the prove path;
- ``stages``: the same calls cut at the entry and exit of the functions of
  ``ops/msm.py`` that it passes through and of ``ec_kernels.ec_horner``;
  a gap between two of them is named ``a..b`` (``start..msm_digits`` is what
  ``msm_many`` does before its first stage);
- ``ms_without_horner``: ``ms`` less the ``ec_horner`` stage;
- ``peak_gib``: peak device memory of one call above its operands;
- ``out_sha256``: of the output's projective limbs, so two revisions of the
  package can be shown to give the same bits on the same operands.

Shapes: BN254 n = 2^14 with m = 1 (a commit, an IPA round's size) and m = 7
(the keygen's fixed and sigma columns in one call), and Vesta n = 2^13 (the
IPA bench's half-size round MSMs), c = 5 as ``msm_many`` picks it.

The stages are found by name and wrapped where ``msm_many`` looks them up
at call time; a name the package does not have is skipped.  So the same file
times an earlier revision of the package whose ``msm_many`` ran other stages
(``_build_table``, ``_fold_points``): copy it into that revision's
``halo2_tpu_torch/bench/`` and run it there, in the same call as this one.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json

import numpy as np
import torch

from halo2_tpu_torch.curves import ec_kernels, host, point
from halo2_tpu_torch.curves.spec import BN254_G1, VESTA
from halo2_tpu_torch.ops import msm as msm_ops

SHAPES = ((BN254_G1, 1 << 14, 1), (BN254_G1, 1 << 14, 7), (VESTA, 1 << 13, 1))
REPS = 5
SEED = 5
STAGES = ((msm_ops, "msm_digits"), (msm_ops, "ec_window_table"), (msm_ops, "ec_window_fold"),
          (msm_ops, "_signed_digits"), (msm_ops, "_build_table"), (msm_ops, "_fold_points"),
          (ec_kernels, "ec_horner"))


def operands(curve, n: int, m: int, rs, dev):
    """(m, 16, n) Montgomery scalars below the scalar modulus and n distinct
    points R + i*S, on the card."""
    g = host.generator(curve)
    r, s = (host.mul(curve, g, int(v)) for v in rs.integers(1, 1 << 62, size=2))
    aff = [r]
    for _ in range(n - 1):
        aff.append(host.add(curve, aff[-1], s))
    raw = rs.integers(0, 1 << 16, size=(m, 16, n), dtype=np.int64)
    raw[:, 15] %= curve.scalar.p >> 240  # below p: a valid Montgomery form
    return torch.from_numpy(raw.astype(np.int32)).to(dev), point.from_affine_ints(curve, aff, dev)


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Marks:
    """CUDA events at the entry and exit of every stage found, in call order."""

    def __init__(self):
        self.events = []
        self.saved = []

    def wrap(self):
        for mod, name in STAGES:
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            self.saved.append((mod, name, fn))

            # wraps copies the launch counter, which the wrapped entry then
            # increments under its module name, i.e. on this wrapper
            @functools.wraps(fn)
            def timed(*args, _fn=fn, _name=name, **kwargs):
                self.events.append((_name, "enter", _event()))
                out = _fn(*args, **kwargs)
                self.events.append((_name, "exit", _event()))
                return out

            setattr(mod, name, timed)

    def unwrap(self):
        for mod, name, fn in self.saved:
            if hasattr(fn, "launches"):  # the launches made while wrapped
                fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)

    def segments(self) -> dict:
        """Milliseconds between consecutive marks of the last call."""
        out = {}
        for (a, ka, ea), (b, kb, eb) in zip(self.events, self.events[1:]):
            key = a if (a, ka, kb) == (b, "enter", "exit") else f"{a}..{b}"
            out[key] = out.get(key, 0.0) + ea.elapsed_time(eb)
        return out


def time_shape(curve, n: int, m: int, reps: int, rs, dev) -> dict:
    scal, pts = operands(curve, n, m, rs, dev)
    out = msm_ops.msm_many(curve, scal, pts)  # warm-up: kernels built, caches filled
    digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out)).hexdigest()
    marks = _Marks()
    marks.wrap()
    calls = []
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            marks.events = [("start", "mark", _event())]
            msm_ops.msm_many(curve, scal, pts)
            marks.events.append(("end", "mark", _event()))
            torch.cuda.synchronize()
            calls.append({"ms": marks.events[0][2].elapsed_time(marks.events[-1][2]),
                          "stages": marks.segments(),
                          "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30})
    finally:
        marks.unwrap()
    return {"curve": curve.name, "n": n, "m": m,
            "ms": [c["ms"] for c in calls],
            "ms_without_horner": [c["ms"] - c["stages"].get("ec_horner", 0.0) for c in calls],
            "stages": {k: [c["stages"][k] for c in calls] for k in calls[0]["stages"]},
            "peak_gib": max(c["peak_gib"] for c in calls), "out_sha256": digest}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as one JSON file here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench.msm needs a CUDA device")
    dev = torch.device("cuda", 0)
    rs = np.random.default_rng(SEED)
    results = []
    for curve, n, m in SHAPES:
        results.append(time_shape(curve, n, m, REPS, rs, dev))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
