#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 prover_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json`` "workloads")
names a configuration and a traffic mix.  Set-up makes the SRS on the card
from the seed, runs keygen and one warm-up proof; the window then proves in a
closed loop with one proof in flight through ``halo2_tpu_torch.plonk.
create_proof`` for ``--seconds``; the reference then verifies every proof
the window made and the verifying key (``harness/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (proofs the window started), ``failed`` (proofs the reference
rejected), ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and last ``checks``, each number compared beside its limit; the same
numbers are the last lines of standard error.  With ``--trace 0`` the
metrics are the end-to-end ones:

  * ``prove_s``: the window's time up to the end of the last proof that
    ended inside it, over the number of those proofs;
  * ``setup_s``: from the start of this script to the end of set-up.

With ``--trace 1`` they are the per-layer ones, each read by
``metrics/<name>.py``: the first proof of the window runs under
``torch.profiler``, the later ones with the prover's phase timers;
``keygen_wall_s`` is the wall of set-up's one keygen_vk + keygen_pk.

The run exits with another code than 0, and prints no result, without
enough CUDA cards, or if ``jax``, ``jaxlib``, ``flax`` or ``halo2_tpu`` (the
JAX package, as a whole top-level name) is loaded once the window has
closed.  Kernel and build caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_tpu")


class NoCard(RuntimeError):
    pass


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fix_caches(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(root, ".prover_bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.pop("HALO2_TPU_PROFILE", None)  # the harness switches the phase timers


def card(chips: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} card(s); {torch.cuda.device_count()} visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def settle_heap() -> None:
    """Collect the garbage so far and move every object left into the
    collector's permanent generation, as a long-lived prover does with its
    start-up heap: a later full collection then scans only what came after,
    not torch's modules or the keys."""
    gc.collect()
    gc.freeze()


def run(args, device: str = "cuda", fault=None) -> dict:
    """One run of the cell; the result line as a dict."""
    from prover_bench.harness import cell as cell_mod
    from prover_bench.harness import check, layers, yardstick
    from prover_bench.harness.prover import Prover, run_window
    from prover_bench.harness.trace import breakdown, busy_s

    cell = cell_mod.load(args.workload)
    if device == "cuda":
        dev_info = card(cell.chips)
    else:
        dev_info = {"platform": device, "kind": device, "count": 1}
    prover = Prover(cell, args.seed, device)
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    settle_heap()
    prover.setup()
    settle_heap()
    setup_s = time.perf_counter() - T_START
    win = run_window(prover, args.seconds, trace=bool(args.trace), fault=fault)
    if win.counted == 0:
        raise RuntimeError(f"no proof ended inside the {args.seconds} s window")
    if device == "cuda":
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    else:
        dev_info["memory_peak_bytes"] = 0
    program_vk = prover.vk_data()
    keygen_s = prover.keygen_s
    prover.release()

    readings = check.check(cell, args.seed, program_vk, win.proofs)
    result = {"correct": check.passed(readings, len(win.proofs)),
              "attempted": len(win.proofs), "failed": readings["proofs_rejected"],
              "window": {"proofs_counted": win.counted, "last_end_s": win.last_end_s,
                         "proof_walls_s": [p.wall_s for p in win.proofs]}}
    if args.trace:
        ref = cell.reference_module()
        msms = yardstick.proof_msms(ref.constraint_system(cell.config), cell.config["multiopen"])
        least = yardstick.msm_least(cell.config["k"], msms)
        data = layers.LayerData(win.trace, win.phases, win.phase_proofs, least, keygen_s)
        result["metrics"] = layers.read_all(cell.per_layer, data)
        if win.trace is not None:
            dev_info["busy_s"] = busy_s(win.trace)
            dev_info["window_s"] = win.trace.window_s
    else:
        values = {"prove_s": win.last_end_s / win.counted, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = dev_info
    if args.trace and win.trace is not None:
        result["breakdown"] = breakdown(win.trace)
    result["checks"] = {name: {"value": v, "limit": check.LIMITS[name]}
                        for name, v in readings.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    fix_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        result = run(args)
    except NoCard as e:
        print(f"prover_bench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"prover_bench: the JAX side is loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
