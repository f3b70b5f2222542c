#!/usr/bin/env python3
"""Readings of the check (``harness/check.py``) for sound runs and for the
control and faults of ``faults.py``, on the card at the cell's own size.

    python3 prover_bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 8 --faults none,tamper,flip,stale

For each seed, one set-up (as ``run.py``'s) and then, for each fault, one
window of ``--seconds`` with that fault planted under it, checked as a run
checks it.  One JSON line per (seed, fault): the readings, the proofs and
``correct``.  The benchmark's runs never call this; it sets the limits'
readings (``PERF.md``).
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None, device: str = "cuda") -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="none,tamper,flip,stale")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from prover_bench import run
    from prover_bench.faults import FAULTS
    from prover_bench.harness import cell as cell_mod
    from prover_bench.harness import check
    from prover_bench.harness.prover import Prover, run_window

    run.fix_caches()
    cell = cell_mod.load(args.workload)
    if device == "cuda":
        run.card(cell.chips)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        prover = Prover(cell, seed, device)
        prover.setup()
        vk = prover.vk_data()
        for name in args.faults.split(","):
            fault = None if name == "none" else FAULTS[name]()
            win = run_window(prover, args.seconds, fault=fault)
            readings = check.check(cell, seed, vk, win.proofs)
            line = {"workload": cell.name, "seed": seed, "fault": name, "proofs": len(win.proofs),
                    "readings": readings, "correct": check.passed(readings, len(win.proofs))}
            print(json.dumps(line), flush=True)
            lines.append(line)
        prover.release()
    return lines


if __name__ == "__main__":
    main()
