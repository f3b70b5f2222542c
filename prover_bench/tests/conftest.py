"""Fixtures of the benchmark's CPU tests: the cells at a tiny k on the CPU,
where the port takes its kernels' plain versions.

    python -m pytest prover_bench/tests -q     (from the repo root; ~9 min)
"""

import dataclasses
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_K = 4
# A test window in warm proofs: long enough that its first proof ends inside it on a
# loaded host too, and a later one is in flight at its close.
WINDOW_PROOFS = 2.5


@pytest.fixture(scope="session")
def torch_threads():
    import torch

    torch.set_num_threads(1)


def tiny(cell):
    """The cell at k = TINY_K."""
    return dataclasses.replace(cell, config=dict(cell.config, k=TINY_K))


@pytest.fixture
def tiny_cells(monkeypatch):
    """Make ``cell.load`` give every cell at k = TINY_K, and set-up prove no
    warm-up."""
    from prover_bench.harness import cell as cell_mod
    from prover_bench.harness import prover as prover_mod

    load = cell_mod.load
    monkeypatch.setattr(cell_mod, "load", lambda name, path=None: tiny(load(name, path)))
    monkeypatch.setattr(prover_mod, "WARMUP_PROOFS", 0)


@pytest.fixture(scope="session")
def proved(torch_threads):
    """(cell, prover, window, seconds of one proof) of benchplonk-gwc-k16 at
    k = TINY_K: set-up and a window of WINDOW_PROOFS warm proofs."""
    from prover_bench.harness import cell as cell_mod
    from prover_bench.harness import prover as prover_mod
    from prover_bench.harness.prover import Prover, run_window

    cell = tiny(cell_mod.load("benchplonk-gwc-k16"))
    prover = Prover(cell, 2**33 + 5, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prover_mod, "WARMUP_PROOFS", 0)
        prover.setup()
    t0 = time.perf_counter()
    prover.prove(-1)  # the warm-up, timed
    warm = time.perf_counter() - t0
    window = run_window(prover, WINDOW_PROOFS * warm)
    return cell, prover, window, warm


@pytest.fixture
def window_s(proved):
    """A window of WINDOW_PROOFS warm proofs: a proof is in flight at its close."""
    return WINDOW_PROOFS * proved[3]
