"""Wall-clock phase timers for the prover hot path.

Port of the JAX package's ``utils/profiling.py``.  ``phase(name)`` accumulates
wall time under ``name`` when ``HALO2_TPU_PROFILE=1`` (zero overhead
otherwise).  Work on the card is asynchronous, so when CUDA is in use a phase
calls ``torch.cuda.synchronize()`` before it reads the clock at either end:
a phase's time is then the time its work took, not the time it took to
enqueue it.

``device_trace(logdir)`` records the enclosed block with ``torch.profiler``
(CPU activities, and CUDA ones where a card is present) and writes it into
``logdir`` as a gzipped Chrome trace (Perfetto opens it):
every kernel with its device time, beside the host's operator calls.

Usage::

    HALO2_TPU_PROFILE=1 python3 chip_smoke.py   # prints the phase report

    with device_trace("bench_out/trace"):
        create_proof(...)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

_times: Dict[str, List[float]] = defaultdict(list)


def enabled() -> bool:
    return os.environ.get("HALO2_TPU_PROFILE") == "1"


def _now() -> float:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Accumulate the (device-fenced) wall time of the block under ``name``."""
    if not enabled():
        yield
        return
    t0 = _now()
    try:
        yield
    finally:
        _times[name].append(_now() - t0)


def profiled(name: str):
    """Decorator form of :func:`phase`."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with phase(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def report(reset: bool = True) -> List[Tuple[str, int, float]]:
    """[(phase, calls, total_seconds)] sorted by total descending."""
    out = sorted(
        ((k, len(v), sum(v)) for k, v in _times.items()),
        key=lambda t: -t[2],
    )
    if reset:
        _times.clear()
    return out


def print_report() -> None:
    """Print the phase report (and reset it); nothing when it is empty."""
    rows = report()
    if not rows:
        return
    total = sum(t for _, _, t in rows)
    print(f"-- halo2_tpu profile ({total:.2f}s total) --")
    for name, calls, secs in rows:
        print(f"{secs:8.2f}s  {calls:4d}x  {name}")


TRACE_FILE = "trace.json.gz"  # torch.profiler gzips a path ending in .gz


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace of the enclosed block, written to
    ``logdir/trace.json.gz`` when the block ends; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
