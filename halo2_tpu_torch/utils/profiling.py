"""Wall-clock phase timers for the prover hot path.

Port of the JAX package's ``utils/profiling.py``.  ``phase(name)`` accumulates
wall time under ``name`` when ``HALO2_TPU_PROFILE=1`` (zero overhead
otherwise).  Work on the card is asynchronous, so when CUDA is in use a phase
calls ``torch.cuda.synchronize()`` before it reads the clock at either end:
a phase's time is then the time its work took, not the time it took to
enqueue it.

Usage::

    HALO2_TPU_PROFILE=1 python3 chip_smoke.py   # prints the phase report
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

