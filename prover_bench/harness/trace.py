"""Reduction of a ``torch.profiler`` Chrome trace of one proof to what the
per-layer readers and the breakdown need.

Device activity is every complete event ("ph": "X") of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``.  Busy time is the union of
their intervals, not the sum of their durations, so that work on two streams
at once counts once.  The window is the harness's ``record_function`` span
around the proof (``SPAN``); device intervals are clipped to it.  Inside it,
the prover's own phases (``utils/profiling.phase`` names) appear as
``record_function`` spans too (``prover._profiled``); they label the idle
gaps.
"""

from __future__ import annotations

import dataclasses
import gzip
import json

SPAN = "prover_bench.proof"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window: tuple  # (start, end) of the proof, microseconds
    device: list  # [(cat, name, start, end)] clipped to the window, by start
    host_ops: list  # [(name, start, end)] of cpu_op events in the window
    phases: list = dataclasses.field(default_factory=list)  # [(name, start, end)]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self) -> list:
        return [d for d in self.device if d[0] == "kernel"]


def read_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X"]


def reduce(events: list) -> Trace:
    spans = [e for e in events if e.get("name") == SPAN and e.get("cat") != "gpu_user_annotation"]
    if not spans:
        raise ValueError(f"the trace has no {SPAN!r} span")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    device, host, phases = [], [], []
    for e in events:
        start = float(e.get("ts", 0.0))
        end = start + float(e.get("dur", 0.0))
        if end <= t0 or start >= t1:
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append((e["cat"], e.get("name", ""), max(start, t0), min(end, t1)))
        elif e.get("cat") == "cpu_op":
            host.append((e.get("name", ""), start, end))
        elif e.get("cat") == "user_annotation" and e.get("name") != SPAN:
            phases.append((e.get("name", ""), start, end))
    device.sort(key=lambda d: d[2])
    return Trace((t0, t1), device, host, phases)


def union(intervals) -> list:
    """Merged [(start, end)] of the intervals, in order."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in union((d[2], d[3]) for d in trace.device)) * 1e-6


def idle_gaps(trace: Trace) -> list:
    """[(start, end)] of the window's stretches with no device activity."""
    gaps, cursor = [], trace.window[0]
    for start, end in union((d[2], d[3]) for d in trace.device):
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if trace.window[1] > cursor:
        gaps.append((cursor, trace.window[1]))
    return gaps


def _widest_cover(spans, start: float, end: float):
    """(name, covered microseconds) of the span covering most of [start, end]."""
    best, cover = None, 0.0
    for name, s, e in spans:
        c = min(e, end) - max(s, start)
        if c > cover:
            best, cover = name, c
    return best, cover


def host_label(trace: Trace, start: float, end: float) -> str:
    """What the host ran during a gap: the prover's phase that covers most
    of it, and within it the torch op that covers at least half of it."""
    phase, _ = _widest_cover(trace.phases, start, end)
    op, cover = _widest_cover(trace.host_ops, start, end)
    where = f"phase {phase}" if phase else "outside the phases"
    if op is not None and cover >= 0.5 * (end - start):
        return f"{where}: torch op {op}"
    return f"{where}: host Python"


def breakdown(trace: Trace, top: int = 10) -> dict:
    by_name: dict = {}
    for _, name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name[:120], secs] for name, secs in ops],
        "idle_gaps": [[host_label(trace, s, e), (e - s) * 1e-6] for s, e in gaps],
    }
