"""What a traced run hands each per-layer metric's reader
(``metrics/<name>.py``, ``read(data) -> float | None``), and the calls to
the readers.  A reader that finds nothing to read returns None and its
metric is left out of the line."""

from __future__ import annotations

import dataclasses

from .cell import metric_reader


@dataclasses.dataclass
class LayerData:
    trace: object  # trace.Trace of the profiled proof, or None
    phases: dict  # phase name -> seconds, summed over the phase-timed proofs
    phase_proofs: int  # proofs run with the phase timers on
    msm_least: dict  # yardstick.msm_least of one proof
    keygen_s: float | None = None  # wall of set-up's keygen_vk + keygen_pk


def read_all(metrics: list, data: LayerData) -> dict:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
