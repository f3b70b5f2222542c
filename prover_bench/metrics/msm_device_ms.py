"""msm_device_ms: device milliseconds of the MSM kernels in the profiled
proof, matched by name.  Layer: commitments (ops/msm.py, poly/kzg.py).

The names are the CUDA kernels of ``ops/msm.py::msm_many``'s four entries:
digits, window table, window fold and the Horner fold."""

from prover_bench.harness.trace import union

NAMES = ("msm_digits", "ec_window_table", "ec_window_fold", "ec_horner")


def msm_seconds(trace) -> float:
    spans = [(s, e) for _, name, s, e in trace.kernels() if any(n in name for n in NAMES)]
    return sum(e - s for s, e in union(spans)) * 1e-6


def read(data):
    if data.trace is None:
        return None
    secs = msm_seconds(data.trace)
    return secs * 1e3 if secs > 0 else None
