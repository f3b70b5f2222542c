"""msm_roofline: the least time of one proof's MSM work (harness/yardstick.py,
counted from the configuration's constraint system) over the device time of
the MSM kernels in the profiled proof (``msm_device_ms``'s kernels), in
percent.  Layer: kernels (csrc/msm.cu, csrc/ec.cu)."""

from prover_bench.harness.cell import metric_module

_device = metric_module("msm_device_ms")


def read(data):
    if data.trace is None:
        return None
    secs = _device.msm_seconds(data.trace)
    if secs <= 0:
        return None
    return 100.0 * data.msm_least["seconds"] / secs
