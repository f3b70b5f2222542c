"""device_idle: the share of the profiled proof's wall in which no kernel,
copy or fill ran on the card (1 - the union of their intervals over the
proof's span), in percent.  Layer: the device."""

from prover_bench.harness.trace import busy_s


def read(data):
    if data.trace is None or not data.trace.device:
        return None
    return 100.0 * (1.0 - busy_s(data.trace) / data.trace.window_s)
