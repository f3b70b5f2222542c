"""launches_per_proof: device kernels run in the profiled proof.  Layer:
field ops and dispatch (fields/limb.py, fields/field_ops.py, the kernel
wrappers)."""


def read(data):
    if data.trace is None or not data.trace.device:
        return None
    return float(len(data.trace.kernels()))
