"""host_syncs_per_proof: the device-to-host pulls in the profiled proof, the
number of its "limb: device to host" spans; each one waits for the card's
stream to drain.  Layer: field ops and dispatch (fields/limb.py)."""

SPAN = "limb: device to host"


def read(data):
    if data.trace is None:
        return None
    pulls = sum(1 for name, _, _ in data.trace.phases if name == SPAN)
    return float(pulls) if pulls else None
