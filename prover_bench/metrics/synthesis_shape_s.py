"""synthesis_shape_s: seconds per proof of the floor planner's shape pass
and placement ("synthesis: region shapes"), the host time that the port's
layouter sums over a synthesis and adds to the phase report once, with the
phase timers on (``HALO2_TPU_PROFILE=1``) in the traced run's proofs after
the profiled one.  It is a part of ``synthesis_s``.  Layer: frontend and
synthesis on the host (circuit/layouter.py)."""

PHASE = "synthesis: region shapes"


def read(data):
    if not data.phase_proofs or PHASE not in data.phases:
        return None
    return data.phases[PHASE] / data.phase_proofs
