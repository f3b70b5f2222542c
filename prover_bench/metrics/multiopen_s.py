"""multiopen_s: seconds per proof of the prover's "multiopen" phase, from the
phase timers (``HALO2_TPU_PROFILE=1``, fenced by ``torch.cuda.synchronize``)
of the traced run's proofs after the profiled one.  Layer: the openings (poly/multiopen_gwc.py)."""

PHASE = "multiopen"


def read(data):
    if not data.phase_proofs or PHASE not in data.phases:
        return None
    return data.phases[PHASE] / data.phase_proofs
