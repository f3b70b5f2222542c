"""synthesis_s: seconds per proof of the prover's "witness synthesis (host)" phase, from the
phase timers (``HALO2_TPU_PROFILE=1``, fenced by ``torch.cuda.synchronize``)
of the traced run's proofs after the profiled one.  Layer: frontend and synthesis on the host (circuit/, plonk/circuit.py, gadgets/)."""

PHASE = "witness synthesis (host)"


def read(data):
    if not data.phase_proofs or PHASE not in data.phases:
        return None
    return data.phases[PHASE] / data.phase_proofs
