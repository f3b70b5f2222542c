"""commit_s: seconds per proof of the prover's "commit: msm" phases, from the
phase timers (``HALO2_TPU_PROFILE=1``, fenced by ``torch.cuda.synchronize``)
of the traced run's proofs after the profiled one: every commitment's
batched MSM, its dispatch on the host and its time on the card.  Layer:
commitments (poly/kzg.py, ops/msm.py)."""

PHASE = "commit: msm"


def read(data):
    if not data.phase_proofs or PHASE not in data.phases:
        return None
    return data.phases[PHASE] / data.phase_proofs
