"""random_poly_s: seconds per proof of the prover's "vanishing: random poly"
phase, from the phase timers (``HALO2_TPU_PROFILE=1``, fenced by
``torch.cuda.synchronize``) of the traced run's proofs after the profiled
one: the vanishing argument's random polynomial, n draws on the host,
their conversion to limbs, its commitment and transcript write.  Layer: the
vanishing argument (host draws; plonk/prover.py)."""

PHASE = "vanishing: random poly"


def read(data):
    if not data.phase_proofs or PHASE not in data.phases:
        return None
    return data.phases[PHASE] / data.phase_proofs
