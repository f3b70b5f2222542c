"""shplonk_h_s: seconds per proof of the SHPLONK multiopen's "multiopen:
shplonk h(X)" span, from the phase timers (``HALO2_TPU_PROFILE=1``, fenced
by ``torch.cuda.synchronize``) of the traced run's proofs after the profiled
one: from after y's squeeze through h's transcript write, that is the
rotation sets, the batched evaluations of every (polynomial, point) pair
and their pull, the host interpolation, the sets' combination, the kate
divisions and h's commitment.  It lies inside "multiopen", so it is a part
of ``multiopen_s``.  Layer: the openings (poly/multiopen_shplonk.py)."""

PHASE = "multiopen: shplonk h(X)"


def read(data):
    if not data.phase_proofs or PHASE not in data.phases:
        return None
    return data.phases[PHASE] / data.phase_proofs
