"""lookup_host_match_s: seconds per proof of the prover's "lookup: host
matching" phase, from the phase timers (``HALO2_TPU_PROFILE=1``, fenced by
``torch.cuda.synchronize``) of the traced run's proofs after the profiled
one: the lookup's multiset matching on the host (the sorted inputs, each
new value matched by a table row, the leftover table values in the repeats'
rows, the blinding rows' draws) and the two permuted columns' conversion to
limbs on the device, not the pull before it.  It lies inside "lookup:
compress + permute", so it is a part of ``lookup_s``.  Layer: permutation,
lookups (plonk/prover.py ``_lookup_permute``)."""

PHASE = "lookup: host matching"


def read(data):
    if not data.phase_proofs or PHASE not in data.phases:
        return None
    return data.phases[PHASE] / data.phase_proofs
