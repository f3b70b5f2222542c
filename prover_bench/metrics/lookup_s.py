"""lookup_s: seconds per proof of the prover's four lookup phases, "lookup:
compress + permute", "lookup: grand product", "lookup: permuted commits"
and "lookup: product commits", summed, from the phase timers
(``HALO2_TPU_PROFILE=1``, fenced by ``torch.cuda.synchronize``) of the
traced run's proofs after the profiled one: the compressed input and table
columns, their host matching, the permuted columns' commitments, the grand
product and its commitment, over every lookup of the proof.  Layer:
permutation, lookups (plonk/prover.py)."""

PHASES = ("lookup: compress + permute", "lookup: grand product", "lookup: permuted commits",
          "lookup: product commits")


def read(data):
    found = [data.phases[p] for p in PHASES if p in data.phases]
    if not data.phase_proofs or not found:
        return None
    return sum(found) / data.phase_proofs
