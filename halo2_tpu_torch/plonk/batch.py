"""BatchVerifier: check many IPA proofs with one final MSM.

Port of the JAX package's ``plonk/batch.py`` (the reference
plonk/verifier/batch.rs): each proof's multiopen verification yields a
GuardIPA; the guards' MSMs are accumulated with random scaling (so that no
invalid proof can cancel another) and one MSM evaluation, with its n-sized
part on the device, decides the whole batch.
"""

from __future__ import annotations

from typing import List

from ..poly.ipa import MSMIPA, ParamsIPA
from ..poly.multiopen_ipa import ipa_verify_proof
from ..transcript import Blake2bTranscript
from ..utils.rng import FieldRng
from .verifier import verify_proof


class _BatchStrategy:
    """verifier/batch.rs BatchStrategy: keep the guard's MSM unchecked."""

    def __init__(self, params: ParamsIPA):
        self.params = params
        self.msm_out = None

    def process(self, f):
        self.msm_out = f(MSMIPA(self.params)).use_challenges()
        return True  # deferred: the check happens in finalize()


class BatchVerifier:
    def __init__(self, transcript_cls=Blake2bTranscript):
        self.items: List[tuple] = []
        self.transcript_cls = transcript_cls

    def add_proof(self, instances, proof: bytes):
        self.items.append((instances, proof))

    def finalize(self, params: ParamsIPA, vk, rng=None) -> bool:
        rng = rng or FieldRng(params.curve.scalar, b"halo2-tpu-batch")
        acc = MSMIPA(params)
        for instances, proof in self.items:
            strategy = _BatchStrategy(params)
            try:
                verify_proof(
                    params, vk, instances, self.transcript_cls(params.curve, proof),
                    ipa_verify_proof, query_instance=True, strategy=strategy,
                )
            except (ValueError, AssertionError):  # a proof that does not decode
                return False
            acc.scale(rng())
            acc.add_msm(strategy.msm_out)
        return acc.check()
