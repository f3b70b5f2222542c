"""Deterministic seeded RNG producing field elements (test/prover blinds).

The reference takes any RngCore (prover.rs:46); proofs depend on the RNG
stream, so tests inject a fixed seed on both prove and re-prove runs.
"""

from __future__ import annotations

import hashlib


class FieldRng:
    def __init__(self, spec, seed: bytes = b"halo2-tpu-rng"):
        self.spec = spec
        self.seed = seed
        self.counter = 0

    def __call__(self) -> int:
        h = hashlib.blake2b(
            self.seed + self.counter.to_bytes(8, "little"), digest_size=64
        ).digest()
        self.counter += 1
        return self.spec.from_bytes_wide(h)
