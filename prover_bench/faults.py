"""Faults planted under the window, for the control and the tests; the
benchmark's own runs never use them.

  * ``tamper``: the control.  The configuration's circuit is proved on a
    witness that breaks one constraint (``prove_inputs(..., tamper=True)``),
    which breaks the configuration's guarantee that every proof verifies
    against the circuit's key;
  * ``flip``: an answer altered where it is produced: one byte in the middle
    of each proof is changed;
  * ``stale``: a step that returns its state unchanged: from the second
    proof on, the window is handed the previous proof again.

A run on one card has no batch to halve and no exchange between chips to
leave out, so those faults do not apply.
"""

from __future__ import annotations

import dataclasses


class Tamper:
    tamper = True

    def __call__(self, index, proof):
        return proof


class Flip:
    tamper = False

    def __call__(self, index, proof):
        b = bytearray(proof.proof)
        b[len(b) // 2] ^= 0x01
        return dataclasses.replace(proof, proof=bytes(b))


class Stale:
    tamper = False

    def __init__(self):
        self.last = None

    def __call__(self, index, proof):
        out = proof if self.last is None else dataclasses.replace(
            proof, proof=self.last.proof)
        self.last = out
        return out


FAULTS = {"tamper": Tamper, "flip": Flip, "stale": Stale}
