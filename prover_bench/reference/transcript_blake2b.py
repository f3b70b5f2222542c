"""The Blake2b Fiat-Shamir transcript of halo2 (transcript.rs), read side.

State: Blake2b with a 64-byte digest and the personalization
"Halo2-Transcript".  A point absorbs the prefix 1 and its affine x and y as
32-byte little-endian integers; a scalar absorbs the prefix 2 and its 32
bytes.  A challenge absorbs the prefix 0 and reduces the digest of a copy of
the state, read as a 512-bit little-endian integer, modulo r.  Proof bytes
are 32-byte scalars and 32-byte compressed points (bn254.decompress).
"""

from __future__ import annotations

import hashlib

from . import bn254


class Reader:
    def __init__(self, proof: bytes):
        self.proof = proof
        self.pos = 0
        self.state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")

    def common_point(self, pt):
        if pt is None:
            raise ValueError("the identity cannot enter the transcript")
        self.state.update(b"\x01" + pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little"))

    def common_scalar(self, v: int):
        self.state.update(b"\x02" + (v % bn254.R).to_bytes(32, "little"))

    def squeeze(self) -> int:
        self.state.update(b"\x00")
        return int.from_bytes(self.state.copy().digest(), "little") % bn254.R

    def _take(self) -> bytes:
        chunk = self.proof[self.pos:self.pos + 32]
        if len(chunk) != 32:
            raise ValueError("the proof ended early")
        self.pos += 32
        return chunk

    def read_point(self):
        pt = bn254.decompress(self._take())
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        v = int.from_bytes(self._take(), "little")
        if v >= bn254.R:
            raise ValueError("a scalar of the proof is not reduced")
        self.common_scalar(v)
        return v

    def at_end(self) -> bool:
        return self.pos == len(self.proof)
