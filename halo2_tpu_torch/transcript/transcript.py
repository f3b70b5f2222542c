"""Fiat–Shamir transcripts: Blake2b and Keccak256, byte-exact to the reference.

Mirrors transcript.rs:
- Blake2b: 64-byte digest, personalization b"Halo2-Transcript" (:121-130)
- Keccak256: state seeded with b"Halo2-Transcript" (:134-146)
- prefixes: 0 = challenge, 1 = point, 2 = scalar (:14-38)
- squeeze: Blake2b finalizes a clone after absorbing prefix 0; Keccak squeezes
  lo/hi clones with extra prefixes 10/11 (:241-256)
- Challenge255: from_bytes_wide(64 LE bytes) reduced into the scalar field
  (:496-514)

Values cross this layer as canonical Python ints (host side); proof bytes are
32-byte LE reprs, points compressed with the y-parity sign bit in the top bit
of byte 31 (halo2curves to_bytes convention; identity = all zeroes).
"""

from __future__ import annotations

import hashlib
import io

from ..curves.spec import CurveSpec
from ..fields.spec import FieldSpec
from .keccak import Keccak256


def scalar_to_repr(spec: FieldSpec, v: int) -> bytes:
    return (v % spec.p).to_bytes(32, "little")


def scalar_from_repr(spec: FieldSpec, b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= spec.p:
        raise ValueError("invalid field element encoding in proof")
    return v


def point_to_bytes(curve: CurveSpec, pt) -> bytes:
    """Compressed encoding: x repr with y-parity in bit 7 of byte 31."""
    if pt is None:
        return b"\x00" * 32
    x, y = pt
    b = bytearray(x.to_bytes(32, "little"))
    b[31] |= (y & 1) << 7
    return bytes(b)


def point_from_bytes(curve: CurveSpec, b: bytes):
    if b == b"\x00" * 32:
        return None
    raw = bytearray(b)
    sign = (raw[31] >> 7) & 1
    raw[31] &= 0x7F
    x = int.from_bytes(raw, "little")
    f = curve.base
    if x >= f.p:
        raise ValueError("invalid point encoding in proof")
    y2 = (x * x * x + curve.b) % f.p
    y = f.sqrt(y2)
    if y is None:
        raise ValueError("invalid point encoding in proof")
    if (y & 1) != sign:
        y = f.p - y
    return (x, y)


class _TranscriptBase:
    """Common logic; subclasses implement _absorb and _squeeze_bytes."""

    def __init__(self, curve: CurveSpec, buf: bytes = b""):
        self.curve = curve
        self._reader = io.BytesIO(buf)
        self._writer = io.BytesIO()

    # -- hash state interaction ------------------------------------------
    def common_point(self, pt):
        if pt is None:
            raise ValueError("cannot write points at infinity to the transcript")
        self._absorb(b"\x01")
        f = self.curve.base
        self._absorb(scalar_to_repr(f, pt[0]))
        self._absorb(scalar_to_repr(f, pt[1]))

    def common_scalar(self, v: int):
        self._absorb(b"\x02")
        self._absorb(scalar_to_repr(self.curve.scalar, v))

    def squeeze_challenge(self) -> int:
        """Returns the canonical scalar (Challenge255 semantics)."""
        wide = self._squeeze_bytes()
        return self.curve.scalar.from_bytes_wide(wide)

    # -- prover side -----------------------------------------------------
    def write_point(self, pt):
        self.common_point(pt)
        self._writer.write(point_to_bytes(self.curve, pt))

    def write_scalar(self, v: int):
        self.common_scalar(v)
        self._writer.write(scalar_to_repr(self.curve.scalar, v))

    def finalize(self) -> bytes:
        return self._writer.getvalue()

    # -- verifier side ---------------------------------------------------
    def read_point(self):
        b = self._reader.read(32)
        if len(b) != 32:
            raise ValueError("unexpected end of proof")
        pt = point_from_bytes(self.curve, b)
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        b = self._reader.read(32)
        if len(b) != 32:
            raise ValueError("unexpected end of proof")
        v = scalar_from_repr(self.curve.scalar, b)
        self.common_scalar(v)
        return v


class Blake2bTranscript(_TranscriptBase):
    def __init__(self, curve: CurveSpec, buf: bytes = b""):
        super().__init__(curve, buf)
        self._state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")

    def _absorb(self, data: bytes):
        self._state.update(data)

    def _squeeze_bytes(self) -> bytes:
        self._state.update(b"\x00")
        return self._state.copy().digest()


class Keccak256Transcript(_TranscriptBase):
    def __init__(self, curve: CurveSpec, buf: bytes = b""):
        super().__init__(curve, buf)
        self._state = Keccak256().update(b"Halo2-Transcript")

    def _absorb(self, data: bytes):
        self._state.update(data)

    def _squeeze_bytes(self) -> bytes:
        self._state.update(b"\x00")
        lo = self._state.copy().update(b"\x0a").digest()
        hi = self._state.copy().update(b"\x0b").digest()
        return lo + hi


TRANSCRIPTS = {"blake2b": Blake2bTranscript, "keccak256": Keccak256Transcript}
