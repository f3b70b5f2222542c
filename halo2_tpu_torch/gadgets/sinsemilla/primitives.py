"""Sinsemilla hash outside the circuit (host-side reference primitives).

Mirrors the behavior of halo2_gadgets/src/sinsemilla/primitives.rs (K, C,
Pad, HashDomain, CommitDomain) and primitives/addition.rs (incomplete
addition with bottom propagation).  The 1024-entry S generator table is
*generated* via the SSWU hash-to-curve (sswu.py) rather than transcribed
from the reference's 14k-line constant file; tests pin the generated table
against the reference byte-for-byte (tests/test_sswu.py).

Points are affine ``(x, y)`` int tuples.  The distinguished "bottom" value
(⊥, produced by incomplete addition on identity or equal-x inputs) is
represented by ``None`` — distinct from the group identity, which never
occurs as an affine tuple here.
"""

from __future__ import annotations

import functools

from ...curves import host
from ...curves.spec import PALLAS
from ...curves.sswu import hash_to_curve

# Number of bits per message piece (primitives.rs:14)
K = 10
# Largest integer such that 2^C <= (r_P - 1) / 2 (primitives.rs:24)
C = 253

Q_PERSONALIZATION = "z.cash:SinsemillaQ"
S_PERSONALIZATION = "z.cash:SinsemillaS"

_P = PALLAS.base.p


@functools.lru_cache(maxsize=1)
def sinsemilla_s() -> list[tuple[int, int]]:
    """The 2^K S generators: hash_to_curve("z.cash:SinsemillaS")(j le32)."""
    hasher = hash_to_curve(PALLAS, S_PERSONALIZATION)
    return [hasher(j.to_bytes(4, "little")) for j in range(1 << K)]


def lebs2ip_k(bits) -> int:
    """Little-endian bits (length K) to integer (primitives.rs:36-41)."""
    assert len(bits) == K
    return sum(1 << i for i, b in enumerate(bits) if b)


def i2lebsp(value: int, length: int) -> list[bool]:
    """Integer to little-endian bit list of fixed length."""
    assert 0 <= value < (1 << length)
    return [bool((value >> i) & 1) for i in range(length)]


def pad(bits) -> list[bool]:
    """Zero-pad a bit sequence to a multiple of K (primitives.rs:58-113)."""
    out = [bool(b) for b in bits]
    assert len(out) <= K * C
    rem = len(out) % K
    if rem:
        out.extend([False] * (K - rem))
    return out


def incomplete_add(p1, p2):
    """P ⸭ Q: complete-add result, or ⊥ (None) on identity/equal-x inputs.

    Mirrors primitives/addition.rs:25-47; ⊥ absorbs (⊥ ⸭ _ = ⊥).
    """
    if p1 is None or p2 is None:
        return None
    if p1[0] == p2[0]:
        # covers P == Q and P == -Q
        return None
    return host.add(PALLAS, p1, p2)


class HashDomain:
    """Domain for SinsemillaHashToPoint / SinsemillaHash (primitives.rs:119-180)."""

    def __init__(self, domain: str, _Q=None):
        self.Q = _Q if _Q is not None else hash_to_curve(PALLAS, Q_PERSONALIZATION)(domain.encode())

    def hash_to_point(self, msg):
        """SinsemillaHashToPoint: fold K-bit chunks; None on ⊥."""
        padded = pad(msg)
        s = sinsemilla_s()
        acc = self.Q
        for i in range(0, len(padded), K):
            chunk = s[lebs2ip_k(padded[i : i + K])]
            acc = incomplete_add(incomplete_add(acc, chunk), acc)
        return acc

    def hash(self, msg):
        """SinsemillaHash: x-coordinate extractor (identity -> 0)."""
        pt = self.hash_to_point(msg)
        if pt is None:
            return None
        return pt[0]


class CommitDomain:
    """Domain for SinsemillaCommit / SinsemillaShortCommit (primitives.rs:185-240)."""

    def __init__(self, domain: str):
        self.M = HashDomain(f"{domain}-M")
        self.R = hash_to_curve(PALLAS, f"{domain}-r")(b"")

    def commit(self, msg, r: int):
        """SinsemillaCommit: hash_to_point(msg) + [r]R (complete add)."""
        pt = self.M.hash_to_point(msg)
        if pt is None:
            return None
        return host.add(PALLAS, pt, host.mul(PALLAS, self.R, r))

    def short_commit(self, msg, r: int):
        pt = self.commit(msg, r)
        if pt is None:
            return None
        return pt[0] if pt is not None else 0
