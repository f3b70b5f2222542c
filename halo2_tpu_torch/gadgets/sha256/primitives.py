"""Host SHA-256 reference implementation (FIPS 180-4).

The oracle for the Table16-style circuit: gives round-by-round internal state
for witness generation and NIST-vector golden tests.  (hashlib.sha256 could
digest, but the circuit needs the per-round compression trace.)
"""

from __future__ import annotations

from typing import List, Tuple

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

M32 = 0xFFFFFFFF


def rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


def shr(x: int, n: int) -> int:
    return x >> n


def big_sigma0(x: int) -> int:
    return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22)


def big_sigma1(x: int) -> int:
    return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25)


def small_sigma0(x: int) -> int:
    return rotr(x, 7) ^ rotr(x, 18) ^ shr(x, 3)


def small_sigma1(x: int) -> int:
    return rotr(x, 17) ^ rotr(x, 19) ^ shr(x, 10)


def ch(e: int, f: int, g: int) -> int:
    return (e & f) ^ (~e & g & M32)


def maj(a: int, b: int, c: int) -> int:
    return (a & b) ^ (a & c) ^ (b & c)


def message_schedule(block: List[int]) -> List[int]:
    """W[0..64) from a 16-word block."""
    w = list(block)
    for i in range(16, 64):
        w.append(
            (small_sigma1(w[i - 2]) + w[i - 7] + small_sigma0(w[i - 15]) + w[i - 16])
            & M32
        )
    return w


def sha256_compress(state: List[int], block: List[int], trace: bool = False):
    """One compression round; returns new state (and the per-round trace of
    (a..h) tuples when trace=True, for circuit witness generation)."""
    w = message_schedule(block)
    a, b, c, d, e, f, g, h = state
    rounds: List[Tuple[int, ...]] = []
    for i in range(64):
        t1 = (h + big_sigma1(e) + ch(e, f, g) + ROUND_CONSTANTS[i] + w[i]) & M32
        t2 = (big_sigma0(a) + maj(a, b, c)) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
        if trace:
            rounds.append((a, b, c, d, e, f, g, h))
    out = [(s + v) & M32 for s, v in zip(state, [a, b, c, d, e, f, g, h])]
    return (out, rounds, w) if trace else out


def pad_message(msg: bytes) -> List[List[int]]:
    """FIPS 180-4 padding -> list of 16-word blocks."""
    length = len(msg) * 8
    msg = msg + b"\x80"
    while (len(msg) + 8) % 64:
        msg += b"\x00"
    msg += length.to_bytes(8, "big")
    blocks = []
    for off in range(0, len(msg), 64):
        blocks.append(
            [int.from_bytes(msg[off + 4 * i : off + 4 * i + 4], "big") for i in range(16)]
        )
    return blocks


def sha256_digest(msg: bytes) -> bytes:
    state = list(IV)
    for block in pad_message(msg):
        state = sha256_compress(state, block)
    return b"".join(s.to_bytes(4, "big") for s in state)
