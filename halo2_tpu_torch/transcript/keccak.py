"""Keccak-256 (original Keccak padding 0x01, NOT NIST SHA-3).

The reference uses the ``sha3`` crate's ``Keccak256`` for its EVM-compatible
transcript (transcript.rs:241-256); Python's hashlib only ships NIST SHA-3
(padding 0x06), so we implement keccak-f[1600] directly.  Host-side only.

The permutation dispatches to the native C implementation
(native/keccak.c -> libhalo2native.so, loaded via ctypes) when built —
transcript hashing is the prover's host hot loop — with the pure-Python
permutation as a portable fallback.
"""

from __future__ import annotations

import ctypes
import os

_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    path = os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "libhalo2native.so"
    )
    try:
        lib = ctypes.CDLL(os.path.abspath(path))
        lib.keccak_f1600.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        _NATIVE = lib
    except OSError:
        _NATIVE = False
    return _NATIVE

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rol(v, n):
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(state):
    lib = _load_native()
    if lib:
        buf = (ctypes.c_uint64 * 25)(
            *(state[x][y] for y in range(5) for x in range(5))
        )
        lib.keccak_f1600(buf)
        for y in range(5):
            for x in range(5):
                state[x][y] = buf[x + 5 * y]
        return state
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(state[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK)
        # iota
        state[0][0] ^= rc
    return state


class Keccak256:
    """Incremental Keccak-256 with clone support (rate 136 bytes)."""

    RATE = 136

    def __init__(self):
        self._state = [[0] * 5 for _ in range(5)]
        self._buf = b""

    def copy(self) -> "Keccak256":
        k = Keccak256.__new__(Keccak256)
        k._state = [row[:] for row in self._state]
        k._buf = self._buf
        return k

    def update(self, data: bytes) -> "Keccak256":
        self._buf += data
        while len(self._buf) >= self.RATE:
            block, self._buf = self._buf[: self.RATE], self._buf[self.RATE :]
            self._absorb(block)
        return self

    def _absorb(self, block: bytes):
        for i in range(self.RATE // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            self._state[x][y] ^= lane
        _keccak_f(self._state)

    def digest(self) -> bytes:
        pad_len = self.RATE - len(self._buf)
        if pad_len == 1:
            pad = b"\x81"
        else:
            pad = b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
        clone = self.copy()
        clone._buf = b""
        clone_state = clone._state
        block = self._buf + pad
        for i in range(self.RATE // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            clone_state[x][y] ^= lane
        _keccak_f(clone_state)
        out = b""
        for i in range(4):  # 32 bytes
            x, y = i % 5, i // 5
            out += clone_state[x][y].to_bytes(8, "little")
        return out


def keccak256(data: bytes) -> bytes:
    return Keccak256().update(data).digest()
