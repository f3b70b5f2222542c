"""Spread/interleave bit utilities (table16/util.rs)."""

from __future__ import annotations

MASK_EVEN_32 = 0x55555555


def spread_u16(x: int) -> int:
    """Interleave the 16 bits of x with zeros: bit i -> bit 2i (32-bit out)."""
    assert 0 <= x < (1 << 16)
    out = 0
    for i in range(16):
        out |= ((x >> i) & 1) << (2 * i)
    return out


def interleave_u16(x: int) -> int:
    return spread_u16(x)


def even_bits(spread: int, half: int) -> int:
    """Bits at even positions of a 2*half-bit value."""
    out = 0
    for i in range(half):
        out |= ((spread >> (2 * i)) & 1) << i
    return out


def odd_bits(spread: int, half: int) -> int:
    out = 0
    for i in range(half):
        out |= ((spread >> (2 * i + 1)) & 1) << i
    return out
