"""BN254 in plain Python integers: the scalar field Fr, the base field Fq and
the group G1 (y^2 = x^3 + 3 over Fq), for the reference verifier.

Written from the curve's published constants (EIP-196/197) and halo2curves'
conventions: Fr's multiplicative generator is 7 with 2-adicity 28, so the
2^28-th root of unity is 7^((r-1)/2^28) and the permutation argument's
coset factor is delta = 7^(2^28).  Points are affine (x, y) tuples, None for
the identity; sums and multiples run in Jacobian coordinates.
"""

from __future__ import annotations

P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47  # Fq
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001  # Fr
B = 3
G1 = (1, 2)
FR_GENERATOR = 7
FR_S = 28
ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_S, R)
DELTA = pow(FR_GENERATOR, 1 << FR_S, R)

_JAC_ZERO = (1, 1, 0)


def omega(k: int) -> int:
    """The generator of the 2^k-th roots of unity in Fr."""
    return pow(ROOT_OF_UNITY, 1 << (FR_S - k), R)


def _jac(pt):
    return _JAC_ZERO if pt is None else (pt[0], pt[1], 1)


def _affine(j):
    x, y, z = j
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _double(j):
    x, y, z = j
    if z == 0 or y == 0:
        return _JAC_ZERO
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) ** 2 - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _add(j1, j2):
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    if z1 == 0:
        return j2
    if z2 == 0:
        return j1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        return _double(j1) if s1 == s2 else _JAC_ZERO
    h = (u2 - u1) % P
    i = 4 * h * h % P
    jj = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - jj - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * jj) % P
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) * h % P
    return (x3, y3, z3)


def _mul(j, k: int):
    k %= R
    acc = _JAC_ZERO
    for bit in bin(k)[2:] if k else "":
        acc = _double(acc)
        if bit == "1":
            acc = _add(acc, j)
    return acc


def add(p1, p2):
    return _affine(_add(_jac(p1), _jac(p2)))


def mul(pt, k: int):
    return _affine(_mul(_jac(pt), k))


def lincomb(terms):
    """sum of scalar * point over ``terms`` [(scalar, affine point)]."""
    acc = _JAC_ZERO
    for k, pt in terms:
        if pt is not None and k % R:
            acc = _add(acc, _mul(_jac(pt), k))
    return _affine(acc)


def decompress(b: bytes):
    """halo2curves' compressed G1: x little-endian, the parity of y in the
    top bit of the last byte; 32 zero bytes are the identity.  None for the
    identity; raises ValueError on an encoding that is not a point."""
    if len(b) != 32:
        raise ValueError("a compressed G1 point is 32 bytes")
    if b == bytes(32):
        return None
    raw = bytearray(b)
    sign = raw[31] >> 7
    raw[31] &= 0x7F
    x = int.from_bytes(raw, "little")
    if x >= P:
        raise ValueError("x is not reduced")
    y2 = (x * x * x + B) % P
    y = pow(y2, (P + 1) // 4, P)  # P = 3 mod 4
    if y * y % P != y2:
        raise ValueError("x is not on the curve")
    if y & 1 != sign:
        y = P - y
    return (x, y)
