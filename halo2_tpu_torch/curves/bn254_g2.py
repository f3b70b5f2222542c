"""Host-side BN254 Fq2 arithmetic and G2 group operations.

G2 is only touched by parameter setup (s*G2) and the KZG pairing check, both
host-side (SURVEY.md §2.7: "pairing = verifier-side, host OK").  Fq2 = Fq[u]/
(u^2 + 1); the twist curve is y^2 = x^3 + 3/(9+u).
"""

from __future__ import annotations

from ..fields.spec import BN254_FQ, BN254_FR

P = BN254_FQ.p


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        return Fq2(a * c - b * d, a * d + b * c)

    def square(self):
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), 2 * a * b)

    def inv(self):
        a, b = self.c0, self.c1
        t = pow(a * a + b * b, -1, P)
        return Fq2(a * t, -b * t)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __repr__(self):
        return f"Fq2({hex(self.c0)}, {hex(self.c1)})"

    @staticmethod
    def zero():
        return Fq2(0, 0)

    @staticmethod
    def one():
        return Fq2(1, 0)


# curve constant: b' = 3 / (9 + u)
XI = Fq2(9, 1)
B2 = Fq2(3, 0) * XI.inv()

# Standard BN254 (alt_bn128) G2 generator.
G2_GENERATOR = (
    Fq2(
        0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,
        0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2,
    ),
    Fq2(
        0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA,
        0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B,
    ),
)


def g2_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y.square() == x.square() * x + B2


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1.square() * 3) * (y1 * 2).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_mul(pt, k: int):
    k %= BN254_FR.p
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, pt)
        pt = g2_add(pt, pt)
        k >>= 1
    return acc
