"""Host-side BN254 optimal-ate pairing for the KZG verifier check.

The reference delegates to halo2curves' ``pairing::Engine``/``MultiMillerLoop``
(SURVEY.md §2.12); the pairing only runs verifier-side on two points
(kzg/msm.rs:151-169), so a Python host implementation suffices — no device
kernel needed.

Tower: Fq2 = Fq[i]/(i^2+1), Fq6 = Fq2[v]/(v^3 - xi) with xi = 9+i,
Fq12 = Fq6[w]/(w^2 - v).  G2 lives on the D-type twist y^2 = x^3 + 3/xi; the
untwist embeds (x, y) -> (x w^2, y w^3).  Miller loop runs over 6u+2 for the
BN parameter u = 4965661367192848881; the final exponentiation is done as a
single integer power (p^12-1)/r — host-side clarity over the cyclotomic
optimizations.
"""

from __future__ import annotations

from ..fields.spec import BN254_FQ, BN254_FR
from .bn254_g2 import Fq2, XI, g2_add, g2_neg

P = BN254_FQ.p
R = BN254_FR.p
BN_U = 4965661367192848881
ATE_LOOP = 6 * BN_U + 2


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one():
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_fq2(self, s: Fq2):
        return Fq6(self.c0 * s, self.c1 * s, self.c2 * s)

    def mul_by_v(self):
        """Multiply by v: (c0, c1, c2) -> (c2*xi, c0, c1)."""
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - a1 * a2 * XI
        t1 = a2.square() * XI - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = (a0 * t0 + (a2 * t1 + a1 * t2) * XI).inv()
        return Fq6(t0 * denom, t1 * denom, t2 * denom)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        return self * self

    def conjugate(self):
        return Fq12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1


def _line(t, q, p_aff):
    """Line through t and q (doubling if t is q) evaluated at the G1 point;
    returns (sparse Fq12 value, t+q)."""
    (x1, y1), (x2, y2) = t, q
    if x1 == x2 and y1 == y2:
        lam = (x1.square() * 3) * (y1 * 2).inv()
    elif x1 == x2:
        raise AssertionError("vertical line should not occur in the ate loop")
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    xp, yp = p_aff
    # l(P) = yP + [-lam*xP + (lam*x1 - y1) v] w
    c0 = Fq6(Fq2(yp, 0), Fq2.zero(), Fq2.zero())
    c1 = Fq6(lam * (-xp), lam * x1 - y1, Fq2.zero())
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return Fq12(c0, c1), (x3, y3)


# Frobenius twist coefficients computed numerically at import
def _fq2_pow(a: Fq2, e: int) -> Fq2:
    result = Fq2.one()
    while e:
        if e & 1:
            result = result * a
        a = a.square()
        e >>= 1
    return result


_FROB_X = _fq2_pow(XI, (P - 1) // 3)  # xi^((p-1)/3)
_FROB_Y = _fq2_pow(XI, (P - 1) // 2)  # xi^((p-1)/2)
_FROB2_X = _fq2_pow(XI, (P * P - 1) // 3)
_FROB2_Y = _fq2_pow(XI, (P * P - 1) // 2)


def _frobenius_g2(q):
    x, y = q
    return (x.conjugate() * _FROB_X, y.conjugate() * _FROB_Y)


def _frobenius2_g2(q):
    x, y = q
    return (x * _FROB2_X, y * _FROB2_Y)


def miller_loop(p_aff, q) -> Fq12:
    """p_aff: G1 affine (x, y) ints; q: G2 affine (Fq2, Fq2)."""
    f = Fq12.one()
    t = q
    bits = bin(ATE_LOOP)[3:]  # skip MSB
    for bit in bits:
        f = f.square()
        l, t = _line(t, t, p_aff)
        f = f * l
        if bit == "1":
            l, t = _line(t, q, p_aff)
            f = f * l
    # frobenius steps: T += pi(Q); T -= pi^2(Q)
    q1 = _frobenius_g2(q)
    q2 = g2_neg(_frobenius2_g2(q))
    l, t = _line(t, q1, p_aff)
    f = f * l
    l, t = _line(t, q2, p_aff)
    f = f * l
    return f


_FINAL_EXP = (P**12 - 1) // R


def pairing(p_aff, q) -> Fq12:
    """Full pairing e(P, Q); identity inputs map to 1."""
    if p_aff is None or q is None:
        return Fq12.one()
    return miller_loop(p_aff, q).pow(_FINAL_EXP)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (the MultiMillerLoop + final exp check)."""
    f = Fq12.one()
    for p_aff, q in pairs:
        if p_aff is None or q is None:
            continue
        f = f * miller_loop(p_aff, q)
    return f.pow(_FINAL_EXP) == Fq12.one()
