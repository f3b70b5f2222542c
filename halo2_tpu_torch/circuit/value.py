"""Value and Assigned: witness wrappers.

Python rebuild of circuit/value.rs (Option-like witness monad) and
plonk/assigned.rs (deferred-inversion fractions, SURVEY.md §2.15).  Witness
values are canonical Python ints; the field modulus is applied by the backend
at materialization time, so Assigned stays field-agnostic like the reference's
generic F.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class Assigned:
    """Zero | Trivial(num) | Rational(num, den) — division deferred so the
    prover can batch-invert (plonk/assigned.rs:11-18)."""

    numerator: int
    denominator: int = 1  # 0 denominator is not allowed; Zero == numerator 0

    @staticmethod
    def zero() -> "Assigned":
        return Assigned(0, 1)

    @staticmethod
    def trivial(v: int) -> "Assigned":
        return Assigned(v, 1)

    def is_zero_vartime(self) -> bool:
        return self.numerator == 0

    def double(self) -> "Assigned":
        return Assigned(2 * self.numerator, self.denominator)

    def square(self) -> "Assigned":
        return Assigned(self.numerator**2, self.denominator**2)

    def cube(self) -> "Assigned":
        return Assigned(self.numerator**3, self.denominator**3)

    def invert(self) -> "Assigned":
        return Assigned(self.denominator, self.numerator)

    def __neg__(self) -> "Assigned":
        return Assigned(-self.numerator, self.denominator)

    def __add__(self, other) -> "Assigned":
        other = to_assigned(other)
        if self.denominator == other.denominator == 1:
            return Assigned(self.numerator + other.numerator, 1)
        return Assigned(
            self.numerator * other.denominator + other.numerator * self.denominator,
            self.denominator * other.denominator,
        )

    def __radd__(self, other):
        return self + other

    def __sub__(self, other) -> "Assigned":
        return self + (-to_assigned(other))

    def __rsub__(self, other):
        return to_assigned(other) + (-self)

    def __mul__(self, other) -> "Assigned":
        other = to_assigned(other)
        return Assigned(
            self.numerator * other.numerator, self.denominator * other.denominator
        )

    def __rmul__(self, other):
        return self * other

    def evaluate(self, p: int) -> int:
        """Materialize mod p (performs the division; prover batches instead)."""
        num = self.numerator % p
        den = self.denominator % p
        if den == 1:
            return num
        if den == 0:
            raise ZeroDivisionError("Assigned with zero denominator")
        return num * pow(den, -1, p) % p


def to_assigned(v) -> Assigned:
    if isinstance(v, Assigned):
        return v
    if isinstance(v, int):
        return Assigned(v, 1)
    raise TypeError(f"cannot convert {type(v)} to Assigned")


class Value:
    """Option-like wrapper for witness values (circuit/value.rs:16-50)."""

    __slots__ = ("_inner",)

    def __init__(self, inner=None):
        self._inner = inner

    @staticmethod
    def known(v) -> "Value":
        assert v is not None
        return Value(v)

    @staticmethod
    def unknown() -> "Value":
        return Value(None)

    def is_none(self) -> bool:
        return self._inner is None

    def assign(self):
        """Extract the value or raise Synthesis error (value.rs assign())."""
        if self._inner is None:
            from ..plonk.error import SynthesisError

            raise SynthesisError("Value::unknown() used where a value was required")
        return self._inner

    def map(self, f: Callable) -> "Value":
        return Value(None if self._inner is None else f(self._inner))

    def and_then(self, f: Callable) -> "Value":
        return Value.unknown() if self._inner is None else f(self._inner)

    def zip(self, other: "Value") -> "Value":
        if self._inner is None or other._inner is None:
            return Value.unknown()
        return Value((self._inner, other._inner))

    def value(self):
        return self._inner

    def to_assigned(self) -> "Value":
        return self.map(to_assigned)

    # arithmetic lifts
    def __add__(self, other):
        other = other if isinstance(other, Value) else Value.known(other)
        return self.zip(other).map(lambda t: t[0] + t[1])

    def __sub__(self, other):
        other = other if isinstance(other, Value) else Value.known(other)
        return self.zip(other).map(lambda t: t[0] - t[1])

    def __mul__(self, other):
        other = other if isinstance(other, Value) else Value.known(other)
        return self.zip(other).map(lambda t: t[0] * t[1])

    def __neg__(self):
        return self.map(lambda v: -v)

    def double(self):
        return self.map(lambda v: v.double() if isinstance(v, Assigned) else 2 * v)

    def square(self):
        return self.map(lambda v: v.square() if isinstance(v, Assigned) else v * v)

    def invert(self):
        return self.map(lambda v: to_assigned(v).invert())

    def evaluate(self, p: int) -> "Value":
        return self.map(lambda v: to_assigned(v).evaluate(p))

    def __repr__(self):
        return f"Value({self._inner!r})"
