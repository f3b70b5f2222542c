"""Poseidon host primitives: Grain LFSR, MDS generation, permutation, sponge.

Rebuild of halo2_gadgets/src/poseidon/primitives{.rs,/grain.rs,/mds.rs,
/p128pow5t3.rs} (SURVEY.md §2.32).  Constants are *generated* (the Grain
self-shrinking LFSR + Cauchy MDS exactly as the Poseidon reference produces
them) rather than baked as the reference's 1.3k-line fp/fq tables; golden
tests pin generated values against the reference's hardcoded constants.

Field elements are canonical Python ints; specs work over any FieldSpec
(Pasta for IPA circuits, BN254 Fr for the KZG flagship).
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import List, Tuple

from ...fields.spec import FieldSpec

STATE_BITS = 80


class Grain:
    """Grain LFSR in self-shrinking mode (grain.rs)."""

    def __init__(self, num_bits: int, t: int, r_f: int, r_p: int):
        state = [True] * STATE_BITS

        def set_bits(offset: int, length: int, value: int):
            for i in range(length):
                state[offset + length - 1 - i] = bool((value >> i) & 1)

        set_bits(0, 2, 1)  # FieldType::PrimeOrder
        set_bits(2, 4, 0)  # SboxType::Pow
        set_bits(6, 12, num_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)

        self.state = state
        self.next_bit = STATE_BITS
        self.num_bits = num_bits

        # discard the first 160 bits
        for _ in range(20):
            self._load_next_8_bits()
            self.next_bit = STATE_BITS

    def _load_next_8_bits(self):
        s = self.state
        new_bits = 0
        for i in range(8):
            bit = s[i + 62] ^ s[i + 51] ^ s[i + 38] ^ s[i + 23] ^ s[i + 13] ^ s[i]
            new_bits |= int(bit) << i
        self.state = s[8:] + s[:8]
        self.next_bit -= 8
        for i in range(8):
            self.state[self.next_bit + i] = bool((new_bits >> i) & 1)

    def _get_next_bit(self) -> bool:
        if self.next_bit == STATE_BITS:
            self._load_next_8_bits()
        bit = self.state[self.next_bit]
        self.next_bit += 1
        return bit

    def next_bit_shrunk(self) -> bool:
        """Self-shrinking: 1x -> output x; 0x -> discard."""
        while not self._get_next_bit():
            self._get_next_bit()
        return self._get_next_bit()

    def _next_value(self) -> int:
        """num_bits LFSR bits interpreted MSB-first."""
        v = 0
        for _ in range(self.num_bits):
            v = (v << 1) | int(self.next_bit_shrunk())
        return v

    def next_field_element(self, p: int) -> int:
        while True:
            v = self._next_value()
            if v < p:
                return v

    def next_field_element_without_rejection(self, p: int) -> int:
        return self._next_value() % p


def generate_mds(grain: Grain, p: int, t: int, select: int):
    """Cauchy MDS a_ij = 1/(x_i + y_j) + Schechter inverse (mds.rs)."""
    while True:
        while True:
            vals = [grain.next_field_element_without_rejection(p) for _ in range(2 * t)]
            if len(set(vals)) == 2 * t:
                xs, ys = vals[:t], vals[t:]
                break
        if select != 0:
            select -= 1
            continue
        mds = [[0] * t for _ in range(t)]
        ok = True
        for i in range(t):
            for j in range(t):
                s = (xs[i] + ys[j]) % p
                assert s != 0
                mds[i][j] = pow(s, -1, p)
        if ok:
            break

    # inverse via Lagrange polynomials over xs and -ys (Schechter 1959 Thm 1)
    def lagr(points: List[int], j: int, x: int) -> int:
        x_j = points[j]
        acc = 1
        for m, x_m in enumerate(points):
            if m == j:
                continue
            acc = acc * (x - x_m) % p * pow((x_j - x_m) % p, -1, p) % p
        return acc

    neg_ys = [(-y) % p for y in ys]
    mds_inv = [[0] * t for _ in range(t)]
    for i in range(t):
        for j in range(t):
            mds_inv[i][j] = (
                (xs[j] - neg_ys[i]) % p
                * lagr(xs, j, neg_ys[i])
                % p
                * lagr(neg_ys, i, xs[j])
                % p
            )
    return mds, mds_inv


@dataclasses.dataclass(frozen=True)
class PoseidonSpec:
    """Spec parameterization (primitives.rs Spec trait).  P128Pow5T3 over a
    given field is PoseidonSpec(spec, 3, 2) with 8 full / 56 partial rounds."""

    field: FieldSpec
    t: int = 3
    rate: int = 2
    full_rounds: int = 8
    partial_rounds: int = 56
    secure_mds: int = 0

    def sbox(self, v: int) -> int:
        return pow5(v, self.field.p)

    @functools.cached_property
    def _constants(self) -> Tuple[List[List[int]], list, list]:
        p = self.field.p
        grain = Grain(p.bit_length(), self.t, self.full_rounds, self.partial_rounds)
        round_constants = [
            [grain.next_field_element(p) for _ in range(self.t)]
            for _ in range(self.full_rounds + self.partial_rounds)
        ]
        mds, mds_inv = generate_mds(grain, p, self.t, self.secure_mds)
        return round_constants, mds, mds_inv

    def constants(self):
        return self._constants


# P128Pow5T3 spec instances for the fields the reference ships constants for,
# plus BN254 Fr for the KZG flagship configuration.
def p128_pow5_t3(field: FieldSpec) -> PoseidonSpec:
    return PoseidonSpec(field, 3, 2, 8, 56, 0)


def pow5(x: int, p: int) -> int:
    """The S-box x^5 mod p, by three products (``pow(x, 5, p)`` is slower)."""
    x2 = x * x % p
    return x2 * x2 % p * x % p


def mds_mul(mds, state: List[int], p: int) -> List[int]:
    """``mds`` times ``state``, mod p; unrolled at width 3 (P128Pow5T3)."""
    if len(state) == 3:
        (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = mds
        s0, s1, s2 = state
        return [(a0 * s0 + a1 * s1 + a2 * s2) % p,
                (b0 * s0 + b1 * s1 + b2 * s2) % p,
                (c0 * s0 + c1 * s1 + c2 * s2) % p]
    return [sum(map(operator.mul, row, state)) % p for row in mds]


def full_round(p: int, mds, state: List[int], rcs: List[int]) -> List[int]:
    """One full round: the constants, the S-box on every word, the MDS."""
    return mds_mul(mds, [pow5((w + c) % p, p) for w, c in zip(state, rcs)], p)


def partial_round(p: int, mds, state: List[int], rcs: List[int]) -> List[int]:
    """One partial round: the constants, the S-box on word 0, the MDS."""
    words = [w + c for w, c in zip(state, rcs)]
    words[0] = pow5(words[0] % p, p)
    return mds_mul(mds, words, p)


def permute(spec: PoseidonSpec, state: List[int]) -> List[int]:
    """The Poseidon permutation (primitives.rs permute())."""
    p = spec.field.p
    round_constants, mds, _ = spec.constants()
    partial = range(spec.full_rounds // 2, spec.full_rounds // 2 + spec.partial_rounds)
    for r, rcs in enumerate(round_constants):
        state = (partial_round if r in partial else full_round)(p, mds, state, rcs)
    return state


class Sponge:
    """Duplex sponge in absorbing mode (primitives.rs Sponge)."""

    def __init__(self, spec: PoseidonSpec, initial_capacity_element: int):
        self.spec = spec
        self.state = [0] * spec.t
        self.state[spec.rate] = initial_capacity_element % spec.field.p
        self.absorbing: List[int] = []

    def _permute_with_input(self):
        p = self.spec.field.p
        for i, v in enumerate(self.absorbing):
            self.state[i] = (self.state[i] + v) % p
        self.state = permute(self.spec, self.state)

    def absorb(self, value: int):
        if len(self.absorbing) < self.spec.rate:
            self.absorbing.append(value % self.spec.field.p)
            return
        self._permute_with_input()
        self.absorbing = [value % self.spec.field.p]

    def finish_absorbing(self):
        self._permute_with_input()
        self.absorbing = None
        return self

    def squeeze(self) -> int:
        return self.state[0]


class ConstantLength:
    """Constant-input-length domain (primitives.rs ConstantLength<L>)."""

    def __init__(self, length: int):
        self.length = length

    def name(self) -> str:
        return f"ConstantLength<{self.length}>"

    def initial_capacity_element(self) -> int:
        return self.length << 64

    def padding(self, rate: int) -> List[int]:
        k = (self.length + rate - 1) // rate
        return [0] * (k * rate - self.length)


def hash_message(spec: PoseidonSpec, domain: ConstantLength, message: List[int]) -> int:
    """Hash::init().hash(message) (primitives.rs Hash)."""
    assert len(message) == domain.length
    sponge = Sponge(spec, domain.initial_capacity_element())
    for v in list(message) + domain.padding(spec.rate):
        sponge.absorb(v)
    return sponge.finish_absorbing().squeeze()
