"""Field specifications for the PyTorch/CUDA halo2 prover.

Each :class:`FieldSpec` carries the prime modulus plus every derived constant the
proving system needs (Montgomery constants, 2-adic root of unity, coset
generators).  Device arrays hold field elements in **Montgomery form** as 16
little-endian 16-bit limbs (stored as ``torch.int32`` in the port; every limb
is below 2^16), with the limb axis *leading* (shape ``(16, ...)``).  This is
the layout of the JAX package, so arrays of the two compare directly.

Reference parity: mirrors the constants the reference obtains from the external
``halo2curves`` crate (see SURVEY.md §2.12) — BN254 Fr/Fq and the Pasta fields
Fp (Pallas base) / Fq (Vesta base).  Derived constants use the documented
conventions: ``root_of_unity = g^((p-1)/2^S)``, ``delta = g^(2^S)``,
``zeta = g^((p-1)/3)`` (a primitive cube root of unity used as the extended
coset generator, reference poly/domain.rs:81).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# Limb layout: 16 limbs x 16 bits, little-endian, dtype uint32, limb axis 0.
NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = NLIMBS * LIMB_BITS  # Montgomery radix R = 2^256


def int_to_limbs(v: int, n: int = NLIMBS) -> np.ndarray:
    """Python int -> little-endian uint32 limb vector of shape (n,)."""
    out = np.empty((n,), dtype=np.uint32)
    for i in range(n):
        out[i] = v & LIMB_MASK
        v >>= LIMB_BITS
    if v:
        raise ValueError("value does not fit in limbs")
    return out


def limbs_to_int(a) -> int:
    """Little-endian limb vector (leading axis) -> Python int."""
    a = np.asarray(a)
    v = 0
    for i in range(a.shape[0] - 1, -1, -1):
        v = (v << LIMB_BITS) | int(a[i])
    return v


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field (hashable; safe as a jit static arg)."""

    name: str
    p: int
    generator: int  # multiplicative generator of F*, matching halo2curves
    s: int  # two-adicity: 2^s | p-1, 2^(s+1) does not

    def __post_init__(self):
        assert (self.p - 1) % (1 << self.s) == 0
        assert (self.p - 1) % (1 << (self.s + 1)) != 0

    # -- scalar (Python int) helpers; device kernels use the cached numpy views --

    @property
    def r(self) -> int:  # Montgomery R mod p
        return (1 << R_BITS) % self.p

    @property
    def r2(self) -> int:
        return (1 << (2 * R_BITS)) % self.p

    @property
    def r3(self) -> int:
        return (1 << (3 * R_BITS)) % self.p

    @property
    def n0(self) -> int:  # -p^{-1} mod 2^LIMB_BITS (per-digit Montgomery factor)
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def two_inv(self) -> int:
        return pow(2, -1, self.p)

    @property
    def root_of_unity(self) -> int:
        """Primitive 2^s-th root of unity: g^((p-1)/2^s)."""
        return pow(self.generator, (self.p - 1) >> self.s, self.p)

    @property
    def root_of_unity_inv(self) -> int:
        return pow(self.root_of_unity, -1, self.p)

    @property
    def delta(self) -> int:
        """g^(2^s): generates the non-2-adic part; permutation coset separator
        (reference plonk/permutation/keygen.rs:128)."""
        return pow(self.generator, 1 << self.s, self.p)

    @property
    def zeta(self) -> int:
        """Primitive cube root of unity (extended-domain coset generator,
        reference poly/domain.rs:81).

        halo2curves pins ZETA = g^(2(p-1)/3), not g^((p-1)/3): verified for
        pasta Fp against the reference's pinned plonk_api VK (the lookup
        table commitment over a = 2834758237 * ZETA only matches with the
        squared root; tests/test_plonk_api.py), and for bn256 Fr against the
        published ZETA constant 0x30644e72e131a029048b6e19...36636f23.
        """
        assert (self.p - 1) % 3 == 0
        z = pow(self.generator, 2 * (self.p - 1) // 3, self.p)
        assert z != 1 and pow(z, 3, self.p) == 1
        return z

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.p)

    @functools.cached_property
    def r_limbs(self) -> np.ndarray:  # Montgomery form of 1
        return int_to_limbs(self.r)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2)

    @functools.cached_property
    def nprime_limbs(self) -> np.ndarray:
        """-p^{-1} mod 2^256 (full-width Montgomery factor for coarse REDC)."""
        return int_to_limbs((-pow(self.p, -1, 1 << R_BITS)) % (1 << R_BITS))

    @functools.cached_property
    def zero_limbs(self) -> np.ndarray:
        return np.zeros((NLIMBS,), dtype=np.uint32)

    # -- Montgomery conversions on Python ints (host reference path) --

    def to_mont(self, v: int) -> int:
        return (v % self.p) * self.r % self.p

    def from_mont(self, v: int) -> int:
        return v * pow(self.r, -1, self.p) % self.p

    def from_bytes_wide(self, b: bytes) -> int:
        """512-bit little-endian reduction (reference halo2curves from_u512 via
        transcript.rs:499-507): returns canonical value of d0 + d1*2^256 mod p."""
        assert len(b) == 64
        d = int.from_bytes(b, "little")
        return d % self.p

    def sqrt(self, v: int):
        """Tonelli–Shanks square root of canonical v; None if non-residue."""
        p = self.p
        v %= p
        if v == 0:
            return 0
        if pow(v, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(v, (p + 1) // 4, p)
        # general Tonelli-Shanks using the field's 2-adicity
        q = (p - 1) >> self.s
        z = pow(self.generator, q, p)  # 2^s-th primitive root structure
        m, c, t, r = self.s, z, pow(v, q, p), pow(v, (q + 1) // 2, p)
        while t != 1:
            t2, i = t, 0
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r


# ---------------------------------------------------------------------------
# Field instances (moduli/generators mirror halo2curves 0.3.1, SURVEY.md §2.12)
# ---------------------------------------------------------------------------

# BN254 scalar field (Fr): circuit field for the KZG configuration.
BN254_FR = FieldSpec(
    name="bn254_fr",
    p=0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
    generator=7,
    s=28,
)

# BN254 base field (Fq): coordinates of G1.  q-1 = 2 * odd, so s=1.
BN254_FQ = FieldSpec(
    name="bn254_fq",
    p=0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    generator=3,
    s=1,
)

# Pasta: Fp is the Pallas base field == Vesta scalar field.
PASTA_FP = FieldSpec(
    name="pasta_fp",
    p=0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
    generator=5,
    s=32,
)

# Pasta: Fq is the Vesta base field == Pallas scalar field.
PASTA_FQ = FieldSpec(
    name="pasta_fq",
    p=0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    generator=5,
    s=32,
)

ALL_FIELDS = (BN254_FR, BN254_FQ, PASTA_FP, PASTA_FQ)
