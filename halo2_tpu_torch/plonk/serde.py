"""Key and params serialization: SerdeFormat and the vk / pk readers and writers.

Port of the JAX package's ``plonk/serde.py`` (helpers.rs SerdeFormat and
selector packing; plonk.rs VerifyingKey / ProvingKey read and write), byte for
byte.  The layout: vk = k (u32 BE) | number of fixed commitments (u32 BE) |
fixed commitments | number of permutation commitments (u32 BE) | permutation
commitments | bit-packed selectors, LSB first, ceil(n/8) bytes each; pk = vk |
l0 | l_last | l_active_row | fixed values | fixed polys | fixed cosets |
permutation polys (Lagrange, coefficient, coset), a poly as its length
(u32 BE) and its scalars, a list of polys as its count (u32 BE) and its polys.

``PROCESSED`` writes compressed points (x with y's parity in bit 255) and
canonical scalars; ``RAW_BYTES`` / ``RAW_BYTES_UNCHECKED`` write uncompressed
affine points (identity = 64 zero bytes) and scalars as the 32 little-endian
bytes of their Montgomery form, the halo2curves ``SerdeObject`` layout.
``RAW_BYTES`` rejects (``ValueError``) a value at or above the modulus and a
point off the curve; ``RAW_BYTES_UNCHECKED`` checks nothing and, as the
reference's v * R^-1 read followed by a Montgomery write does, keeps v mod p.

Nothing moves one scalar at a time: a batch of n field elements is a (16, n)
limb tensor, and 32 little-endian bytes are its 16 little-endian 16-bit limbs,
so the bytes are a numpy view of the transposed limbs.  What differs between
the formats is a K1 product on the tensor's device: by 1 to leave Montgomery
form when writing ``PROCESSED``, by R^2 to enter it when reading, by R mod p
(Montgomery one) for the unchecked reduction.  Bounds and the curve equation
are checked on the same device, and a compressed point is decompressed there:
y = sqrt(x^3 + b) through K1's chain entry ``mont_pow`` (one launch where p = 3
mod 4, as for BN254; a fixed Tonelli–Shanks ladder otherwise, as for Pasta).
Readers put what they read on ``device``, the card unless the caller asks for
another.
"""

from __future__ import annotations

import io
import struct
from enum import Enum
from typing import List

import numpy as np
import torch

from ..curves.point import Point, from_affine_ints, to_affine_ints
from ..curves.spec import CurveSpec
from ..fields import limb
from ..fields.spec import NLIMBS, FieldSpec
from ..poly.domain import EvaluationDomain
from ..poly.polynomial import COEFF, EXTENDED, LAGRANGE, Poly
from .circuit import ConstraintSystem
from .keygen import ProvingKey, VerifyingKey, compress_selectors


class SerdeFormat(Enum):
    PROCESSED = 0
    RAW_BYTES = 1
    RAW_BYTES_UNCHECKED = 2


def pack(bits: List[bool]) -> int:
    """Pack up to 8 bools into a byte, LSB-first (helpers.rs pack)."""
    byte = 0
    for i, bit in enumerate(bits):
        byte |= int(bool(bit)) << i
    return byte


def unpack(byte: int, count: int = 8) -> List[bool]:
    return [bool((byte >> i) & 1) for i in range(count)]


# ---------------------------------------------------------------------------
# limbs <-> bytes
# ---------------------------------------------------------------------------


def _to_bytes(rows: torch.Tensor) -> bytes:
    """(..., 16) limb rows -> their little-endian bytes, 32 a row: the limbs
    as int16 with the same 16 bits (a limb >= 2^15 less 2^16)."""
    signed = torch.where(rows >= 1 << 15, rows - (1 << 16), rows).to(torch.int16)
    return signed.contiguous().cpu().numpy().astype("<i2", copy=False).tobytes()


def _read_exact(r, nbytes: int) -> bytes:
    data = r.read(nbytes)
    if len(data) != nbytes:
        raise ValueError(f"unexpected end of data: wanted {nbytes} bytes, got {len(data)}")
    return data


def _from_bytes(data: bytes, count: int, device) -> torch.Tensor:
    """``count`` 32-byte little-endian words -> (16, count) int32 limbs on device."""
    rows = np.frombuffer(data, dtype="<i2", count=NLIMBS * count).reshape(count, NLIMBS)
    t = torch.from_numpy(rows.astype(np.int16)).to(device)
    return (t.T.to(torch.int32) & 0xFFFF).contiguous()


def below_p(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise a < p for (16, ...) limbs in [0, 2^16): the borrow out of a - p."""
    borrow = torch.zeros_like(a[0])
    for ai, pi in zip(a, spec.p_limbs):
        borrow = (ai - int(pi) - borrow < 0).to(a.dtype)
    return borrow.bool()


def _require(ok: torch.Tensor, msg: str) -> None:
    if not bool(ok.all()):
        raise ValueError(msg)


def _const(spec: FieldSpec, v: int, like: torch.Tensor) -> torch.Tensor:
    """The Montgomery form of canonical v, broadcastable to ``like``."""
    return limb.from_int(spec, v, like.device).reshape((NLIMBS,) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# scalars
# ---------------------------------------------------------------------------


def scalars_to_bytes(spec: FieldSpec, values: torch.Tensor, fmt: SerdeFormat) -> bytes:
    """(16, n) Montgomery limbs -> n scalars of 32 bytes."""
    if fmt == SerdeFormat.PROCESSED:
        values = limb.from_mont(spec, values)
    return _to_bytes(values.T)


def scalars_from_bytes(spec: FieldSpec, data: bytes, n: int, fmt: SerdeFormat,
                       device="cuda") -> torch.Tensor:
    """n scalars of 32 bytes -> (16, n) Montgomery limbs on ``device``,
    checked or reduced as ``fmt`` says."""
    v = _from_bytes(data, n, device)
    if fmt == SerdeFormat.RAW_BYTES_UNCHECKED:
        return limb.fmul(spec, v, limb.one_like(spec, v))  # v * R * R^-1 = v mod p
    what = "field element" if fmt == SerdeFormat.PROCESSED else "raw field element"
    _require(below_p(spec, v), f"{what} exceeds the modulus")
    return limb.to_mont(spec, v) if fmt == SerdeFormat.PROCESSED else v


# ---------------------------------------------------------------------------
# points
# ---------------------------------------------------------------------------


def point_bytes(fmt: SerdeFormat) -> int:
    return 32 if fmt == SerdeFormat.PROCESSED else 64


def points_to_bytes(curve: CurveSpec, pts: Point, fmt: SerdeFormat) -> bytes:
    """A (16, n) point batch -> n encoded points.  The points are normalized
    to z = 1 first (one ``finv``); the identity becomes x = y = 0, which both
    encodings write as zero bytes, as the reference does."""
    f = curve.base
    zinv = limb.finv(f, pts.z)
    x, y = limb.fmul(f, pts.x, zinv), limb.fmul(f, pts.y, zinv)
    if fmt != SerdeFormat.PROCESSED:
        return _to_bytes(torch.stack([x, y]).permute(2, 0, 1))  # (n, [x, y], 16)
    x, y = limb.from_mont(f, x), limb.from_mont(f, y)
    x[NLIMBS - 1] |= (y[0] & 1) << 15
    return _to_bytes(x.T)


def sqrt_candidates(f: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """For Montgomery a, a square root of each element that has one (anything
    elsewhere: the caller checks y^2 == a).

    p = 3 mod 4: a^((p+1)/4), one ``mont_pow``.  Otherwise Tonelli–Shanks
    with a fixed ladder: x = a^((q+1)/2) and t = a^q for p - 1 = q * 2^s keep
    x^2 = a * t; for i = s-1 .. 1, where t^(2^(i-1)) != 1, multiply t by
    c_i^2 and x by c_i, c_i = z^(2^(s-1-i)) for a primitive 2^s-th root z.
    """
    if f.p % 4 == 3:
        return limb.fpow_const(f, a, (f.p + 1) // 4)
    q = (f.p - 1) >> f.s
    x = limb.fpow_const(f, a, (q + 1) // 2)
    t = limb.fpow_const(f, a, q)
    one = limb.one_like(f, a)
    z = pow(f.generator, q, f.p)
    for i in range(f.s - 1, 0, -1):
        c = pow(z, 1 << (f.s - 1 - i), f.p)
        flip = ~(limb.fpow_const(f, t, 1 << (i - 1)) == one).all(dim=0)
        x = limb.select(flip, limb.fmul(f, x, _const(f, c, x)), x)
        t = limb.select(flip, limb.fmul(f, t, _const(f, c * c % f.p, t)), t)
    return x


def _affine(f: FieldSpec, x, y, ident) -> Point:
    """Montgomery affine coordinates -> a Point with z = 1, and the
    identity as ``from_affine_ints`` makes it: (0, 1, 0)."""
    one = limb.one_like(f, x)
    zero = torch.zeros_like(x)
    return Point(limb.select(ident, zero, x), limb.select(ident, one, y),
                 limb.select(ident, zero, one).contiguous())


def points_from_bytes(curve: CurveSpec, data: bytes, n: int, fmt: SerdeFormat,
                      device="cuda") -> Point:
    """n encoded points -> a (16, n) affine Point batch on ``device``."""
    f = curve.base
    b = lambda like: _const(f, curve.b, like)  # noqa: E731
    if fmt == SerdeFormat.PROCESSED:
        raw = _from_bytes(data, n, device)
        ident = (raw == 0).all(dim=0)
        sign = raw[NLIMBS - 1] >> 15
        raw[NLIMBS - 1] &= 0x7FFF
        _require(below_p(f, raw), "invalid point encoding in proof")
        x = limb.to_mont(f, raw)
        y2 = limb.fadd(f, limb.fmul(f, limb.fsquare(f, x), x), b(x))
        y = sqrt_candidates(f, y2)
        _require((limb.fsquare(f, y) == y2).all(dim=0) | ident, "invalid point encoding in proof")
        flip = (limb.from_mont(f, y)[0] & 1) != sign
        return _affine(f, x, limb.select(flip, limb.fneg(f, y), y), ident)
    xy = _from_bytes(data, 2 * n, device)
    x, y = xy[:, 0::2].contiguous(), xy[:, 1::2].contiguous()
    ident = (x == 0).all(dim=0) & (y == 0).all(dim=0)
    if fmt == SerdeFormat.RAW_BYTES:
        _require(below_p(f, x) & below_p(f, y), "raw field element exceeds the modulus")
        on_curve = (limb.fsquare(f, y) == limb.fadd(f, limb.fmul(f, limb.fsquare(f, x), x), b(x)))
        _require(on_curve.all(dim=0) | ident, "raw point is not on the curve")
    else:
        one = limb.one_like(f, x)
        x, y = limb.fmul(f, x, one), limb.fmul(f, y, one)
    return _affine(f, x, y, ident)


def _write_affine(w, curve: CurveSpec, pts: list, fmt: SerdeFormat, device) -> None:
    """Host affine points (``None`` = identity) -> bytes, as one batch."""
    if pts:
        w.write(points_to_bytes(curve, from_affine_ints(curve, pts, device), fmt))


def _read_affine(r, curve: CurveSpec, count: int, fmt: SerdeFormat, device) -> list:
    if count == 0:
        return []
    data = _read_exact(r, count * point_bytes(fmt))
    return to_affine_ints(curve, points_from_bytes(curve, data, count, fmt, device))


# ---------------------------------------------------------------------------
# polys
# ---------------------------------------------------------------------------


def _write_poly(w, spec: FieldSpec, poly: Poly, fmt: SerdeFormat):
    w.write(struct.pack(">I", poly.values.shape[1]))
    w.write(scalars_to_bytes(spec, poly.values, fmt))


def _read_u32(r) -> int:
    (v,) = struct.unpack(">I", _read_exact(r, 4))
    return v


def _read_poly(r, spec: FieldSpec, basis, fmt: SerdeFormat, device) -> Poly:
    n = _read_u32(r)
    return Poly(scalars_from_bytes(spec, _read_exact(r, 32 * n), n, fmt, device), basis)


def _write_poly_slice(w, spec: FieldSpec, polys: List[Poly], fmt: SerdeFormat):
    w.write(struct.pack(">I", len(polys)))
    for poly in polys:
        _write_poly(w, spec, poly, fmt)


def _read_poly_slice(r, spec: FieldSpec, basis, fmt: SerdeFormat, device) -> List[Poly]:
    return [_read_poly(r, spec, basis, fmt, device) for _ in range(_read_u32(r))]


# ---------------------------------------------------------------------------
# VerifyingKey
# ---------------------------------------------------------------------------


def write_vk(vk: VerifyingKey, w, curve: CurveSpec, fmt: SerdeFormat = SerdeFormat.PROCESSED):
    device = vk.domain.device
    w.write(struct.pack(">I", vk.domain.k))
    w.write(struct.pack(">I", len(vk.fixed_commitments)))
    _write_affine(w, curve, vk.fixed_commitments, fmt, device)
    w.write(struct.pack(">I", len(vk.permutation_commitments)))
    _write_affine(w, curve, vk.permutation_commitments, fmt, device)
    for selector in vk.selectors:
        w.write(np.packbits(np.asarray(selector, dtype=bool), bitorder="little").tobytes())


def read_vk(r, curve: CurveSpec, circuit_cls, spec=None,
            fmt: SerdeFormat = SerdeFormat.PROCESSED, device="cuda") -> VerifyingKey:
    spec = spec or curve.scalar
    k = _read_u32(r)
    cs = ConstraintSystem()
    circuit_cls.configure(cs)
    domain = EvaluationDomain(spec, cs.degree(), k, device)
    fixed_commitments = _read_affine(r, curve, _read_u32(r), fmt, device)
    perm_commitments = _read_affine(r, curve, _read_u32(r), fmt, device)
    n = 1 << k
    selectors = []
    for _ in range(cs.num_selectors):
        packed = np.frombuffer(_read_exact(r, (n + 7) // 8), dtype=np.uint8)
        selectors.append(np.unpackbits(packed, bitorder="little")[:n].astype(bool))
    compress_selectors(cs, selectors)
    return VerifyingKey(domain, cs, fixed_commitments, perm_commitments, selectors, curve)


def vk_to_bytes(vk: VerifyingKey, curve: CurveSpec,
                fmt: SerdeFormat = SerdeFormat.PROCESSED) -> bytes:
    buf = io.BytesIO()
    write_vk(vk, buf, curve, fmt)
    return buf.getvalue()


def vk_from_bytes(data: bytes, curve: CurveSpec, circuit_cls, spec=None,
                  fmt: SerdeFormat = SerdeFormat.PROCESSED, device="cuda") -> VerifyingKey:
    return read_vk(io.BytesIO(data), curve, circuit_cls, spec, fmt, device)


# ---------------------------------------------------------------------------
# ProvingKey
# ---------------------------------------------------------------------------


def write_pk(pk: ProvingKey, w, curve: CurveSpec, fmt: SerdeFormat = SerdeFormat.PROCESSED):
    spec = pk.vk.domain.spec
    write_vk(pk.vk, w, curve, fmt)
    for poly in (pk.l0, pk.l_last, pk.l_active_row):
        _write_poly(w, spec, poly, fmt)
    for polys in (pk.fixed_values, pk.fixed_polys, pk.fixed_cosets, pk.permutation.permutations,
                  pk.permutation.polys, pk.permutation.cosets):
        _write_poly_slice(w, spec, polys, fmt)


def read_pk(r, curve: CurveSpec, circuit_cls, spec=None,
            fmt: SerdeFormat = SerdeFormat.PROCESSED, device="cuda") -> ProvingKey:
    from .evaluation import Evaluator
    from .permutation import PermutationPK

    vk = read_vk(r, curve, circuit_cls, spec, fmt, device)
    spec = vk.domain.spec
    l0, l_last, l_active_row = (_read_poly(r, spec, EXTENDED, fmt, device) for _ in range(3))
    fixed_values, fixed_polys, fixed_cosets, permutations, polys, cosets = (
        _read_poly_slice(r, spec, basis, fmt, device)
        for basis in (LAGRANGE, COEFF, EXTENDED, LAGRANGE, COEFF, EXTENDED)
    )
    return ProvingKey(
        vk, l0, l_last, l_active_row, fixed_values, fixed_polys, fixed_cosets,
        PermutationPK(permutations, polys, cosets), Evaluator(vk.cs),
    )


def pk_to_bytes(pk: ProvingKey, curve: CurveSpec, fmt: SerdeFormat = SerdeFormat.PROCESSED) -> bytes:
    buf = io.BytesIO()
    write_pk(pk, buf, curve, fmt)
    return buf.getvalue()


def pk_from_bytes(data: bytes, curve: CurveSpec, circuit_cls, spec=None,
                  fmt: SerdeFormat = SerdeFormat.PROCESSED, device="cuda") -> ProvingKey:
    return read_pk(io.BytesIO(data), curve, circuit_cls, spec, fmt, device)
