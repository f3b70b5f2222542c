"""Simplified-SWU hash-to-curve for the Pasta curves (host-side, Python ints).

Byte-compatible with ``pallas::Point::hash_to_curve`` /
``vesta::Point::hash_to_curve`` from halo2curves 0.3.0 (the pasta_curves
construction used by the reference): an XMD-style expand_message over
BLAKE2b-512 into two field elements, the simplified SWU map onto a 3-isogenous
curve (the "iso" curve, which has a != 0 as SSWU requires), and the degree-3
isogeny map back onto the target curve.

Reference behavior mirrored (not copied):
  - halo2_gadgets/src/sinsemilla/primitives.rs:122-135 (Q/S generator use)
  - halo2_proofs/src/poly/ipa/commitment.rs:160-205 (IPA SRS use)

The Pallas pipeline here is pinned bit-for-bit by the reference's own
``SINSEMILLA_S`` table (halo2_gadgets/src/sinsemilla/primitives/
sinsemilla_s.rs): ``hash_to_curve("z.cash:SinsemillaS")(j.to_le_bytes())``
must reproduce all 1024 table entries — see tests/test_sswu.py.

The isogeny constants are NOT transcribed from the reference (it contains
none; they live in the upstream pasta_curves crate, which is not vendored in
this image).  They are *derived* via Velu's formulas in
``halo2_tpu/curves/iso_derive.py``: the iso curve is the unique-up-to-
isomorphism curve (a, 1265) 3-isogenous to the target, and the map is the
Velu 3-isogeny composed with the curve isomorphism u = 1/3 (both facts
verified end-to-end against the SINSEMILLA_S ground truth for Pallas, and the
same canonical choice applied to Vesta).

Everything here is host-side precomputation (SRS/table generation), so plain
Python ints are the right tool — no device dispatch.
"""

from __future__ import annotations

from hashlib import blake2b

from .spec import CurveSpec, PALLAS, VESTA

__all__ = ["hash_to_curve", "hash_to_field", "ISO_PARAMS", "IsoParams"]

_CHUNKLEN = 64  # BLAKE2b-512 output size
_R_IN_BYTES = 128  # BLAKE2b input block size
_SUFFIX = b"_XMD:BLAKE2b_SSWU_RO_"


class IsoParams:
    """SSWU parameters: iso-curve (a, b), Z, and the 13 isogeny-map constants."""

    def __init__(self, a: int, b: int, z: int, iso: list[int]):
        assert len(iso) == 13
        self.a, self.b, self.z, self.iso = a, b, z, iso


# iso-Pallas: verified bit-for-bit against the reference SINSEMILLA_S table.
_PALLAS_P = PALLAS.base.p
_ISO_PALLAS = IsoParams(
    a=0x18354A2EB0EA8C9C49BE2D7258370742B74134581A27A59F92BB4B0B657A014B,
    b=1265,
    z=_PALLAS_P - 13,
    iso=[
        0x0E38E38E38E38E38E38E38E38E38E38E4081775473D8375B775F6034AAAAAAAB,
        0x3509AFD51872D88E267C7FFA51CF412A0F93B82EE4B994958CF863B02814FB76,
        0x17329B9EC525375398C7D7AC3D98FD13380AF066CFEB6D690EB64FAEF37EA4F7,
        0x1C71C71C71C71C71C71C71C71C71C71C8102EEA8E7B06EB6EEBEC06955555580,
        0x1D572E7DDC099CFF5A607FCCE0494A799C434AC1C96B6980C47F2AB668BCD71F,
        0x325669BECAECD5D11D13BF2A7F22B105B4ABF9FB9A1FC81C2AA3AF1EAE5B6604,
        0x1A12F684BDA12F684BDA12F684BDA12F7642B01AD461BAD25AD985B5E38E38E4,
        0x1A84D7EA8C396C47133E3FFD28E7A09507C9DC17725CCA4AC67C31D8140A7DBB,
        0x3FB98FF0D2DDCADD303216CCE1DB9FF11765E924F745937802E2BE87D225B234,
        0x025ED097B425ED097B425ED097B425ED0AC03E8E134EB3E493E53AB371C71C4F,
        0x0C02C5BCCA0E6B7F0790BFB3506DEFB65941A3A4A97AA1B35A28279B1D1B42AE,
        0x17033D3C60C68173573B3D7F7D681310D976BBFABBC5661D4D90AB820B12320A,
        0x40000000000000000000000000000000224698FC094CF91B992D30ECFFFFFDE5,
    ],
)

# iso-Vesta: derived by iso_derive.derive_iso (same Velu construction + the
# same canonical choices that reproduce the pinned Pallas constants: iso-b
# = 1265, scaling u = 1/3).  tests/test_sswu.py re-derives and re-validates.
_VESTA_P = VESTA.base.p
_ISO_VESTA = IsoParams(
    a=0x267F9B2EE592271A81639C4D96F787739673928C7D01B212C515AD7242EAA6B1,
    b=1265,
    z=_VESTA_P - 13,
    iso=[
        0x38E38E38E38E38E38E38E38E38E38E390205DD51CFA0961A43CD42C800000001,
        0x1D935247B4473D17ACECF10F5F7C09A2216B8861EC72BD5D8B95C6AAF703BCC5,
        0x18760C7F7A9AD20DED7EE4A9CDF78F8FD59D03D23B39CB11AEAC67BBEB586A3D,
        0x31C71C71C71C71C71C71C71C71C71C71E1C521A795AC8356FB539A6F0000002B,
        0x0A2DE485568125D51454798A5B5C56B2A3AD678129B604D3B7284F7EAF21A2E9,
        0x14735171EE5427780C621DE8B91C242A30CD6D53DF49D235F169C187D2533465,
        0x12F684BDA12F684BDA12F684BDA12F685601F4709A8ADCB36BEF1642AAAAAAAB,
        0x2EC9A923DA239E8BD6767887AFBE04D121D910AEFB03B31D8BEE58E5FB81DE63,
        0x19B0D87E16E2578866D1466E9DE10E6497A3CA5C24E9EA634986913AB4443034,
        0x1ED097B425ED097B425ED097B425ED098BC32D36FB21A6A38F64842C55555533,
        0x2F44D6C801C1B8BF9E7EB64F890A820C06A767BFC35B5BAC58DFECCE86B2745E,
        0x3D59F455CAFC7668252659BA2B546C7E926847FB9DDD76A1D43D449776F99D2F,
        0x40000000000000000000000000000000224698FC0994A8DD8C46EB20FFFFFDE5,
    ],
)

ISO_PARAMS = {"pallas": _ISO_PALLAS, "vesta": _ISO_VESTA}


def hash_to_field(spec: CurveSpec, domain_prefix: str, msg: bytes) -> tuple[int, int]:
    """Two base-field elements from an XMD-style BLAKE2b-512 expansion.

    Mirrors pasta_curves ``hash_to_field`` (DST = ``{domain_prefix}-{curve_id}
    _XMD:BLAKE2b_SSWU_RO_``; digest bytes reversed then reduced as 512-bit LE).
    """
    field = spec.base
    dst = domain_prefix.encode() + b"-" + spec.name.encode() + _SUFFIX
    assert len(dst) < 256
    tail = dst + bytes([len(dst)])

    def h(data: bytes) -> bytes:
        return blake2b(data, digest_size=_CHUNKLEN).digest()

    b0 = h(b"\x00" * _R_IN_BYTES + msg + bytes([0, _CHUNKLEN * 2, 0]) + tail)
    b1 = h(b0 + b"\x01" + tail)
    b2 = h(bytes(x ^ y for x, y in zip(b0, b1)) + b"\x02" + tail)
    return (
        field.from_bytes_wide(b1[::-1]),
        field.from_bytes_wide(b2[::-1]),
    )


def _map_to_curve_simple_swu(spec: CurveSpec, params: IsoParams, u: int):
    """SSWU map of one field element onto the iso curve (affine)."""
    p = spec.base.p
    a, b, z = params.a, params.b, params.z
    z_u2 = z * u % p * u % p
    ta = (z_u2 * z_u2 + z_u2) % p
    num_x1 = b * (ta + 1) % p
    div = a * (z if ta == 0 else (-ta) % p) % p
    x1 = num_x1 * pow(div, -1, p) % p
    gx1 = (x1 * x1 % p * x1 + a * x1 + b) % p
    y = spec.base.sqrt(gx1)
    if y is not None:
        x = x1
    else:
        # gx2 = g(Z u^2 x1) is guaranteed square when gx1 is not
        x = z_u2 * x1 % p
        gx2 = (x * x % p * x + a * x + b) % p
        y = spec.base.sqrt(gx2)
        assert y is not None, "SSWU: neither gx1 nor gx2 square (impossible)"
    # sgn0 normalization: final y parity equals u's parity.  This fully
    # determines the sqrt sign, so any square-root algorithm agrees with the
    # reference's Sarkar sqrt_ratio here.
    if (u & 1) != (y & 1):
        y = p - y
    return x, y


def _iso_map(spec: CurveSpec, params: IsoParams, pt):
    """Degree-3 isogeny map from the iso curve onto the target curve."""
    if pt is None:
        return None
    p = spec.base.p
    i = params.iso
    x, y = pt
    num_x = (((i[0] * x + i[1]) % p * x + i[2]) % p * x + i[3]) % p
    div_x = ((x + i[4]) % p * x + i[5]) % p
    num_y = ((((i[6] * x + i[7]) % p * x + i[8]) % p * x + i[9]) % p) * y % p
    div_y = (((x + i[10]) % p * x + i[11]) % p * x + i[12]) % p
    if div_x == 0 or div_y == 0:
        return None  # hit the isogeny kernel: maps to the identity
    return (
        num_x * pow(div_x, -1, p) % p,
        num_y * pow(div_y, -1, p) % p,
    )


def hash_to_curve(spec: CurveSpec, domain_prefix: str):
    """Return a hasher ``msg -> (x, y) | None`` matching the reference.

    Only curves with derived iso constants (Pallas, Vesta) are supported;
    BN254 G1 in halo2curves uses a different (SVDW) construction and is not
    required by any reference code path we mirror.
    """
    params = ISO_PARAMS.get(spec.name)
    if params is None:
        raise ValueError(f"no SSWU iso constants for curve {spec.name!r}")

    from . import host

    def hasher(msg: bytes):
        u0, u1 = hash_to_field(spec, domain_prefix, msg)
        q0 = _map_to_curve_simple_swu(spec, params, u0)
        q1 = _map_to_curve_simple_swu(spec, params, u1)
        # Addition happens on the iso curve, which shares the field but has
        # a != 0 — host.add assumes a == 0, so add with explicit lambda here.
        r = _iso_add(spec.base.p, params.a, q0, q1)
        return _iso_map(spec, params, r)

    return hasher


def _iso_add(p: int, a: int, pt1, pt2):
    """Complete affine addition on y^2 = x^3 + a x + b (host ints)."""
    if pt1 is None:
        return pt2
    if pt2 is None:
        return pt1
    x1, y1 = pt1
    x2, y2 = pt2
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + a) % p * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) % p * pow((x2 - x1) % p, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return x3, y3
