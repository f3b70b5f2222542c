"""IPA (Halo-style) polynomial commitment scheme: no trusted setup.

Port of the JAX package's ``poly/ipa.py`` (the reference
poly/ipa/{commitment.rs, commitment/{prover,verifier}.rs, msm.rs,
strategy.rs}) over the Pasta cycle:

- ``ParamsIPA``: the random-oracle SRS {g, g_lagrange, w, u}; g_lagrange via
  the group inverse NTT (``ops/gntt.py``, K2/K3).  On Pallas and Vesta with
  the seed ``b"Halo2-Parameters"`` the SRS points are the reference's own
  SSWU ``hash_to_curve`` (``curves/sswu.py``, ipa/commitment.rs:160-205);
  any other curve or seed takes the blake2b try-and-increment map.
- ``ipa_commit_create_proof``/``ipa_commit_verify_proof``: the k-round inner
  product argument (ipa/commitment/prover.rs:29-153, verifier.rs:23-105),
  with the vector folds (K1), the L/R MSMs and the generator fold
  (``batch_scalar_mul``, K2/K3) on the device.
- ``MSMIPA``/``GuardIPA``/strategies (ipa/msm.rs, ipa/strategy.rs) with the
  x-keyed base dedup and the s-vector expansion ``compute_s``.

``params_from_numpy`` / ``params_to_numpy`` carry an SRS between this package
and the JAX one, as the KZG pair in ``poly/kzg.py`` does.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from ..curves import host
from ..curves.point import Point, batch_normalize, ec_add, from_affine_ints, to_affine_ints
from ..curves.spec import ALL_CURVES, PALLAS, CurveSpec
from ..fields import limb
from ..fields.spec import NLIMBS
from ..ops import arith, gntt
from ..ops import ntt as ntt_ops
from ..ops.msm import msm as device_msm
from ..ops.msm import msm_many
from ..ops.scalar_mul import batch_scalar_mul
from ..utils import profiling
from .polynomial import COEFF, LAGRANGE, Poly


def _map_to_curve(curve: CurveSpec, seed: bytes, index: int):
    """Deterministic try-and-increment point derivation (PARITY.md)."""
    f = curve.base
    ctr = 0
    while True:
        h = hashlib.blake2b(seed + struct.pack("<II", index, ctr), digest_size=64).digest()
        x = int.from_bytes(h, "little") % f.p
        y = f.sqrt((x * x * x + curve.b) % f.p)
        if y is not None and x != 0:
            if y & 1:
                y = f.p - y
            return (x, y)
        ctr += 1


def _srs_points(k: int, curve: CurveSpec, seed: bytes):
    """(g, w, u) as host affine points (ipa/commitment.rs:160-205)."""
    from ..curves.sswu import ISO_PARAMS, hash_to_curve

    n = 1 << k
    if curve.name in ISO_PARAMS and seed == b"Halo2-Parameters":
        # the message for g[i] is the 5-byte [0, i_le32]; w and u use [1], [2]
        hasher = hash_to_curve(curve, "Halo2-Parameters")
        pts = [hasher(b"\x00" + i.to_bytes(4, "little")) for i in range(n)]
        return pts, hasher(b"\x01"), hasher(b"\x02")
    pts = [_map_to_curve(curve, seed, i) for i in range(n)]
    return pts, _map_to_curve(curve, seed + b"-w", 0), _map_to_curve(curve, seed + b"-u", 0)


class ParamsIPA:
    """ipa/commitment.rs:29-36: {g, g_lagrange, w, u} over Pallas/Vesta."""

    def __init__(self, k: int, curve: CurveSpec, g: Point, g_lagrange: Point, w, u):
        self.k = k
        self.n = 1 << k
        self.curve = curve
        self.g = g  # (n,)-batched normalized Point
        self.g_lagrange = g_lagrange
        self.w = w  # host affine (x, y)
        self.u = u

    @property
    def device(self) -> torch.device:
        return self.g.x.device

    @classmethod
    def setup(cls, k: int, curve: CurveSpec = PALLAS, seed: bytes = b"Halo2-Parameters",
              device=None) -> "ParamsIPA":
        """The SRS points on the host, then g_lagrange on ``device``."""
        with profiling.phase("ipa setup: SRS points (host)"):
            pts, w, u = _srs_points(k, curve, seed)
        with profiling.phase("ipa setup: g_to_lagrange"):
            g = from_affine_ints(curve, pts, device)
            g_lagrange = batch_normalize(curve, gntt.g_to_lagrange(curve, g, k))
        return cls(k, curve, g, g_lagrange, w, u)

    # -- commitments (the blind rides the w base, ipa/commitment.rs:90-110,215-235)
    def _with_blinds(self, pts: Point, blinds) -> Point:
        """Add blind_i * w to column i of a (16, m) point batch (host adds)."""
        if not any(blinds):
            return pts
        out = []
        for aff, blind in zip(to_affine_ints(self.curve, pts), blinds):
            if blind:
                aff = host.add(self.curve, aff, host.mul(self.curve, self.w, blind))
            out.append(aff)
        return from_affine_ints(self.curve, out, self.device)

    def _commit_many(self, polys, bases: Point, blinds) -> Point:
        stacked = torch.stack([p.values for p in polys], dim=0)  # (m, 16, n)
        assert len(blinds) == len(polys)
        return self._with_blinds(msm_many(self.curve, stacked, bases), blinds)

    def commit(self, poly: Poly, blind: int = 0) -> Point:
        assert poly.basis == COEFF
        return self._commit_many([poly], self.g, [blind])

    def commit_lagrange(self, poly: Poly, blind: int = 0) -> Point:
        assert poly.basis == LAGRANGE
        return self._commit_many([poly], self.g_lagrange, [blind])

    def commit_many(self, polys, blinds) -> Point:
        """Commit m coefficient-form polys, blind i on poly i, in one batched
        MSM; (16, m) Point."""
        assert all(p.basis == COEFF for p in polys)
        return self._commit_many(polys, self.g, blinds)

    def commit_lagrange_many(self, polys, blinds) -> Point:
        """Commit m Lagrange polys, blind i on poly i, in one batched MSM;
        (16, m) Point."""
        assert all(p.basis == LAGRANGE for p in polys)
        return self._commit_many(polys, self.g_lagrange, blinds)

    def empty_msm(self) -> "MSMIPA":
        return MSMIPA(self)


# ---------------------------------------------------------------------------
# state carried across from / to the JAX package
# ---------------------------------------------------------------------------


def params_from_numpy(state: dict, device=None) -> ParamsIPA:
    """ParamsIPA from numpy state: ``k``, ``curve`` (its name), ``g`` and
    ``g_lagrange`` as (x, y, z) triples of (16, n) uint32 Montgomery limb
    arrays, ``w`` and ``u`` as affine (x, y) ints."""
    (curve,) = [c for c in ALL_CURVES if c.name == state["curve"]]

    def point(coords):
        return Point(*(torch.from_numpy(np.asarray(c).astype(np.int32)).to(device) for c in coords))

    return ParamsIPA(
        int(state["k"]), curve, point(state["g"]), point(state["g_lagrange"]),
        tuple(state["w"]), tuple(state["u"]),
    )


def params_to_numpy(params: ParamsIPA) -> dict:
    """Inverse of :func:`params_from_numpy`."""

    def coords(pt):
        return tuple(c.cpu().numpy().astype(np.uint32) for c in pt)

    return {
        "k": params.k,
        "curve": params.curve.name,
        "g": coords(params.g),
        "g_lagrange": coords(params.g_lagrange),
        "w": params.w,
        "u": params.u,
    }


# ---------------------------------------------------------------------------
# MSMIPA + Guard + strategies (ipa/msm.rs, ipa/strategy.rs)
# ---------------------------------------------------------------------------


class MSMIPA:
    """Accumulator with special bases g / w / u and x-keyed dedup of others."""

    def __init__(self, params: ParamsIPA):
        self.params = params
        self.g_scalars: Optional[List[int]] = None
        self.w_scalar: Optional[int] = None
        self.u_scalar: Optional[int] = None
        self.other: Dict[int, List[int]] = {}  # x -> [scalar, y]

    def append_term(self, scalar: int, point):
        if point is None:
            return
        p = self.params.curve.scalar.p
        x, y = point
        if x in self.other:
            entry = self.other[x]
            if entry[1] == y:
                entry[0] = (entry[0] + scalar) % p
            else:
                entry[0] = (entry[0] - scalar) % p
        else:
            self.other[x] = [scalar % p, y]

    def add_msm(self, other: "MSMIPA"):
        for x, (scalar, y) in other.other.items():
            self.append_term(scalar, (x, y))
        if other.g_scalars is not None:
            self.add_to_g_scalars(other.g_scalars)
        if other.w_scalar is not None:
            self.add_to_w_scalar(other.w_scalar)
        if other.u_scalar is not None:
            self.add_to_u_scalar(other.u_scalar)

    def scale(self, factor: int):
        p = self.params.curve.scalar.p
        if self.g_scalars is not None:
            self.g_scalars = [s * factor % p for s in self.g_scalars]
        for entry in self.other.values():
            entry[0] = entry[0] * factor % p
        if self.w_scalar is not None:
            self.w_scalar = self.w_scalar * factor % p
        if self.u_scalar is not None:
            self.u_scalar = self.u_scalar * factor % p

    def add_constant_term(self, constant: int):
        if self.g_scalars is None:
            self.g_scalars = [0] * self.params.n
        p = self.params.curve.scalar.p
        self.g_scalars[0] = (self.g_scalars[0] + constant) % p

    def add_to_g_scalars(self, scalars: List[int]):
        assert len(scalars) == self.params.n
        p = self.params.curve.scalar.p
        if self.g_scalars is None:
            self.g_scalars = [s % p for s in scalars]
        else:
            self.g_scalars = [(a + b) % p for a, b in zip(self.g_scalars, scalars)]

    def add_to_w_scalar(self, scalar: int):
        p = self.params.curve.scalar.p
        self.w_scalar = ((self.w_scalar or 0) + scalar) % p

    def add_to_u_scalar(self, scalar: int):
        p = self.params.curve.scalar.p
        self.u_scalar = ((self.u_scalar or 0) + scalar) % p

    def eval(self):
        """The MSM's value; the n-sized g part runs on the device."""
        curve = self.params.curve
        acc = None
        if self.g_scalars is not None:
            scal = limb.from_ints(curve.scalar, self.g_scalars, self.params.device)
            acc = to_affine_ints(curve, device_msm(curve, scal, self.params.g))[0]
        for x, (scalar, y) in self.other.items():
            acc = host.add(curve, acc, host.mul(curve, (x, y), scalar))
        if self.w_scalar is not None:
            acc = host.add(curve, acc, host.mul(curve, self.params.w, self.w_scalar))
        if self.u_scalar is not None:
            acc = host.add(curve, acc, host.mul(curve, self.params.u, self.u_scalar))
        return acc

    def check(self) -> bool:
        return self.eval() is None


def compute_s(u: List[int], init: int, p: int) -> List[int]:
    """Coefficients of g(X) = prod (1 + u_{k-1-i} X^{2^i}) (strategy.rs:161)."""
    assert u
    v = [0] * (1 << len(u))
    v[0] = init % p
    length = 1
    for u_j in reversed(u):
        for i in range(length):
            v[length + i] = v[i] * u_j % p
        length <<= 1
    return v


def compute_b(x: int, u: List[int], p: int) -> int:
    """b = prod (1 + u_{k-1-i} x^{2^i}) (ipa/commitment/verifier.rs:103-112)."""
    tmp = 1
    cur = x
    for u_j in reversed(u):
        tmp = tmp * (1 + u_j * cur) % p
        cur = cur * cur % p
    return tmp


class GuardIPA:
    """strategy.rs:24-77."""

    def __init__(self, msm: MSMIPA, neg_c: int, u: List[int]):
        self.msm = msm
        self.neg_c = neg_c
        self.u = u

    def use_challenges(self) -> MSMIPA:
        p = self.msm.params.curve.scalar.p
        self.msm.add_to_g_scalars(compute_s(self.u, self.neg_c, p))
        return self.msm

    def use_g(self, g):
        self.msm.append_term(self.neg_c, g)
        return self.msm, Accumulator(g, list(self.u))

    def compute_g(self):
        params = self.msm.params
        s = compute_s(self.u, 1, params.curve.scalar.p)
        scal = limb.from_canonical_ints(params.curve.scalar, s, params.device)
        return to_affine_ints(params.curve, device_msm(params.curve, scal, params.g))[0]


class Accumulator:
    """Recursion accumulator (strategy.rs:31-40)."""

    def __init__(self, g, u_packed):
        self.g = g
        self.u_packed = u_packed


class IPASingleStrategy:
    """strategy.rs:118-160."""

    def __init__(self, params: ParamsIPA):
        self.params = params

    def process(self, f) -> bool:
        guard = f(MSMIPA(self.params))
        return guard.use_challenges().check()


class IPAAccumulatorStrategy:
    """strategy.rs:80-116: batch accumulation with random scaling."""

    def __init__(self, params: ParamsIPA, rng):
        self.params = params
        self.rng = rng
        self.msm = MSMIPA(params)

    def process(self, f):
        self.msm.scale(self.rng())
        guard = f(self.msm)
        self.msm = guard.use_challenges()
        return self

    def finalize(self) -> bool:
        return self.msm.check()


# ---------------------------------------------------------------------------
# inner product argument: open at a point (ipa/commitment/{prover,verifier}.rs)
# ---------------------------------------------------------------------------


def _scalar(spec, v: int, device):
    return limb.from_int(spec, v, device).reshape(NLIMBS, 1)


def ipa_commit_create_proof(params: ParamsIPA, rng, transcript, p_poly: Poly, p_blind: int,
                            x_3: int):
    """k-round folding argument (ipa/commitment/prover.rs:29-153)."""
    curve = params.curve
    fr = curve.scalar
    p = fr.p
    n = params.n
    dev = params.device
    assert p_poly.values.shape[1] == n

    # random polynomial with a root at x_3
    s_vals = [rng() for _ in range(n)]
    s_at_x3 = 0
    for c in reversed(s_vals):
        s_at_x3 = (s_at_x3 * x_3 + c) % p
    s_vals[0] = (s_vals[0] - s_at_x3) % p
    s_poly = Poly(limb.from_ints(fr, s_vals, dev), COEFF)
    s_blind = rng()
    transcript.write_point(to_affine_ints(curve, params.commit(s_poly, s_blind))[0])

    xi = transcript.squeeze_challenge()
    z = transcript.squeeze_challenge()

    # P' = xi * S + P, with the constant term shifted so that P'(x_3) = 0
    p_prime = limb.fadd(fr, limb.fmul(fr, s_poly.values, _scalar(fr, xi, dev)), p_poly.values)
    v = limb.to_ints(fr, arith.eval_polynomial(fr, p_prime, x_3))[0]
    const = limb.fsub(fr, p_prime[:, :1], _scalar(fr, v, dev))
    p_prime = torch.cat([const, p_prime[:, 1:]], dim=1)
    f = (s_blind * xi + p_blind) % p

    b = ntt_ops.power_table(fr, x_3, n, dev)  # powers of x_3
    g_prime = params.g
    for j in range(params.k):
        half = 1 << (params.k - j - 1)
        p_lo, p_hi = p_prime[:, :half], p_prime[:, half : 2 * half]
        b_lo, b_hi = b[:, :half], b[:, half : 2 * half]
        g_lo = Point(*(c[:, :half] for c in g_prime))
        g_hi = Point(*(c[:, half : 2 * half] for c in g_prime))

        l_j = to_affine_ints(curve, device_msm(curve, p_hi, g_lo))[0]
        r_j = to_affine_ints(curve, device_msm(curve, p_lo, g_hi))[0]
        value_l, value_r = limb.to_ints(fr, torch.stack([
            arith.reduce_add(fr, limb.fmul(fr, p_hi, b_lo)),
            arith.reduce_add(fr, limb.fmul(fr, p_lo, b_hi)),
        ], dim=1))
        l_rand = rng()
        r_rand = rng()
        for pt, value, rand in ((l_j, value_l, l_rand), (r_j, value_r, r_rand)):
            blinded = host.add(
                curve,
                pt,
                host.add(curve, host.mul(curve, params.u, value * z % p),
                         host.mul(curve, params.w, rand)),
            )
            transcript.write_point(blinded)

        u_j = transcript.squeeze_challenge()
        u_j_inv = pow(u_j, -1, p)

        # collapse p', b, G'
        p_prime = limb.fadd(fr, p_lo, limb.fmul(fr, p_hi, _scalar(fr, u_j_inv, dev)))
        b = limb.fadd(fr, b_lo, limb.fmul(fr, b_hi, _scalar(fr, u_j, dev)))
        uj_table = _scalar(fr, u_j, dev).expand(NLIMBS, half).contiguous()
        g_prime = batch_normalize(curve, ec_add(curve, g_lo, batch_scalar_mul(curve, uj_table, g_hi)))

        f = (f + l_rand * u_j_inv + r_rand * u_j) % p

    transcript.write_scalar(limb.to_ints(fr, p_prime)[0])
    transcript.write_scalar(f)


def ipa_commit_verify_proof(params: ParamsIPA, msm: MSMIPA, transcript, x: int, v: int) -> GuardIPA:
    """ipa/commitment/verifier.rs:23-105."""
    p = params.curve.scalar.p

    msm.add_constant_term((-v) % p)
    s_commit = transcript.read_point()
    xi = transcript.squeeze_challenge()
    msm.append_term(xi, s_commit)
    z = transcript.squeeze_challenge()

    rounds = []
    for _ in range(params.k):
        l = transcript.read_point()
        r = transcript.read_point()
        rounds.append((l, r, transcript.squeeze_challenge()))

    u = []
    for l, r, u_j in rounds:
        msm.append_term(pow(u_j, -1, p), l)
        msm.append_term(u_j, r)
        u.append(u_j)

    neg_c = (-transcript.read_scalar()) % p
    f = transcript.read_scalar()
    b = compute_b(x, u, p)

    msm.add_to_u_scalar(neg_c * b % p * z % p)
    msm.add_to_w_scalar((-f) % p)
    return GuardIPA(msm, neg_c, u)
