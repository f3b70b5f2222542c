"""KZG polynomial commitment parameters + commitments (BN254).

Port of the JAX package's ``poly/kzg.py`` (the reference ParamsKZG,
poly/kzg/commitment.rs:23-129).  The SRS is generated on the device
(``setup``) or host-side (``setup_host``), with the same values either way;
commitments are the MSM of ``ops/msm.py`` over ``g`` or
``g_lagrange`` (kzg/commitment.rs:281-292,327-334).  ``device`` is where the
SRS lives, and with it every tensor the prover makes.

``params_from_numpy`` / ``params_to_numpy`` carry an SRS between this package
and the JAX one: point coordinates as (16, n) uint32 Montgomery limb arrays,
G2 points as ((x.c0, x.c1), (y.c0, y.c1)) canonical ints.

Dev setups keep the toxic waste s, so the pairing check can be replaced by
the equivalent known-s G1 check (s*L == R); drop it (``params.s = None``)
to run the real pairing.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from ..curves import bn254_g2
from ..curves.point import Point, batch_normalize, from_affine_ints, to_affine_ints
from ..curves.spec import BN254_G1, CurveSpec
from ..fields import limb
from ..fields.spec import NLIMBS
from ..ops import ntt as ntt_ops
from ..ops.msm import msm, msm_many
from ..ops.scalar_mul import batch_scalar_mul
from ..transcript.transcript import point_from_bytes, point_to_bytes
from .polynomial import COEFF, LAGRANGE, Poly


class ParamsKZG:
    """Universal (trusted) setup for KZG over BN254."""

    curve: CurveSpec = BN254_G1

    def __init__(self, k: int, g: Point, g_lagrange: Point, g2, s_g2, s: int | None = None):
        self.k = k
        self.n = 1 << k
        self.g = g  # (n,)-batched affine Point (z normalized to 1)
        self.g_lagrange = g_lagrange
        self.g2 = g2
        self.s_g2 = s_g2
        self.s = s  # dev-only toxic waste (None for externally loaded params)

    @property
    def device(self) -> torch.device:
        return self.g.x.device

    # ------------------------------------------------------------------
    @staticmethod
    def _toxic_waste(p: int, seed: bytes) -> int:
        s = int.from_bytes(hashlib.blake2b(seed, digest_size=64).digest(), "little") % p
        return s or 1

    @classmethod
    def setup(cls, k: int, seed: bytes = b"halo2-tpu-kzg", device=None) -> "ParamsKZG":
        """SRS computed on ``device``: the same values as :meth:`setup_host`.

        g[i] = s^i * G and g_lagrange[i] = L_i(s) * G with the closed form
        L_i(s) = (s^n - 1)/n * omega^i / (s - omega^i), as the JAX package's
        ``setup``; all 2n scalar multiplications of G are one
        ``batch_scalar_mul`` (K2/K3), then one batched affine normalization.
        """
        curve = cls.curve
        fr = curve.scalar
        n = 1 << k
        s = cls._toxic_waste(fr.p, seed)
        s_pows = ntt_ops.power_table(fr, s, n, device)
        omega = pow(fr.root_of_unity, 1 << (fr.s - k), fr.p)
        omega_pows = ntt_ops.power_table(fr, omega, n, device)
        denom_inv = limb.batch_inv(
            fr, limb.fsub(fr, limb.from_int(fr, s, device).reshape(NLIMBS, 1), omega_pows)
        )
        common = (pow(s, n, fr.p) - 1) * pow(n, -1, fr.p) % fr.p
        li = limb.fmul(
            fr, limb.fmul(fr, omega_pows, limb.from_int(fr, common, device).reshape(NLIMBS, 1)),
            denom_inv,
        )
        gen = from_affine_ints(curve, [(curve.gx, curve.gy)], device)
        g_broad = Point(*(c.expand(NLIMBS, 2 * n).contiguous() for c in gen))
        pts = batch_normalize(curve, batch_scalar_mul(curve, torch.cat([s_pows, li], dim=1), g_broad))
        g = Point(*(c[:, :n].contiguous() for c in pts))
        g_lagrange = Point(*(c[:, n:].contiguous() for c in pts))
        g2 = bn254_g2.G2_GENERATOR
        return cls(k, g, g_lagrange, g2, bn254_g2.g2_mul(g2, s), s=s)

    @classmethod
    def setup_host(cls, k: int, seed: bytes = b"halo2-tpu-kzg", device=None) -> "ParamsKZG":
        """SRS computed host-side with Python ints.

        Same values as the JAX package's ``setup_host`` / ``setup``: 4-bit
        fixed-base windows over G, Jacobian accumulation and one batched
        affine normalization for the whole SRS.
        """
        from ..curves import host

        curve = cls.curve
        fr = curve.scalar
        p = fr.p
        n = 1 << k
        s = cls._toxic_waste(p, seed)

        # fixed-base window table: table[w][d] = d * 16^w * G (affine)
        gpt = (curve.gx, curve.gy)
        table = []
        base = gpt
        for _ in range(64):
            row = [None]
            acc = None
            for _ in range(15):
                acc = host.add(curve, acc, base)
                row.append(acc)
            table.append(row)
            base = host.add(curve, acc, base)  # 16 * (16^w * G)

        def mul_g(scalar: int):
            acc = host.JAC_IDENTITY
            for w in range(64):
                d = (scalar >> (4 * w)) & 0xF
                if d:
                    acc = host.jac_add_mixed(curve, acc, table[w][d])
            return acc

        # g[i] = s^i * G
        s_pows = []
        cur = 1
        for _ in range(n):
            s_pows.append(cur)
            cur = cur * s % p

        # g_lagrange[i] = L_i(s) * G, L_i(s) = (s^n - 1)/n * omega^i / (s - omega^i)
        omega = pow(fr.root_of_unity, 1 << (fr.s - k), p)
        common = (pow(s, n, p) - 1) * pow(n, -1, p) % p
        om = 1
        lag = []
        denoms = []
        for _ in range(n):
            lag.append(common * om % p)
            denoms.append((s - om) % p)
            om = om * omega % p
        # batch-invert the n Lagrange denominators (one pow for all)
        prefix = [1] * (n + 1)
        for i, d in enumerate(denoms):
            prefix[i + 1] = prefix[i] * d % p
        inv = pow(prefix[-1], -1, p)
        for i in range(n - 1, -1, -1):
            lag[i] = lag[i] * (inv * prefix[i] % p) % p
            inv = inv * denoms[i] % p

        jac = [mul_g(v) for v in s_pows] + [mul_g(v) for v in lag]
        aff = host.jac_batch_to_affine(curve, jac)
        g = from_affine_ints(curve, aff[:n], device)
        g_lagrange = from_affine_ints(curve, aff[n:], device)
        g2 = bn254_g2.G2_GENERATOR
        s_g2 = bn254_g2.g2_mul(g2, s)
        return cls(k, g, g_lagrange, g2, s_g2, s=s)

    # ------------------------------------------------------------------
    def commit_lagrange(self, poly: Poly, blind: int = 0) -> Point:
        """MSM over the Lagrange SRS.  KZG ignores the blinding factor
        (kzg/commitment.rs:281-292 takes Blind and drops it)."""
        assert poly.basis == LAGRANGE
        return msm(self.curve, poly.values, self.g_lagrange)

    def commit(self, poly: Poly, blind: int = 0) -> Point:
        assert poly.basis == COEFF
        return msm(self.curve, poly.values, self.g)

    def commit_lagrange_many(self, polys, blinds) -> Point:
        """Commit m Lagrange polys in one batched MSM (blinds ignored, as in
        commit_lagrange).  Returns a batched Point (16, m)."""
        assert all(p.basis == LAGRANGE for p in polys) and len(blinds) == len(polys)
        stacked = torch.stack([p.values for p in polys], dim=0)  # (m, 16, n)
        return msm_many(self.curve, stacked, self.g_lagrange)

    def commit_many(self, polys, blinds) -> Point:
        """Commit m coefficient-form polys in one batched MSM over ``g``
        (blinds ignored)."""
        assert all(p.basis == COEFF for p in polys) and len(blinds) == len(polys)
        return self.commit_coeffs_many([p.values for p in polys])

    def commit_coeffs(self, coeffs) -> Point:
        """Commit raw coefficient limbs of arbitrary length <= n."""
        m = coeffs.shape[1]
        return msm(self.curve, coeffs, Point(*(c[:, :m] for c in self.g)))

    def commit_coeffs_many(self, coeffs_list) -> Point:
        """Commit several raw coefficient arrays of one length in one MSM."""
        m = coeffs_list[0].shape[1]
        stacked = torch.stack(list(coeffs_list), dim=0)
        return msm_many(self.curve, stacked, Point(*(c[:, :m] for c in self.g)))

    def empty_msm(self):
        from .multiopen_gwc import HostMSM

        return HostMSM(self.curve)

    # ------------------------------------------------------------------
    def verify_pairing_known_s(self, lhs, rhs) -> bool:
        """Equivalent of e(L, s G2) * e(R, -G2) == 1 using known s (dev only):
        s * L == R in G1 (host scalar muls)."""
        assert self.s is not None, "params loaded without toxic waste"
        from ..curves import host

        return host.mul(self.curve, lhs, self.s) == rhs

    def verify_pairing(self, lhs, rhs) -> bool:
        """Pairing check e(L, s G2) * e(-R, G2) == 1 (kzg/msm.rs:151-169).

        Dev params keep the toxic waste and use the known-s G1 check; params
        without it run the full optimal-ate pairing (curves/bn254_pairing.py).
        """
        if self.s is not None:
            return self.verify_pairing_known_s(lhs, rhs)
        from ..curves import bn254_pairing as pairing
        from ..curves import host

        return pairing.pairing_check(
            [(lhs, self.s_g2), (host.neg(self.curve, rhs), self.g2)]
        )

    # ------------------------------------------------------------------
    def write(self, path: str):
        """Serialize the SRS with compressed points (the reference's
        Processed format, kzg/commitment.rs write_custom)."""
        gs = to_affine_ints(self.curve, self.g)
        gl = to_affine_ints(self.curve, self.g_lagrange)
        with open(path, "wb") as f:
            f.write(struct.pack("<I", self.k))
            for pt in gs + gl:
                f.write(point_to_bytes(self.curve, pt))
            for g2pt in (self.g2, self.s_g2):
                for c in (g2pt[0].c0, g2pt[0].c1, g2pt[1].c0, g2pt[1].c1):
                    f.write(c.to_bytes(32, "little"))

    @classmethod
    def read(cls, path: str, device=None) -> "ParamsKZG":
        curve = cls.curve
        with open(path, "rb") as f:
            (k,) = struct.unpack("<I", f.read(4))
            n = 1 << k
            pts = [point_from_bytes(curve, f.read(32)) for _ in range(2 * n)]
            g2s = []
            for _ in range(2):
                c = [int.from_bytes(f.read(32), "little") for _ in range(4)]
                g2s.append((bn254_g2.Fq2(c[0], c[1]), bn254_g2.Fq2(c[2], c[3])))
        g = from_affine_ints(curve, pts[:n], device)
        g_lagrange = from_affine_ints(curve, pts[n:], device)
        return cls(k, g, g_lagrange, g2s[0], g2s[1])


# ---------------------------------------------------------------------------
# state carried across from / to the JAX package
# ---------------------------------------------------------------------------


def _g2_to_ints(pt):
    return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


def _g2_from_ints(t):
    (x0, x1), (y0, y1) = t
    return (bn254_g2.Fq2(x0, x1), bn254_g2.Fq2(y0, y1))


def params_from_numpy(state: dict, device=None) -> ParamsKZG:
    """ParamsKZG from numpy state: ``k``, ``g`` and ``g_lagrange`` as (x, y, z)
    triples of (16, n) uint32 Montgomery limb arrays, ``g2`` and ``s_g2`` as
    ((x.c0, x.c1), (y.c0, y.c1)) ints, optional ``s``."""

    def point(coords):
        return Point(*(torch.from_numpy(np.asarray(c).astype(np.int32)).to(device) for c in coords))

    return ParamsKZG(
        int(state["k"]),
        point(state["g"]),
        point(state["g_lagrange"]),
        _g2_from_ints(state["g2"]),
        _g2_from_ints(state["s_g2"]),
        s=state.get("s"),
    )


def params_to_numpy(params: ParamsKZG) -> dict:
    """Inverse of :func:`params_from_numpy`."""

    def coords(pt):
        return tuple(c.cpu().numpy().astype(np.uint32) for c in pt)

    return {
        "k": params.k,
        "g": coords(params.g),
        "g_lagrange": coords(params.g_lagrange),
        "g2": _g2_to_ints(params.g2),
        "s_g2": _g2_to_ints(params.s_g2),
        "s": params.s,
    }
