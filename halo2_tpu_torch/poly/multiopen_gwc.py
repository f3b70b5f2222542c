"""KZG multiopen, GWC variant (per-point batched openings).

Port of the JAX package's ``poly/multiopen_gwc.py`` (the reference
poly/kzg/multiopen/gwc/{prover,verifier}.rs): queries grouped by point in
first-occurrence order, batched with powers of v, witness polynomial via the
parallel closed-form kate division, and all W commitments in one batched MSM;
the verifier accumulates the two-channel pairing MSM on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..curves import host
from ..curves.point import to_affine_ints
from ..fields import limb
from ..ops import arith


def construct_intermediate_sets(queries):
    """Group queries by point, first-occurrence order (gwc.rs:37-60)."""
    point_map: List = []
    for q in queries:
        for entry in point_map:
            if entry[0] == q.point:
                entry[1].append(q)
                break
        else:
            point_map.append((q.point, [q]))
    return point_map


def gwc_create_proof(params, rng, transcript, queries):
    spec = params.curve.scalar
    p = spec.p
    v = transcript.squeeze_challenge()
    commitment_data = construct_intermediate_sets(queries)

    # All W_i writes happen after the single v squeeze, so the per-point
    # witness polynomials are computed first and committed in ONE batched
    # MSM (transcript byte order unchanged).
    witnesses = []
    for z, qs in commitment_data:
        poly_batch = None
        power = 1
        for q in qs:
            vals = q.poly.values
            scaled = limb.fmul(spec, vals, limb.from_int(spec, power, vals.device).reshape(-1, 1))
            poly_batch = scaled if poly_batch is None else limb.fadd(spec, poly_batch, scaled)
            power = power * v % p
        # witness poly = (poly_batch - eval) / (X - z); the closed-form kate
        # division never reads the constant term, so the eval subtraction is a
        # no-op here (ops/arith.py kate_division).
        witnesses.append(arith.kate_division(spec, poly_batch, z))

    pts = params.commit_coeffs_many(witnesses)
    for aff in to_affine_ints(params.curve, pts):
        transcript.write_point(aff)


# ---------------------------------------------------------------------------
# verifier side — small host MSMs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VerifierQuery:
    commitment: object  # host affine point OR HostMSM
    point: int
    eval: int


class HostMSM:
    """Host-side MSM accumulator (reference MSMKZG, kzg/msm.rs:13-120)."""

    def __init__(self, curve):
        self.curve = curve
        self.terms = []  # (scalar, affine point)

    def append_term(self, scalar: int, point):
        self.terms.append((scalar % self.curve.scalar.p, point))

    def scale(self, factor: int):
        p = self.curve.scalar.p
        self.terms = [(s * factor % p, pt) for s, pt in self.terms]

    def add_msm(self, other: "HostMSM"):
        self.terms.extend(other.terms)

    def eval(self):
        acc = None
        for s, pt in self.terms:
            acc = host.add(self.curve, acc, host.mul(self.curve, pt, s))
        return acc


class DualMSM:
    """Two-channel accumulator for e(L, s*G2) * e(R, -G2) == 1
    (kzg/msm.rs:122-169)."""

    def __init__(self, params):
        self.params = params
        self.left = HostMSM(params.curve)
        self.right = HostMSM(params.curve)

    def check(self) -> bool:
        return self.params.verify_pairing(self.left.eval(), self.right.eval())


def gwc_verify_proof(params, transcript, queries, msm_accumulator: DualMSM):
    """gwc/verifier.rs:48-129; returns the accumulated DualMSM (the Guard)."""
    curve = params.curve
    p = curve.scalar.p
    v = transcript.squeeze_challenge()
    commitment_data = construct_intermediate_sets(queries)
    w = [transcript.read_point() for _ in commitment_data]
    u = transcript.squeeze_challenge()

    commitment_multi = HostMSM(curve)
    eval_multi = 0
    witness = HostMSM(curve)
    witness_with_aux = HostMSM(curve)

    power_u = 1
    for (z, qs), wi in zip(commitment_data, w):
        commitment_batch = HostMSM(curve)
        eval_batch = 0
        power_v = 1
        for q in qs:
            if isinstance(q.commitment, HostMSM):
                m = HostMSM(curve)
                m.terms = list(q.commitment.terms)
                m.scale(power_v)
                commitment_batch.add_msm(m)
            else:
                commitment_batch.append_term(power_v, q.commitment)
            eval_batch = (eval_batch + power_v * q.eval) % p
            power_v = power_v * v % p
        commitment_batch.scale(power_u)
        commitment_multi.add_msm(commitment_batch)
        eval_multi = (eval_multi + power_u * eval_batch) % p
        witness_with_aux.append_term(power_u * z % p, wi)
        witness.append_term(power_u, wi)
        power_u = power_u * u % p

    msm_accumulator.left.add_msm(witness)
    msm_accumulator.right.add_msm(witness_with_aux)
    msm_accumulator.right.add_msm(commitment_multi)
    g0 = (params.curve.gx, params.curve.gy)
    msm_accumulator.right.append_term((-eval_multi) % p, g0)
    return msm_accumulator
