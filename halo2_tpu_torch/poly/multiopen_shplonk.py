"""KZG multiopen, SHPLONK (BDFG20) variant: two proof points in all.

Port of the JAX package's ``poly/multiopen_shplonk.py`` (the reference
poly/kzg/multiopen/shplonk/{prover,verifier}.rs): queries are grouped into
*rotation sets* (commitments opened at the same point set), each set's
polynomials are combined with powers of y against their low-degree
(Lagrange-interpolated) equivalents, divided by the set's vanishing
polynomial, and combined across sets with powers of v into h(X); after the
u challenge a linearization l(X) is divided by (X - u) into the second
witness commitment.

Device work: the y/v linear combinations (K1), the kate divisions and the
two commitment MSMs (K2/K3).  Host work: interpolation over <= 4 points,
vanishing evaluations, transcript.

Two spans (``utils/profiling.phase``), nested in the prover's "multiopen":
``H_PHASE`` from after y's squeeze through h's transcript write (the sets,
the batched evaluations and their pull, the interpolation, v, the sets'
combination, the divisions and h's commitment) and ``L_PHASE`` from after
u's squeeze through the second write (the linearization, its division and
commitment).

Commitment identity follows the reference's pointer equality
(poly/query.rs ``PartialEq`` = ``ptr::eq``): Python object identity of the
poly or commitment object, so the prover must hand over the very ``Poly``
objects it queried, never a fresh copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..curves.point import to_affine_ints
from ..fields import limb
from ..fields.spec import NLIMBS
from ..ops import arith
from ..utils import profiling
from .multiopen_gwc import DualMSM, HostMSM
from .polynomial import COEFF, Poly


def construct_intermediate_sets(queries, get_commitment, get_point):
    """(rotation_sets, super_point_set), as shplonk.rs:56-147.

    rotation_sets: list of (points sorted ascending, [commitments]);
    commitments in first-occurrence order, point sets compared as sets (the
    reference compares BTreeSets), points sorted by canonical integer
    (BTreeSet iteration order).
    """
    super_point_set = set()
    commitment_rotations: List[Tuple[object, set]] = []  # insertion order
    key_index: Dict[int, int] = {}
    for q in queries:
        point = get_point(q)
        super_point_set.add(point)
        key = id(get_commitment(q))
        if key in key_index:
            commitment_rotations[key_index[key]][1].add(point)
        else:
            key_index[key] = len(commitment_rotations)
            commitment_rotations.append((get_commitment(q), {point}))

    rotation_sets: List[Tuple[frozenset, List[object]]] = []
    for commitment, rotations in commitment_rotations:
        fs = frozenset(rotations)
        for entry in rotation_sets:
            if entry[0] == fs:
                entry[1].append(commitment)
                break
        else:
            rotation_sets.append((fs, [commitment]))
    return (
        [(sorted(points), comms) for points, comms in rotation_sets],
        sorted(super_point_set),
    )


H_PHASE = "multiopen: shplonk h(X)"
L_PHASE = "multiopen: shplonk l(X)"


def _eval_vanishing(points, z: int, p: int) -> int:
    acc = 1
    for pt in points:
        acc = acc * (z - pt) % p
    return acc


# ---------------------------------------------------------------------------
# prover (shplonk/prover.rs:105-285)
# ---------------------------------------------------------------------------


def shplonk_create_proof(params, rng, transcript, queries):
    spec = params.curve.scalar
    p = spec.p
    dev = params.device

    y = transcript.squeeze_challenge()

    def scalar(value: int):
        return limb.from_int(spec, value, dev).reshape(NLIMBS, 1)

    with profiling.phase(H_PHASE):
        rotation_sets, super_point_set = construct_intermediate_sets(
            queries, lambda q: q.poly, lambda q: q.point
        )

        # every (poly, point) evaluation the sets need, in one batched pass
        pairs = [(poly, pt) for points, comms in rotation_sets for poly in comms for pt in points]
        evals = limb.to_ints(spec, arith.eval_polynomials_batched(
            spec,
            torch.stack([poly.values for poly, _ in pairs], dim=1),
            limb.from_ints(spec, [pt for _, pt in pairs], dev),
        ))
        eval_of = {(id(poly), pt): v for (poly, pt), v in zip(pairs, evals)}

        # low-degree equivalents r_j(X) per commitment (host, <= set-size coeffs)
        extended_sets = []
        for points, comms in rotation_sets:
            exts = []
            for poly in comms:
                evs = [eval_of[(id(poly), pt)] for pt in points]
                exts.append((poly, arith.lagrange_interpolate(spec, points, evs)))
            extended_sets.append((points, exts))

        v = transcript.squeeze_challenge()

        # h(X) = sum_i v^i * [sum_j y^j (P_ij - R_ij)] / Z_i(X)
        h_x = None
        power_v = 1
        for points, exts in extended_sets:
            n_x = None
            power_y = 1
            for poly, r_coeffs in exts:
                vals = poly.values
                # subtract the low-degree equivalent from the leading coefficients
                head = limb.fsub(spec, vals[:, : len(r_coeffs)], limb.from_ints(spec, r_coeffs, dev))
                num = torch.cat([head, vals[:, len(r_coeffs) :]], dim=1)
                term = limb.fmul(spec, num, scalar(power_y))
                n_x = term if n_x is None else limb.fadd(spec, n_x, term)
                power_y = power_y * y % p
            q_i = n_x
            for pt in points:
                q_i = arith.kate_division(spec, q_i, pt)
            term = limb.fmul(spec, q_i, scalar(power_v))
            h_x = term if h_x is None else limb.fadd(spec, h_x, term)
            power_v = power_v * v % p

        transcript.write_point(to_affine_ints(params.curve, params.commit(Poly(h_x, COEFF)))[0])

    u = transcript.squeeze_challenge()

    with profiling.phase(L_PHASE):
        # linearization l(X) = sum_i v^i z_i [sum_j y^j (P_ij - r_ij(u))] - Z_T(u) h(X)
        l_x = None
        power_v = 1
        z_diffs = []
        for points, exts in extended_sets:
            z_i = _eval_vanishing([pt for pt in super_point_set if pt not in points], u, p)
            z_diffs.append(z_i)
            inner = None
            power_y = 1
            for poly, r_coeffs in exts:
                r_eval = 0
                for c in reversed(r_coeffs):
                    r_eval = (r_eval * u + c) % p
                # P(X) - r_eval: subtract from the constant coefficient
                const = limb.fsub(spec, poly.values[:, :1], scalar(r_eval))
                contrib = torch.cat([const, poly.values[:, 1:]], dim=1)
                term = limb.fmul(spec, contrib, scalar(power_y))
                inner = term if inner is None else limb.fadd(spec, inner, term)
                power_y = power_y * y % p
            term = limb.fmul(spec, inner, scalar(z_i * power_v % p))
            l_x = term if l_x is None else limb.fadd(spec, l_x, term)
            power_v = power_v * v % p

        zt_eval = _eval_vanishing(super_point_set, u, p)
        l_x = limb.fsub(spec, l_x, limb.fmul(spec, h_x, scalar(zt_eval)))

        h2 = arith.kate_division(spec, l_x, u)
        h2 = limb.fmul(spec, h2, scalar(pow(z_diffs[0], -1, p)))
        transcript.write_point(to_affine_ints(params.curve, params.commit(Poly(h2, COEFF)))[0])


# ---------------------------------------------------------------------------
# verifier (shplonk/verifier.rs:52-150)
# ---------------------------------------------------------------------------


def shplonk_verify_proof(params, transcript, queries, msm_accumulator: DualMSM):
    curve = params.curve
    spec = curve.scalar
    p = spec.p

    # commitments carry evals on the verifier side: (commitment, point) ->
    # eval, first query wins
    eval_map: Dict[Tuple[int, int], int] = {}
    for q in queries:
        eval_map.setdefault((id(q.commitment), q.point), q.eval)

    rotation_sets, super_point_set = construct_intermediate_sets(
        queries, lambda q: q.commitment, lambda q: q.point
    )

    y = transcript.squeeze_challenge()
    v = transcript.squeeze_challenge()
    h1 = transcript.read_point()
    u = transcript.squeeze_challenge()
    h2 = transcript.read_point()

    z_0_diff_inverse = 0
    z_0 = 0
    outer_msm = HostMSM(curve)
    r_outer_acc = 0
    power_v = 1
    for i, (points, comms) in enumerate(rotation_sets):
        z_diff_i = _eval_vanishing([pt for pt in super_point_set if pt not in points], u, p)
        if i == 0:
            z_0 = _eval_vanishing(points, u, p)
            z_0_diff_inverse = pow(z_diff_i, -1, p)
            z_diff_i = 1
        else:
            z_diff_i = z_diff_i * z_0_diff_inverse % p

        inner_msm = HostMSM(curve)
        r_inner_acc = 0
        power_y = 1
        for commitment in comms:
            evals = [eval_map[(id(commitment), pt)] for pt in points]
            r_eval = 0
            for c in reversed(arith.lagrange_interpolate(spec, points, evals)):
                r_eval = (r_eval * u + c) % p
            r_inner_acc = (r_inner_acc + power_y * r_eval) % p
            if isinstance(commitment, HostMSM):
                m = HostMSM(curve)
                m.terms = list(commitment.terms)
                m.scale(power_y)
                inner_msm.add_msm(m)
            else:
                inner_msm.append_term(power_y, commitment)
            power_y = power_y * y % p
        inner_msm.scale(power_v * z_diff_i % p)
        outer_msm.add_msm(inner_msm)
        r_outer_acc = (r_outer_acc + power_v * r_inner_acc % p * z_diff_i) % p
        power_v = power_v * v % p

    g0 = (curve.gx, curve.gy)
    outer_msm.append_term((-r_outer_acc) % p, g0)
    outer_msm.append_term((-z_0) % p, h1)
    outer_msm.append_term(u, h2)

    msm_accumulator.left.append_term(1, h2)
    msm_accumulator.right.add_msm(outer_msm)
    return msm_accumulator
