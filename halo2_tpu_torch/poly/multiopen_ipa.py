"""IPA multiopen: collapse same-point-set openings with x1..x4 challenges.

Port of the JAX package's ``poly/multiopen_ipa.py`` (the reference
poly/ipa/multiopen/{prover,verifier}.rs): queries are grouped per commitment
into point-index sets (``construct_intermediate_sets``, multiopen.rs:67-180),
the q polys of a set are collapsed with x1, the multi-point quotient q' is
built with kate divisions and x2, opened at x3 by the k-round folding
argument of ``poly/ipa.py``, with x4 collapsing the remaining openings.

Commitment identity is Python object identity (the reference's pointer
equality, poly/query.rs); points are indexed in first-occurrence order and
the point-index sets ordered by their sorted index tuples (BTreeMap of
BTreeSet).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..curves.point import to_affine_ints
from ..fields import limb
from ..fields.spec import NLIMBS
from ..ops import arith
from .ipa import MSMIPA, GuardIPA, ParamsIPA, ipa_commit_create_proof, ipa_commit_verify_proof
from .polynomial import COEFF, Poly


def construct_intermediate_sets(queries, get_commitment, get_point, get_eval):
    """Returns (commitment_data, point_sets).

    commitment_data: list of dicts {commitment, set_index, evals} in
    first-occurrence order; point_sets: list of point lists, indexed by
    set_index, each sorted by first-occurrence point index (a BTreeSet of
    indices), the sets in the order their index tuples first occur
    (multiopen.rs:113-121, ``BTreeMap::entry(..).or_insert(num_sets)``).
    """
    point_index: Dict[int, int] = {}
    commitments: List[dict] = []
    by_key: Dict[int, dict] = {}
    for q in queries:
        pt = get_point(q)
        if pt not in point_index:
            point_index[pt] = len(point_index)
        key = id(get_commitment(q))
        if key not in by_key:
            entry = {"commitment": get_commitment(q), "point_indices": [], "queries": []}
            by_key[key] = entry
            commitments.append(entry)
        by_key[key]["point_indices"].append(point_index[pt])
        by_key[key]["queries"].append(q)

    idx_sets: List[Tuple[int, ...]] = []
    for entry in commitments:
        s = tuple(sorted(set(entry["point_indices"])))
        if s not in idx_sets:
            idx_sets.append(s)
    set_of = {s: i for i, s in enumerate(idx_sets)}

    inverse_point = {v: k for k, v in point_index.items()}
    point_sets = [[inverse_point[i] for i in s] for s in idx_sets]

    for entry in commitments:
        s = tuple(sorted(set(entry["point_indices"])))
        entry["set_index"] = set_of[s]
        evals = [0] * len(s)
        for q in entry["queries"]:
            evals[s.index(point_index[get_point(q)])] = get_eval(q)
        entry["evals"] = evals

    return commitments, point_sets


# ---------------------------------------------------------------------------
# prover (ipa/multiopen/prover.rs:32-123)
# ---------------------------------------------------------------------------


def ipa_create_proof(params: ParamsIPA, rng, transcript, queries):
    fr = params.curve.scalar
    p = fr.p
    dev = params.device

    def scalar(value: int):
        return limb.from_int(fr, value, dev).reshape(NLIMBS, 1)

    x_1 = transcript.squeeze_challenge()
    x_2 = transcript.squeeze_challenge()

    # prover queries carry .poly and .blind
    commitment_data, point_sets = construct_intermediate_sets(
        queries, lambda q: q.poly, lambda q: q.point, lambda q: None
    )

    q_polys = [None] * len(point_sets)
    q_blinds = [0] * len(point_sets)
    for entry in commitment_data:
        idx = entry["set_index"]
        vals = entry["commitment"].values
        if q_polys[idx] is None:
            q_polys[idx] = vals
        else:
            q_polys[idx] = limb.fadd(fr, limb.fmul(fr, q_polys[idx], scalar(x_1)), vals)
        q_blinds[idx] = (q_blinds[idx] * x_1 + entry["queries"][0].blind) % p

    q_prime = None
    for points, poly in zip(point_sets, q_polys):
        quotient = poly
        for pt in points:
            quotient = arith.kate_division(fr, quotient, pt)
        q_prime = quotient if q_prime is None else limb.fadd(
            fr, limb.fmul(fr, q_prime, scalar(x_2)), quotient
        )

    q_prime_blind = rng()
    q_prime_commit = params.commit(Poly(q_prime, COEFF), q_prime_blind)
    transcript.write_point(to_affine_ints(params.curve, q_prime_commit)[0])

    x_3 = transcript.squeeze_challenge()

    for poly in q_polys:
        transcript.write_scalar(limb.to_ints(fr, arith.eval_polynomial(fr, poly, x_3))[0])

    x_4 = transcript.squeeze_challenge()

    p_poly = q_prime
    p_blind = q_prime_blind
    for poly, blind in zip(q_polys, q_blinds):
        p_poly = limb.fadd(fr, limb.fmul(fr, p_poly, scalar(x_4)), poly)
        p_blind = (p_blind * x_4 + blind) % p

    ipa_commit_create_proof(params, rng, transcript, Poly(p_poly, COEFF), p_blind, x_3)


# ---------------------------------------------------------------------------
# verifier (ipa/multiopen/verifier.rs:39-148)
# ---------------------------------------------------------------------------


def ipa_verify_proof(params: ParamsIPA, transcript, queries, msm: MSMIPA) -> GuardIPA:
    fr = params.curve.scalar
    p = fr.p

    x_1 = transcript.squeeze_challenge()
    x_2 = transcript.squeeze_challenge()

    commitment_data, point_sets = construct_intermediate_sets(
        queries, lambda q: q.commitment, lambda q: q.point, lambda q: q.eval
    )

    q_commitments = [params.empty_msm() for _ in point_sets]
    q_eval_sets = [[0] * len(ps) for ps in point_sets]
    for entry in commitment_data:
        idx = entry["set_index"]
        q_commitments[idx].scale(x_1)
        commitment = entry["commitment"]
        if isinstance(commitment, MSMIPA):
            q_commitments[idx].add_msm(commitment)
        else:
            q_commitments[idx].append_term(1, commitment)
        for i, ev in enumerate(entry["evals"]):
            q_eval_sets[idx][i] = (q_eval_sets[idx][i] * x_1 + ev) % p

    q_prime_commitment = transcript.read_point()
    x_3 = transcript.squeeze_challenge()

    u = [transcript.read_scalar() for _ in q_eval_sets]

    msm_eval = 0
    for points, evals, proof_eval in zip(point_sets, q_eval_sets, u):
        r_eval = 0
        for c in reversed(arith.lagrange_interpolate(fr, points, evals)):
            r_eval = (r_eval * x_3 + c) % p
        ev = (proof_eval - r_eval) % p
        for pt in points:
            ev = ev * pow((x_3 - pt) % p, -1, p) % p
        msm_eval = (msm_eval * x_2 + ev) % p

    x_4 = transcript.squeeze_challenge()

    msm.append_term(1, q_prime_commitment)
    v = msm_eval
    for q_commitment, q_eval in zip(q_commitments, u):
        msm.scale(x_4)
        msm.add_msm(q_commitment)
        v = (v * x_4 + q_eval) % p

    return ipa_commit_verify_proof(params, msm, transcript, x_3, v)
