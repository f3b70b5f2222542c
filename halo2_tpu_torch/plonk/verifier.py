"""verify_proof — host-side proof verification.

Port of the JAX package's ``plonk/verifier.py`` (the reference
plonk/verifier.rs).  All scalar work is host Python ints; the final check is
the KZG two-channel pairing MSM.  Like the prover, this slice verifies
circuits without lookups or shuffles (ROADMAP §1).
"""

from __future__ import annotations

from typing import List

from ..plonk.error import InvalidInstances
from ..poly.multiopen_gwc import DualMSM, VerifierQuery
from ..poly.polynomial import Rotation
from .keygen import VerifyingKey


def _eval_expression(expr, p, fixed_evals, advice_evals, instance_evals, challenges):
    return expr.evaluate(
        lambda scalar: scalar % p,
        lambda _: (_ for _ in ()).throw(
            ValueError("virtual selectors are removed during optimization")
        ),
        lambda q: fixed_evals[q.index],
        lambda q: advice_evals[q.index],
        lambda q: instance_evals[q.index],
        lambda c: challenges[c.index],
        lambda a: (-a) % p,
        lambda a, b: (a + b) % p,
        lambda a, b: (a * b) % p,
        lambda a, s: (a * s) % p,
    )


def verify_proof(params, vk: VerifyingKey, instances, transcript, multiopen_verify) -> bool:
    """instances: list (per proof) of list (per instance column) of int lists.

    ``multiopen_verify(params, transcript, queries, msm)`` returns the
    scheme's guard (``poly.multiopen_gwc.gwc_verify_proof``); the proof
    verifies iff the guard's pairing check holds (the reference's KZG
    SingleStrategy).  Instance values are hashed as common scalars and their
    evaluations recomputed barycentrically (verifier.rs:177-215).
    """
    cs = vk.cs
    domain = vk.domain
    spec = domain.spec
    p = spec.p
    n = domain.n
    if cs.lookups:
        raise NotImplementedError("lookups and shuffles are not ported yet (ROADMAP §1)")

    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise InvalidInstances()
    num_proofs = len(instances)

    vk.hash_into(transcript)
    for inst in instances:
        for col in inst:
            for value in col:
                transcript.common_scalar(value % p)

    # advice commitments + phase challenges
    advice_commitments = [[None] * cs.num_advice_columns for _ in range(num_proofs)]
    challenges = [0] * cs.num_challenges
    for phase in cs.phases():
        for pr in range(num_proofs):
            for col_idx, col_phase in enumerate(cs.advice_column_phase):
                if col_phase == phase:
                    advice_commitments[pr][col_idx] = transcript.read_point()
        for idx, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                challenges[idx] = transcript.squeeze_challenge()

    transcript.squeeze_challenge()  # theta (lookups; none in this slice)

    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    bf = cs.blinding_factors()
    chunk_len = cs.degree() - 2
    num_perm_sets = (
        (len(cs.permutation.columns) + chunk_len - 1) // chunk_len
        if cs.permutation.columns
        else 0
    )
    permutations_committed = [
        [transcript.read_point() for _ in range(num_perm_sets)]
        for _ in range(num_proofs)
    ]

    random_poly_commitment = transcript.read_point()
    y = transcript.squeeze_challenge()
    h_commitments = [transcript.read_point() for _ in range(domain.get_quotient_poly_degree())]

    x = transcript.squeeze_challenge()
    xn = pow(x, n, p)

    # barycentric inner product (verifier.rs:177-215)
    min_rot, max_rot = 0, 0
    for _, rot in cs.instance_queries:
        min_rot = min(min_rot, rot.i)
        max_rot = max(max_rot, rot.i)
    max_instance_len = max((len(col) for inst in instances for col in inst), default=0)
    l_i_s = domain.l_i_range(x, xn, range(-max_rot, max_instance_len + abs(min_rot)))
    instance_evals = []
    for inst in instances:
        evals = []
        for column, rot in cs.instance_queries:
            col = inst[column.index]
            offset = max_rot - rot.i
            acc = 0
            for v, li in zip(col, l_i_s[offset : offset + len(col)]):
                acc = (acc + v * li) % p
            evals.append(acc)
        instance_evals.append(evals)

    advice_evals = [
        [transcript.read_scalar() for _ in cs.advice_queries] for _ in range(num_proofs)
    ]
    fixed_evals = [transcript.read_scalar() for _ in cs.fixed_queries]
    random_eval = transcript.read_scalar()
    permutations_common = [transcript.read_scalar() for _ in vk.permutation_commitments]

    permutations_evaluated = []
    for pr in range(num_proofs):
        sets = []
        for set_idx in range(num_perm_sets):
            ev = {
                "commitment": permutations_committed[pr][set_idx],
                "eval": transcript.read_scalar(),
                "next_eval": transcript.read_scalar(),
                "last_eval": None,
            }
            if set_idx < num_perm_sets - 1:
                ev["last_eval"] = transcript.read_scalar()
            sets.append(ev)
        permutations_evaluated.append(sets)

    # ---- recompute expected h(x) (verifier.rs:244-324) ----------------------
    l_evals = domain.l_i_range(x, xn, range(-(bf + 1), 1))
    assert len(l_evals) == 2 + bf
    l_last = l_evals[0]
    l_blind = sum(l_evals[1 : 1 + bf]) % p
    l_0 = l_evals[1 + bf]

    expressions: List[int] = []
    for pr in range(num_proofs):
        a_evals = advice_evals[pr]
        i_evals = instance_evals[pr]
        # gates
        for gate in cs.gates:
            for poly in gate.polynomials():
                expressions.append(
                    _eval_expression(poly, p, fixed_evals, a_evals, i_evals, challenges)
                )
        # permutation expressions (permutation/verifier.rs:102-201)
        sets = permutations_evaluated[pr]
        if sets:
            expressions.append(l_0 * (1 - sets[0]["eval"]) % p)
            last = sets[-1]["eval"]
            expressions.append((last * last - last) % p * l_last % p)
            for set_idx in range(1, len(sets)):
                expressions.append(
                    (sets[set_idx]["eval"] - sets[set_idx - 1]["last_eval"]) % p * l_0 % p
                )
            active = (1 - (l_last + l_blind)) % p
            for chunk_index, pset in enumerate(sets):
                cols = cs.permutation.columns[
                    chunk_index * chunk_len : (chunk_index + 1) * chunk_len
                ]
                perm_evals = permutations_common[
                    chunk_index * chunk_len : (chunk_index + 1) * chunk_len
                ]
                left = pset["next_eval"]
                for column, sigma_eval in zip(cols, perm_evals):
                    qidx = cs.get_any_query_index(column, Rotation.cur())
                    ev = {"advice": a_evals, "fixed": fixed_evals, "instance": i_evals}[
                        column.kind
                    ][qidx]
                    left = left * (ev + beta * sigma_eval + gamma) % p
                right = pset["eval"]
                current_delta = beta * x % p * pow(spec.delta, chunk_index * chunk_len, p) % p
                for column in cols:
                    qidx = cs.get_any_query_index(column, Rotation.cur())
                    ev = {"advice": a_evals, "fixed": fixed_evals, "instance": i_evals}[
                        column.kind
                    ][qidx]
                    right = right * (ev + current_delta + gamma) % p
                    current_delta = current_delta * spec.delta % p
                expressions.append((left - right) * active % p)

    expected_h_eval = 0
    for v in expressions:
        expected_h_eval = (expected_h_eval * y + v) % p
    expected_h_eval = expected_h_eval * pow(xn - 1, -1, p) % p

    # folded h commitment as an MSM (vanishing/verifier.rs:90-107)
    h_msm = params.empty_msm()
    for commitment in reversed(h_commitments):
        h_msm.scale(xn)
        h_msm.append_term(1, commitment)

    # ---- verifier queries (verifier.rs:326-388) -----------------------------
    x_next = domain.rotate_omega(x, Rotation.next())
    x_last = domain.rotate_omega(x, Rotation(-(bf + 1)))

    queries: List[VerifierQuery] = []
    for pr in range(num_proofs):
        for qidx, (column, at) in enumerate(cs.advice_queries):
            queries.append(
                VerifierQuery(
                    advice_commitments[pr][column.index],
                    domain.rotate_omega(x, at),
                    advice_evals[pr][qidx],
                )
            )
        for pset in permutations_evaluated[pr]:
            queries.append(VerifierQuery(pset["commitment"], x, pset["eval"]))
            queries.append(VerifierQuery(pset["commitment"], x_next, pset["next_eval"]))
        for pset in list(reversed(permutations_evaluated[pr]))[1:]:
            queries.append(VerifierQuery(pset["commitment"], x_last, pset["last_eval"]))
    for qidx, (column, at) in enumerate(cs.fixed_queries):
        queries.append(
            VerifierQuery(
                vk.fixed_commitments[column.index],
                domain.rotate_omega(x, at),
                fixed_evals[qidx],
            )
        )
    for commitment, ev in zip(vk.permutation_commitments, permutations_common):
        queries.append(VerifierQuery(commitment, x, ev))
    queries.append(VerifierQuery(h_msm, x, expected_h_eval))
    queries.append(VerifierQuery(random_poly_commitment, x, random_eval))

    guard = multiopen_verify(params, transcript, queries, DualMSM(params))
    return guard.check()
