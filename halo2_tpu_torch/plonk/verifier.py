"""verify_proof — host-side proof verification.

Port of the JAX package's ``plonk/verifier.py`` (the reference
plonk/verifier.rs).  All scalar work is host Python ints; the final check is
the commitment scheme's: the KZG two-channel pairing MSM or the IPA MSM,
decided through a strategy (kzg/strategy.rs, ipa/strategy.rs).
"""

from __future__ import annotations

from typing import List

from ..curves.point import to_affine_ints
from ..fields import limb
from ..plonk.error import InstanceTooLarge, InvalidInstances
from ..poly.multiopen_gwc import DualMSM, VerifierQuery
from ..poly.polynomial import LAGRANGE, Poly, Rotation
from .keygen import VerifyingKey


class KZGSingleStrategy:
    """kzg/strategy.rs SingleStrategy: run the multiopen verifier on a fresh
    DualMSM and decide at once through the pairing check."""

    def __init__(self, params):
        self.params = params

    def process(self, f) -> bool:
        return f(DualMSM(self.params)).check()


class KZGAccumulatorStrategy:
    """kzg/strategy.rs AccumulatorStrategy: accumulate many proofs into one
    DualMSM with random scaling; one pairing check at ``finalize()``."""

    def __init__(self, params, rng):
        self.params = params
        self.rng = rng
        self.msm = DualMSM(params)

    def process(self, f) -> "KZGAccumulatorStrategy":
        self.msm.scale(self.rng())
        self.msm = f(self.msm)
        return self

    def finalize(self) -> bool:
        return self.msm.check()


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


def _instance_commitments(params, cs, domain, instances):
    """Each instance column committed with Blind::default() = 1 (the IPA
    scheme, verifier.rs:48-91): every column of every proof in one batched
    MSM."""
    spec = domain.spec
    n = domain.n
    usable = n - (cs.blinding_factors() + 1)
    polys = []
    for inst in instances:
        for col in inst:
            if len(col) > usable:
                raise InstanceTooLarge()
            padded = [v % spec.p for v in col] + [0] * (n - len(col))
            polys.append(Poly(limb.from_ints(spec, padded, params.device), LAGRANGE))
    flat = (
        to_affine_ints(params.curve, params.commit_lagrange_many(polys, [1] * len(polys)))
        if polys else []
    )
    out = []
    for inst in instances:
        out.append(flat[: len(inst)])
        flat = flat[len(inst):]
    return out


def verify_proof(params, vk: VerifyingKey, instances, transcript, multiopen_verify,
                 query_instance: bool = False, strategy=None):
    """instances: list (per proof) of list (per instance column) of int lists.

    ``multiopen_verify(params, transcript, queries, msm)`` returns the
    scheme's guard.  ``query_instance`` selects the scheme's instance
    handling (verifier.rs:48-91,170-215): False (KZG) hashes the values as
    common scalars and recomputes their evaluations barycentrically; True
    (IPA) commits the instance columns, hashes the commitments and reads the
    evaluations from the proof.  ``strategy`` has ``process(f)``: for KZG
    ``f`` takes a DualMSM, for IPA an MSMIPA; the default is
    :class:`KZGSingleStrategy`.  Returns what the strategy returns (True iff
    the proof verifies, for the single strategies).
    """
    cs = vk.cs
    domain = vk.domain
    spec = domain.spec
    p = spec.p
    n = domain.n

    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise InvalidInstances()
    num_proofs = len(instances)

    instance_commitments = (
        _instance_commitments(params, cs, domain, instances) if query_instance else None
    )

    vk.hash_into(transcript)

    if query_instance:
        for comms in instance_commitments:
            for commitment in comms:
                transcript.common_point(commitment)
    else:
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

    theta = transcript.squeeze_challenge()

    lookups_permuted = [
        [
            {
                "permuted_input_commitment": transcript.read_point(),
                "permuted_table_commitment": transcript.read_point(),
            }
            for _ in cs.lookups
        ]
        for _ in range(num_proofs)
    ]

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

    lookups_committed = [
        [{**lk, "product_commitment": transcript.read_point()} for lk in lookups_permuted[pr]]
        for pr in range(num_proofs)
    ]

    random_poly_commitment = transcript.read_point()
    y = transcript.squeeze_challenge()
    h_commitments = [transcript.read_point() for _ in range(domain.get_quotient_poly_degree())]

    x = transcript.squeeze_challenge()
    xn = pow(x, n, p)

    if query_instance:
        # instance evals are read from the proof (verifier.rs:170-176)
        instance_evals = [
            [transcript.read_scalar() for _ in cs.instance_queries] for _ in range(num_proofs)
        ]
    else:
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

    lookups_evaluated = [
        [
            {
                **lk,
                "product_eval": transcript.read_scalar(),
                "product_next_eval": transcript.read_scalar(),
                "permuted_input_eval": transcript.read_scalar(),
                "permuted_input_inv_eval": transcript.read_scalar(),
                "permuted_table_eval": transcript.read_scalar(),
            }
            for lk in lookups_committed[pr]
        ]
        for pr in range(num_proofs)
    ]

    # ---- recompute expected h(x) (verifier.rs:244-324) ----------------------
    l_evals = domain.l_i_range(x, xn, range(-(bf + 1), 1))
    assert len(l_evals) == 2 + bf
    l_last = l_evals[0]
    l_blind = sum(l_evals[1 : 1 + bf]) % p
    l_0 = l_evals[1 + bf]
    active = (1 - (l_last + l_blind)) % p

    expressions: List[int] = []
    for pr in range(num_proofs):
        a_evals = advice_evals[pr]
        i_evals = instance_evals[pr]

        def evaluate(expr):
            return _eval_expression(expr, p, fixed_evals, a_evals, i_evals, challenges)

        # gates
        for gate in cs.gates:
            for poly in gate.polynomials():
                expressions.append(evaluate(poly))
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
        # lookup expressions (lookup/verifier.rs:93-168)
        for lk, arg in zip(lookups_evaluated[pr], cs.lookups):

            def compress(exprs):
                acc = 0
                for e in exprs:
                    acc = (acc * theta + evaluate(e)) % p
                return acc

            z, z_next = lk["product_eval"], lk["product_next_eval"]
            a_x, a_prev = lk["permuted_input_eval"], lk["permuted_input_inv_eval"]
            s_x = lk["permuted_table_eval"]
            expressions.append(l_0 * (1 - z) % p)
            expressions.append(l_last * (z * z - z) % p)
            left = z_next * (a_x + beta) % p * (s_x + gamma) % p
            right = (
                z * (compress(arg.input_expressions) + beta) % p
                * (compress(arg.table_expressions) + gamma) % p
            )
            expressions.append((left - right) * active % p)
            expressions.append(l_0 * (a_x - s_x) % p)
            expressions.append((a_x - s_x) * (a_x - a_prev) % p * active % p)

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
    x_inv = domain.rotate_omega(x, Rotation.prev())

    queries: List[VerifierQuery] = []
    for pr in range(num_proofs):
        if query_instance:
            for qidx, (column, at) in enumerate(cs.instance_queries):
                queries.append(
                    VerifierQuery(
                        instance_commitments[pr][column.index],
                        domain.rotate_omega(x, at),
                        instance_evals[pr][qidx],
                    )
                )
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
        for lk in lookups_evaluated[pr]:
            queries.append(VerifierQuery(lk["product_commitment"], x, lk["product_eval"]))
            queries.append(
                VerifierQuery(lk["permuted_input_commitment"], x, lk["permuted_input_eval"])
            )
            queries.append(
                VerifierQuery(lk["permuted_table_commitment"], x, lk["permuted_table_eval"])
            )
            queries.append(
                VerifierQuery(
                    lk["permuted_input_commitment"], x_inv, lk["permuted_input_inv_eval"]
                )
            )
            queries.append(
                VerifierQuery(lk["product_commitment"], x_next, lk["product_next_eval"])
            )
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

    if strategy is None:
        strategy = KZGSingleStrategy(params)
    return strategy.process(lambda msm: multiopen_verify(params, transcript, queries, msm))
