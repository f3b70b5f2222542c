"""create_proof — the prover orchestrator.

Port of the JAX package's ``plonk/prover.py`` (the reference
plonk/prover.rs).  The transcript interaction order below IS the proof
format and mirrors the reference exactly.  Device work: witness
materialization, MSM commitments, NTTs, the grand-product scan and the
quotient evaluation.  Host work: transcript hashing and challenges.

This slice of the port proves circuits without lookups or shuffles; one that
has them raises ``NotImplementedError`` (ROADMAP §1).  Commitments that the
transcript writes back to back (the advice columns of a phase, the
permutation products, the quotient pieces) go through one batched MSM each;
the randomness is drawn in the reference's order, so the bytes are unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from ..circuit.layouter import Assignment
from ..circuit.value import Value, to_assigned
from ..curves.point import to_affine_ints
from ..fields import limb
from ..fields.spec import NLIMBS, FieldSpec
from ..ops import arith
from ..plonk.error import InstanceTooLarge, NotEnoughRowsAvailable
from ..poly.domain import EvaluationDomain
from ..poly.polynomial import COEFF, LAGRANGE, Poly, Rotation
from ..utils import profiling
from .circuit import ConstraintSystem
from .keygen import ProvingKey, batch_invert_assigned


# ---------------------------------------------------------------------------
# witness collection (prover.rs:150-280)
# ---------------------------------------------------------------------------


class WitnessCollection(Assignment):
    def __init__(self, k, cs: ConstraintSystem, current_phase, instances, challenges, usable_rows):
        self.k = k
        self.cs = cs
        self.current_phase = current_phase
        self.advice = [dict() for _ in range(cs.num_advice_columns)]
        self.instances = instances  # list of lists of ints
        self.challenges = challenges  # dict index -> int
        self.usable_rows = usable_rows

    def query_instance(self, column, row):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        col = self.instances[column.index]
        return Value.known(col[row]) if row < len(col) else Value.known(0)

    def assign_advice(self, column, row, to):
        # ignore assignments for columns in a different phase
        if self.cs.advice_column_phase[column.index] != self.current_phase:
            return None
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        v = to()
        if not v.is_none():
            self.advice[column.index][row] = to_assigned(v.value())
        return v

    def assign_fixed(self, column, row, to):
        pass

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    def enable_selector(self, selector, row):
        pass

    def get_challenge(self, challenge):
        if challenge.index in self.challenges:
            return Value.known(self.challenges[challenge.index])
        return Value.unknown()


@dataclasses.dataclass
class PermutationCommittedSet:
    product_poly: Poly  # coeff
    product_coset: torch.Tensor  # extended values
    product_blind: int


@dataclasses.dataclass
class PermutationCommitted:
    sets: List[PermutationCommittedSet]


@dataclasses.dataclass
class ProverQuery:
    point: int  # canonical host scalar
    poly: Poly  # coeff basis
    blind: int = 0


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def _prefix_product_with_start(spec: FieldSpec, mv, start):
    """z[0] = start, z[i] = start * prod_{r<i} mv[r]  (grand-product scan).

    The JAX package's ``associative_scan`` becomes a Hillis–Steele scan:
    log2(n) batched multiplies (K1 launches), not n.
    """
    prefix = limb.prefix_mul(spec, mv)  # inclusive products
    one = limb.from_int(spec, 1, mv.device).reshape(NLIMBS, 1)
    shifted = torch.cat([one, prefix[:, :-1]], dim=1)
    return limb.fmul(spec, shifted, start.reshape(NLIMBS, 1))


def _set_rows(values, start_row: int, replacement):
    """Replace values[:, start_row:] with replacement columns."""
    return torch.cat([values[:, :start_row], replacement], dim=1)


def _write_points(params, transcript, pts) -> None:
    for aff in to_affine_ints(params.curve, pts):
        transcript.write_point(aff)


# ---------------------------------------------------------------------------
# permutation commit (permutation/prover.rs:44-191)
# ---------------------------------------------------------------------------


@profiling.profiled("permutation: grand products + commits")
def _permutation_commit(
    params, pk: ProvingKey, advice_values, fixed_values, instance_values,
    beta: int, gamma: int, rng, transcript,
) -> PermutationCommitted:
    domain = pk.vk.domain
    spec = domain.spec
    cs = pk.vk.cs
    n = domain.n
    p = spec.p
    dev = domain.device
    cs_degree = cs.degree()
    assert cs_degree >= 3
    chunk_len = cs_degree - 2
    bf = cs.blinding_factors()
    columns = cs.permutation.columns

    omega_pows = domain._omega_pows_full  # (16, n) table of omega^i

    def col_values(column):
        return {"advice": advice_values, "fixed": fixed_values, "instance": instance_values}[
            column.kind
        ][column.index]

    gamma_b = limb.from_int(spec, gamma, dev).reshape(NLIMBS, 1)
    beta_b = limb.from_int(spec, beta, dev).reshape(NLIMBS, 1)

    zs, blinds = [], []
    last_z = limb.from_int(spec, 1, dev)
    col_counter = 0
    for chunk_start in range(0, len(columns), chunk_len):
        cols = columns[chunk_start : chunk_start + chunk_len]
        sigmas = pk.permutation.permutations[chunk_start : chunk_start + chunk_len]

        mv = None  # denominator: prod (value + beta*sigma + gamma)
        for column, sigma in zip(cols, sigmas):
            vals = col_values(column)
            term = limb.fadd(
                spec, limb.fadd(spec, vals, limb.fmul(spec, beta_b, sigma.values)), gamma_b
            )
            mv = term if mv is None else limb.fmul(spec, mv, term)
        mv = limb.finv(spec, mv)
        # numerator: prod (value + delta^j * beta * omega^i + gamma)
        for column in cols:
            vals = col_values(column)
            scalar = pow(spec.delta, col_counter, p) * beta % p
            deltaomega = limb.fmul(
                spec, omega_pows, limb.from_int(spec, scalar, dev).reshape(NLIMBS, 1)
            )
            term = limb.fadd(spec, limb.fadd(spec, vals, deltaomega), gamma_b)
            mv = limb.fmul(spec, mv, term)
            col_counter += 1

        z = _prefix_product_with_start(spec, mv, last_z)
        # blinding rows
        z = _set_rows(z, n - bf, limb.from_ints(spec, [rng() for _ in range(bf)], dev))
        last_z = z[:, n - (bf + 1)]
        zs.append(z)
        blinds.append(rng())  # commitment blind (KZG ignores the value)

    # the set commitments are written back to back: one batched MSM
    _write_points(params, transcript, params.commit_lagrange_many([Poly(z, LAGRANGE) for z in zs]))
    sets = []
    for z, z_blind in zip(zs, blinds):
        zc = domain.lagrange_to_coeff(Poly(z, LAGRANGE))
        coset = domain.coeff_to_extended(zc)
        sets.append(PermutationCommittedSet(zc, coset.values, z_blind))
    return PermutationCommitted(sets)


# ---------------------------------------------------------------------------
# main prover
# ---------------------------------------------------------------------------


def create_proof(params, pk: ProvingKey, circuits, instances, rng, transcript, multiopen):
    """instances: list (per circuit) of list (per instance column) of int lists.

    ``multiopen`` is a callable (params, rng, transcript, queries) -> None
    (``poly.multiopen_gwc.gwc_create_proof``).  Instance values are hashed
    into the transcript as common scalars (the KZG scheme, prover.rs:79-132).
    """
    domain: EvaluationDomain = pk.vk.domain
    spec = domain.spec
    cs = pk.vk.cs
    n = domain.n
    p = spec.p
    dev = params.device
    if cs.lookups:  # the frontend has no shuffle argument to check for
        raise NotImplementedError("lookups and shuffles are not ported yet (ROADMAP §1)")

    pk.vk.hash_into(transcript)

    bf = cs.blinding_factors()
    usable = n - (bf + 1)

    # --- instances (prover.rs:79-132) --------------------------------------
    instance_singles = []
    for inst in instances:
        values, polys = [], []
        for col_values in inst:
            if len(col_values) > usable:
                raise InstanceTooLarge()
            for v in col_values:
                transcript.common_scalar(v % p)
            padded = list(col_values) + [0] * (n - len(col_values))
            lagr = Poly(limb.from_ints(spec, padded, dev), LAGRANGE)
            values.append(lagr.values)
            polys.append(domain.lagrange_to_coeff(lagr))
        instance_singles.append({"values": values, "polys": polys})

    # --- phase loop: witness synthesis + advice commitments ----------------
    num_circuits = len(circuits)
    advice_values = [
        [limb.zeros((n,), dev) for _ in range(cs.num_advice_columns)]
        for _ in range(num_circuits)
    ]
    advice_blinds = [[1] * cs.num_advice_columns for _ in range(num_circuits)]
    challenges: Dict[int, int] = {}
    # the frontend circuit was configured against an un-optimized cs; re-run
    # configure to obtain a config bound to a fresh cs with virtual selectors
    cfg_cs = ConstraintSystem()
    config = type(circuits[0]).configure(cfg_cs)

    for phase in cs.phases():
        col_indices = [i for i, ph in enumerate(cs.advice_column_phase) if ph == phase]
        for c_idx, circuit in enumerate(circuits):
            witness = WitnessCollection(params.k, cs, phase, instances[c_idx], challenges, usable)
            with profiling.phase("witness synthesis (host)"):
                circuit.floor_planner.synthesize(witness, circuit, config, list(cs.constants))
            with profiling.phase("advice: materialize + commit"):
                cols = batch_invert_assigned(
                    spec, [witness.advice[i] for i in col_indices], n, dev
                )
                for poly_idx, col_idx in enumerate(col_indices):
                    blind_rows = limb.from_ints(spec, [rng() for _ in range(bf + 1)], dev)
                    advice_values[c_idx][col_idx] = _set_rows(
                        cols[poly_idx].values, usable, blind_rows
                    )
                for col_idx in col_indices:
                    advice_blinds[c_idx][col_idx] = rng()
                if col_indices:
                    # all same-phase columns in ONE batched MSM
                    pts = params.commit_lagrange_many(
                        [Poly(advice_values[c_idx][i], LAGRANGE) for i in col_indices]
                    )
                    _write_points(params, transcript, pts)
        for index, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                challenges[index] = transcript.squeeze_challenge()

    challenges_dev = [limb.from_int(spec, challenges[i], dev) for i in range(cs.num_challenges)]

    # --- theta (squeezed for the lookups; none in this slice) --------------
    transcript.squeeze_challenge()

    # --- beta, gamma; permutation products ---------------------------------
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    fixed_values = [f.values for f in pk.fixed_values]
    permutations = [
        _permutation_commit(
            params, pk, advice_values[c_idx], fixed_values,
            instance_singles[c_idx]["values"], beta, gamma, rng, transcript,
        )
        for c_idx in range(num_circuits)
    ]

    # --- vanishing random poly --------------------------------------------
    random_poly = Poly(limb.from_ints(spec, [rng() for _ in range(n)], dev), COEFF)
    random_blind = rng()
    _write_points(params, transcript, params.commit(random_poly, random_blind))

    # --- y; h(X) -----------------------------------------------------------
    y = transcript.squeeze_challenge()

    with profiling.phase("advice: iNTT to coeff"):
        advice_polys = [
            [domain.lagrange_to_coeff(Poly(v, LAGRANGE)) for v in advice_values[c]]
            for c in range(num_circuits)
        ]
    instance_polys = [s["polys"] for s in instance_singles]

    with profiling.phase("quotient: evaluate_h"):
        h_poly = pk.ev.evaluate_h(
            pk,
            advice_polys,
            instance_polys,
            challenges_dev,
            limb.from_int(spec, y, dev),
            limb.from_int(spec, beta, dev),
            limb.from_int(spec, gamma, dev),
            permutations,
        )

    # --- vanishing construct (vanishing/prover.rs:68-120) -------------------
    with profiling.phase("vanishing: h divide/split/commit"):
        h_poly = domain.divide_by_vanishing_poly(h_poly)
        h_coeffs = domain.extended_to_coeff(h_poly)  # (16, n * quotient_degree)
        qd = domain.quotient_poly_degree
        h_pieces = [Poly(h_coeffs[:, i * n : (i + 1) * n], COEFF) for i in range(qd)]
        h_blinds = [rng() for _ in h_pieces]
        _write_points(params, transcript, params.commit_many(h_pieces, h_blinds))

    # --- x; evaluations -----------------------------------------------------
    x = transcript.squeeze_challenge()
    xn = pow(x, n, p)

    # All opening evaluations are collected first (every point derives from
    # x alone), computed in ONE batched pass, then written to the transcript
    # in collection order (the reference's order, prover.rs:521-575).
    eval_vals: List[torch.Tensor] = []
    eval_pts: List[int] = []

    def queue_eval(poly: Poly, point: int):
        eval_vals.append(poly.values)
        eval_pts.append(point)

    for c_idx in range(num_circuits):
        for column, at in cs.advice_queries:
            queue_eval(advice_polys[c_idx][column.index], domain.rotate_omega(x, at))

    for column, at in cs.fixed_queries:
        queue_eval(pk.fixed_polys[column.index], domain.rotate_omega(x, at))

    # vanishing.evaluate: fold h pieces by xn; random_eval queued at x
    xn_dev = limb.from_int(spec, xn, dev).reshape(NLIMBS, 1)
    h_folded = None
    for piece in reversed(h_pieces):
        if h_folded is None:
            h_folded = piece.values
        else:
            h_folded = limb.fadd(spec, limb.fmul(spec, h_folded, xn_dev), piece.values)
    h_poly_final = Poly(h_folded, COEFF)
    h_blind_final = 0
    for hb in reversed(h_blinds):
        h_blind_final = (h_blind_final * xn + hb) % p
    queue_eval(random_poly, x)

    # pk.permutation.evaluate: sigma evals
    for poly in pk.permutation.polys:
        queue_eval(poly, x)

    # permutations evaluate
    x_next = domain.rotate_omega(x, Rotation.next())
    x_last = domain.rotate_omega(x, Rotation(-(bf + 1)))
    for committed in permutations:
        for set_idx, pset in enumerate(committed.sets):
            queue_eval(pset.product_poly, x)
            queue_eval(pset.product_poly, x_next)
            if set_idx < len(committed.sets) - 1:
                queue_eval(pset.product_poly, x_last)

    with profiling.phase("evaluations at x (one batched pass)"):
        stacked = torch.stack(eval_vals, dim=1)  # (16, m, n)
        pts_mont = limb.from_ints(spec, eval_pts, dev)  # (16, m)
        out = arith.eval_polynomials_batched(spec, stacked, pts_mont)
        for v in limb.to_ints(spec, out):
            transcript.write_scalar(v)

    # --- assemble multiopen queries (prover.rs:599-645) ----------------------
    queries: List[ProverQuery] = []
    for c_idx in range(num_circuits):
        for column, at in cs.advice_queries:
            queries.append(
                ProverQuery(
                    domain.rotate_omega(x, at),
                    advice_polys[c_idx][column.index],
                    advice_blinds[c_idx][column.index],
                )
            )
        committed = permutations[c_idx]
        for pset in committed.sets:
            queries.append(ProverQuery(x, pset.product_poly, pset.product_blind))
            queries.append(ProverQuery(x_next, pset.product_poly, pset.product_blind))
        for pset in list(reversed(committed.sets))[1:]:
            queries.append(ProverQuery(x_last, pset.product_poly, pset.product_blind))
    for column, at in cs.fixed_queries:
        queries.append(ProverQuery(domain.rotate_omega(x, at), pk.fixed_polys[column.index], 1))
    for poly in pk.permutation.polys:
        queries.append(ProverQuery(x, poly, 1))
    queries.append(ProverQuery(x, h_poly_final, h_blind_final))
    queries.append(ProverQuery(x, random_poly, random_blind))

    with profiling.phase("multiopen"):
        multiopen(params, rng, transcript, queries)
    return transcript.finalize()
