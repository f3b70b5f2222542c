"""create_proof — the prover orchestrator.

Port of the JAX package's ``plonk/prover.py`` (the reference
plonk/prover.rs).  The transcript interaction order below IS the proof
format and mirrors the reference exactly.  Device work: witness
materialization, MSM commitments, NTTs, the lookup multiset matching, the
grand-product scan and the quotient evaluation.  Host work: transcript
hashing and challenges.

Commitments that the transcript writes back to back (the advice columns of a
phase, the lookups' permuted columns, the permutation and lookup products,
the quotient pieces, the instance columns) go through one batched MSM each;
the randomness is drawn in the reference's order, so the bytes are unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import torch

from ..circuit.layouter import Assignment
from ..circuit.value import Assigned, Value, to_assigned
from ..curves.point import to_affine_ints
from ..fields import limb
from ..fields.spec import NLIMBS, FieldSpec
from ..ops import arith
from ..ops import lookup as lookup_ops
from ..plonk.error import ConstraintSystemFailure, InstanceTooLarge, NotEnoughRowsAvailable
from ..poly.domain import EvaluationDomain
from ..poly.polynomial import COEFF, LAGRANGE, Poly, Rotation
from ..utils import profiling
from .circuit import ConstraintSystem
from .evaluation import compress_expressions, evaluate_on_lagrange
from .keygen import ProvingKey, batch_invert_assigned


# ---------------------------------------------------------------------------
# witness collection (prover.rs:150-280)
# ---------------------------------------------------------------------------


class WitnessCollection(Assignment):
    """The prover's witness: the advice values of the current phase, as the
    circuit gave them (``int`` or ``Assigned``), in ``advice``, one dict a
    column from row to value, which ``create_proof`` reads.  It owns that
    store: every value reaches it through ``store_advice``, which checks the
    rows and the values.  It keeps no layout, so ``SimpleFloorPlanner``
    makes one ``store_advice`` call a region and no other; the other methods
    serve ``V1FloorPlanner``, which makes every call."""

    keeps_layout = False

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

    def evaluates_advice(self, column):
        return self.cs.advice_column_phase[column.index] == self.current_phase

    def evaluates_fixed(self, column):
        return False

    def store_advice(self, region_start, region_end, records):
        if region_end > self.usable_rows:
            for _, offset, _ in records:
                if region_start + offset >= self.usable_rows:
                    raise NotEnoughRowsAvailable(self.k)
        advice = self.advice
        for index, offset, v in records:
            if v is not None:
                if v.__class__ is not int and v.__class__ is not Assigned:
                    to_assigned(v)  # the TypeError of a value that is neither
                advice[index][region_start + offset] = v

    def assign_advice(self, column, row, to):
        # ignore assignments for columns in a different phase
        if not self.evaluates_advice(column):
            return None
        value = to()
        self.store_advice(row, row + 1, ((column.index, 0, value.value()),))
        return value

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
class LookupCommitted:
    permuted_input_poly: Poly
    permuted_input_blind: int
    permuted_table_poly: Poly
    permuted_table_blind: int
    product_poly: Poly
    product_blind: int


@dataclasses.dataclass
class ProverQuery:
    point: int  # canonical host scalar
    poly: Poly  # coeff basis
    blind: int = 0


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def _sanity_checks_enabled() -> bool:
    """In-prover well-formedness asserts, the analog of the reference's
    `sanity-checks` cargo feature (lookup/prover.rs:252-288,
    permutation/prover.rs).  Off by default: each forces a device-to-host
    copy."""
    return os.environ.get("HALO2_TPU_SANITY_CHECKS") == "1"


def _assert_product_telescopes(spec: FieldSpec, z, u: int, what: str):
    """z[0] = 1 and z[u] = 1 — the grand product telescopes back to one.
    A z[u] != 1 here means soundness is already broken upstream."""
    z0, zu = limb.to_ints(spec, z[:, [0, u]])
    assert z0 == 1, f"{what}: z[0] = {z0} != 1"
    assert zu == 1, f"{what}: z[u] = {zu} != 1 (soundness broken)"


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
    if _sanity_checks_enabled() and zs:
        # across all chunks the permutation grand product telescopes to 1:
        # the final chunk's chained last_z must be one (permutation/prover.rs
        # sanity analog)
        final = limb.to_ints(spec, last_z.reshape(NLIMBS, 1))[0]
        assert final == 1, f"permutation product: final z = {final} != 1"

    # the set commitments are written back to back: one batched MSM (none
    # for a circuit without permutation columns)
    if zs:
        _write_points(
            params, transcript,
            params.commit_lagrange_many([Poly(z, LAGRANGE) for z in zs], blinds),
        )
    sets = []
    for z, z_blind in zip(zs, blinds):
        zc = domain.lagrange_to_coeff(Poly(z, LAGRANGE))
        coset = domain.coeff_to_extended(zc)
        sets.append(PermutationCommittedSet(zc, coset.values, z_blind))
    return PermutationCommitted(sets)


# ---------------------------------------------------------------------------
# lookup commit (lookup/prover.rs:64-305, permute at :391-475)
# ---------------------------------------------------------------------------


def _permute_expression_pair(rng, input_vals: List[int], table_vals: List[int], n: int, bf: int):
    """Host multiset matching, as lookup/prover.rs:391-475: the sorted
    inputs, each new value's first row matched by a table row, the repeats'
    rows filled by the leftover table values; then bf + 1 random blinding
    rows for each column, input first.  The prover runs
    ``permute_expression_pair_dev``; this is what the tests hold it to."""
    usable = n - (bf + 1)
    permuted_input = sorted(input_vals[:usable])
    leftover: Dict[int, int] = {}
    for v in table_vals[:usable]:
        leftover[v] = leftover.get(v, 0) + 1
    permuted_table = [0] * usable
    repeated_rows = []
    for row, v in enumerate(permuted_input):
        if row == 0 or v != permuted_input[row - 1]:
            permuted_table[row] = v
            if leftover.get(v, 0) == 0:
                raise ConstraintSystemFailure("lookup input not in table")
            leftover[v] -= 1
            if leftover[v] == 0:
                del leftover[v]
        else:
            repeated_rows.append(row)
    for v in sorted(leftover):
        for _ in range(leftover[v]):
            permuted_table[repeated_rows.pop()] = v
    assert not repeated_rows
    permuted_input.extend(rng() for _ in range(bf + 1))
    permuted_table.extend(rng() for _ in range(bf + 1))
    return permuted_input, permuted_table


def permute_expression_pair_dev(spec: FieldSpec, rng, comp_input, comp_table, n: int, bf: int):
    """``_permute_expression_pair`` on the compressed columns as (16, n)
    Montgomery limbs, on their device: (perm_input, perm_table), (16, n),
    equal limb for limb to the host function's ints in Montgomery form, with
    the same draws from ``rng``.  The matching is ``ops/lookup.py``'s (the
    kernels on the card, the plain version on the CPU); its one pull is the
    flag of a missing input value."""
    usable = n - (bf + 1)
    perm_input, perm_table, missing = lookup_ops.lookup_permute(spec, comp_input, comp_table, usable)
    with profiling.phase("limb: device to host"):
        if missing.item():
            raise ConstraintSystemFailure("lookup input not in table")
    # the blinding rows: bf + 1 for the input, then bf + 1 for the table
    blinds = limb.from_ints(spec, [rng() for _ in range(2 * (bf + 1))], comp_input.device)
    perm_input[:, usable:] = blinds[:, : bf + 1]
    perm_table[:, usable:] = blinds[:, bf + 1 :]
    return perm_input, perm_table


@profiling.profiled("lookup: compress + permute")
def _lookup_permute(arg, pk, theta, advice_values, fixed_values, instance_values,
                    challenges_dev, rng) -> dict:
    """One lookup's compressed columns and their permutation; draws the
    permutation's blinding rows, then the input and the table commitment
    blinds, in the reference's order.  The span "lookup: host matching"
    times the matching, which runs on the columns' device."""
    domain = pk.vk.domain
    spec = domain.spec
    n = domain.n
    bf = pk.vk.cs.blinding_factors()

    def evaluate(e):
        ev = evaluate_on_lagrange(
            spec, e, n, fixed_values, advice_values, instance_values, challenges_dev, domain.device
        )
        return ev.expand(NLIMBS, n)

    comp_input = compress_expressions(spec, arg.input_expressions, theta, evaluate)
    comp_table = compress_expressions(spec, arg.table_expressions, theta, evaluate)
    with profiling.phase("lookup: host matching"):
        perm_input, perm_table = permute_expression_pair_dev(
            spec, rng, comp_input, comp_table, n, bf
        )
    return {
        "comp_input": comp_input,
        "comp_table": comp_table,
        "perm_input": perm_input,
        "perm_table": perm_table,
        "input_blind": rng(),
        "table_blind": rng(),  # commit_values samples the blind before committing
    }


@profiling.profiled("lookup: grand product")
def _lookup_product(permuted, pk, beta: int, gamma: int, rng):
    """The lookup's grand product z in Lagrange form, its blinding rows and
    then its commitment blind drawn from ``rng``."""
    domain = pk.vk.domain
    spec = domain.spec
    n = domain.n
    dev = domain.device
    bf = pk.vk.cs.blinding_factors()
    beta_b = limb.from_int(spec, beta, dev).reshape(NLIMBS, 1)
    gamma_b = limb.from_int(spec, gamma, dev).reshape(NLIMBS, 1)

    denom = limb.fmul(
        spec,
        limb.fadd(spec, beta_b, permuted["perm_input"]),
        limb.fadd(spec, gamma_b, permuted["perm_table"]),
    )
    prod = limb.finv(spec, denom)
    prod = limb.fmul(spec, prod, limb.fadd(spec, permuted["comp_input"], beta_b))
    prod = limb.fmul(spec, prod, limb.fadd(spec, permuted["comp_table"], gamma_b))

    z = _prefix_product_with_start(spec, prod, limb.from_int(spec, 1, dev))
    if _sanity_checks_enabled():
        _assert_product_telescopes(spec, z, n - (bf + 1), "lookup product")
    z = _set_rows(z, n - bf, limb.from_ints(spec, [rng() for _ in range(bf)], dev))
    return z, rng()


def _lookup_committed(domain, permuted, z, product_blind) -> LookupCommitted:
    def coeff(values):
        return domain.lagrange_to_coeff(Poly(values, LAGRANGE))

    return LookupCommitted(
        permuted_input_poly=coeff(permuted["perm_input"]),
        permuted_input_blind=permuted["input_blind"],
        permuted_table_poly=coeff(permuted["perm_table"]),
        permuted_table_blind=permuted["table_blind"],
        product_poly=coeff(z),
        product_blind=product_blind,
    )


# ---------------------------------------------------------------------------
# main prover
# ---------------------------------------------------------------------------


def create_proof(params, pk: ProvingKey, circuits, instances, rng, transcript, multiopen,
                 query_instance: bool = False, mesh=None):
    """instances: list (per circuit) of list (per instance column) of int lists.

    ``multiopen`` is a callable (params, rng, transcript, queries) -> None
    (the GWC, SHPLONK and IPA provers of ``poly/``).  ``query_instance``
    selects the scheme's instance handling (prover.rs:79-132): False (KZG)
    hashes the instance values as common scalars; True (IPA) commits each
    instance column with Blind::default() = 1, hashes the commitment, writes
    the instance evaluations and opens the instance polynomials.

    ``mesh`` (a ``parallel.DeviceMesh``): the commitments run as the sharded
    MSM (``parallel/msm.py``) and the transforms as the four-step sharded NTT
    (``parallel/ntt.py``); everything else stays on ``params.device``.  The
    arithmetic is exact, so the proof bytes equal the one-device proof's.  It
    is set on ``params`` and the domain unconditionally, None included, so a
    mesh never sticks to a later call.
    """
    domain: EvaluationDomain = pk.vk.domain
    spec = domain.spec
    cs = pk.vk.cs
    n = domain.n
    p = spec.p
    dev = params.device
    params.mesh = mesh
    domain.mesh = mesh

    pk.vk.hash_into(transcript)

    bf = cs.blinding_factors()
    usable = n - (bf + 1)

    # --- instances (prover.rs:79-132) --------------------------------------
    # On KZG the span holds the hashes and the interpolation; on IPA
    # (query_instance) it also holds the instance columns' commitments.
    instance_singles = []
    with profiling.phase("instance: hash + interpolate"):
        for inst in instances:
            values, polys = [], []
            for col_values in inst:
                if len(col_values) > usable:
                    raise InstanceTooLarge()
                if not query_instance:
                    for v in col_values:
                        transcript.common_scalar(v % p)
                padded = list(col_values) + [0] * (n - len(col_values))
                lagr = Poly(limb.from_ints(spec, padded, dev), LAGRANGE)
                values.append(lagr.values)
                polys.append(domain.lagrange_to_coeff(lagr))
            if query_instance and values:
                # Blind::default() = 1; the columns' commitments are hashed back to back
                pts = params.commit_lagrange_many(
                    [Poly(v, LAGRANGE) for v in values], [1] * len(values))
                for aff in to_affine_ints(params.curve, pts):
                    transcript.common_point(aff)
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
                        [Poly(advice_values[c_idx][i], LAGRANGE) for i in col_indices],
                        [advice_blinds[c_idx][i] for i in col_indices],
                    )
                    _write_points(params, transcript, pts)
        for index, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                challenges[index] = transcript.squeeze_challenge()

    challenges_dev = [limb.from_int(spec, challenges[i], dev) for i in range(cs.num_challenges)]
    fixed_values = [f.values for f in pk.fixed_values]

    # --- theta; the lookups' permuted columns ------------------------------
    # every permuted input and table commitment, of every circuit and lookup,
    # is written back to back: one batched MSM, rng drawn in the reference's
    # order (permutation rows, input blind, table blind, per lookup)
    theta = transcript.squeeze_challenge()
    theta_dev = limb.from_int(spec, theta, dev).reshape(NLIMBS, 1)
    num_lookups = len(cs.lookups)
    permuted = [  # circuit-major, as the transcript writes them
        _lookup_permute(
            arg, pk, theta_dev, advice_values[c_idx], fixed_values,
            instance_singles[c_idx]["values"], challenges_dev, rng,
        )
        for c_idx in range(num_circuits)
        for arg in cs.lookups
    ]
    if permuted:
        with profiling.phase("lookup: permuted commits"):
            polys, blinds = [], []
            for perm in permuted:
                polys += [Poly(perm["perm_input"], LAGRANGE), Poly(perm["perm_table"], LAGRANGE)]
                blinds += [perm["input_blind"], perm["table_blind"]]
            _write_points(params, transcript, params.commit_lagrange_many(polys, blinds))

    # --- beta, gamma; permutation + lookup products ------------------------
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    permutations = [
        _permutation_commit(
            params, pk, advice_values[c_idx], fixed_values,
            instance_singles[c_idx]["values"], beta, gamma, rng, transcript,
        )
        for c_idx in range(num_circuits)
    ]

    # the product commitments of every circuit and lookup are back to back too
    products = [_lookup_product(perm, pk, beta, gamma, rng) for perm in permuted]
    if products:
        with profiling.phase("lookup: product commits"):
            pts = params.commit_lagrange_many(
                [Poly(z, LAGRANGE) for z, _ in products], [blind for _, blind in products]
            )
            _write_points(params, transcript, pts)
    committed = [
        _lookup_committed(domain, perm, z, blind) for perm, (z, blind) in zip(permuted, products)
    ]
    lookups_committed = [
        committed[c_idx * num_lookups : (c_idx + 1) * num_lookups] for c_idx in range(num_circuits)
    ]

    # --- vanishing random poly --------------------------------------------
    with profiling.phase("vanishing: random poly"):
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
            theta_dev,
            lookups_committed,
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

    if query_instance:
        # prover.rs:521-545: instance evals at rotated points
        for c_idx in range(num_circuits):
            for column, at in cs.instance_queries:
                queue_eval(instance_polys[c_idx][column.index], domain.rotate_omega(x, at))

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
    for perm in permutations:
        for set_idx, pset in enumerate(perm.sets):
            queue_eval(pset.product_poly, x)
            queue_eval(pset.product_poly, x_next)
            if set_idx < len(perm.sets) - 1:
                queue_eval(pset.product_poly, x_last)

    # lookups evaluate (x, x_next, x_inv order per lookup/prover.rs:309-337)
    x_inv = domain.rotate_omega(x, Rotation.prev())
    for per_circ in lookups_committed:
        for lk in per_circ:
            queue_eval(lk.product_poly, x)
            queue_eval(lk.product_poly, x_next)
            queue_eval(lk.permuted_input_poly, x)
            queue_eval(lk.permuted_input_poly, x_inv)
            queue_eval(lk.permuted_table_poly, x)

    with profiling.phase("evaluations at x (one batched pass)"):
        stacked = torch.stack(eval_vals, dim=1)  # (16, m, n)
        pts_mont = limb.from_ints(spec, eval_pts, dev)  # (16, m)
        out = arith.eval_polynomials_batched(spec, stacked, pts_mont)
        for v in limb.to_ints(spec, out):
            transcript.write_scalar(v)

    # --- assemble multiopen queries (prover.rs:599-645) ----------------------
    # the multiopen keys polynomials by object identity: every query of one
    # polynomial hands over the same Poly
    queries: List[ProverQuery] = []
    for c_idx in range(num_circuits):
        if query_instance:
            for column, at in cs.instance_queries:
                queries.append(ProverQuery(
                    domain.rotate_omega(x, at), instance_polys[c_idx][column.index], 1
                ))
        for column, at in cs.advice_queries:
            queries.append(
                ProverQuery(
                    domain.rotate_omega(x, at),
                    advice_polys[c_idx][column.index],
                    advice_blinds[c_idx][column.index],
                )
            )
        perm = permutations[c_idx]
        for pset in perm.sets:
            queries.append(ProverQuery(x, pset.product_poly, pset.product_blind))
            queries.append(ProverQuery(x_next, pset.product_poly, pset.product_blind))
        for pset in list(reversed(perm.sets))[1:]:
            queries.append(ProverQuery(x_last, pset.product_poly, pset.product_blind))
        for lk in lookups_committed[c_idx]:
            queries.append(ProverQuery(x, lk.product_poly, lk.product_blind))
            queries.append(ProverQuery(x, lk.permuted_input_poly, lk.permuted_input_blind))
            queries.append(ProverQuery(x, lk.permuted_table_poly, lk.permuted_table_blind))
            queries.append(ProverQuery(x_inv, lk.permuted_input_poly, lk.permuted_input_blind))
            queries.append(ProverQuery(x_next, lk.product_poly, lk.product_blind))
    for column, at in cs.fixed_queries:
        queries.append(ProverQuery(domain.rotate_omega(x, at), pk.fixed_polys[column.index], 1))
    for poly in pk.permutation.polys:
        queries.append(ProverQuery(x, poly, 1))
    queries.append(ProverQuery(x, h_poly_final, h_blind_final))
    queries.append(ProverQuery(x, random_poly, random_blind))

    with profiling.phase("multiopen"):
        multiopen(params, rng, transcript, queries)
    return transcript.finalize()
