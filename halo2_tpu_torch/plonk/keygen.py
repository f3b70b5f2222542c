"""Key generation: circuit synthesis into fixed columns, sigma polys, keys.

Port of the JAX package's ``plonk/keygen.py`` (the reference plonk/keygen.rs
plus the VerifyingKey/ProvingKey containers of plonk.rs).  Selector
compression and the keygen assembly are host Python, copied unchanged.

Two batching changes, proof bytes unchanged: synthesis runs once
(``keygen_vk`` hands its result to ``keygen_pk`` through the VerifyingKey;
the JAX package synthesizes in both), and all fixed and sigma columns
commit in one ``msm_many`` instead of one MSM per column.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np

from ..circuit.layouter import Assignment
from ..circuit.value import Assigned, Value, to_assigned
from ..curves.point import to_affine_ints
from ..fields import limb
from ..fields.spec import FieldSpec
from ..plonk.error import NotEnoughRowsAvailable
from ..poly.domain import EvaluationDomain
from ..poly.polynomial import LAGRANGE, Poly, Rotation
from .circuit import (
    ConstraintSystem,
    Expression,
    FixedExpr,
    FixedQuery,
    Negated,
    Product,
    Scaled,
    SelectorExpr,
    Sum,
)
from .permutation import PermutationAssembly, build_pk


# ---------------------------------------------------------------------------
# selector -> fixed conversion
# ---------------------------------------------------------------------------

def _replace_selectors(expr: Expression, replacements) -> Expression:
    if isinstance(expr, SelectorExpr):
        return replacements[expr.selector.index]
    if isinstance(expr, Negated):
        return Negated(_replace_selectors(expr.expr, replacements))
    if isinstance(expr, Sum):
        return Sum(
            _replace_selectors(expr.a, replacements),
            _replace_selectors(expr.b, replacements),
        )
    if isinstance(expr, Product):
        return Product(
            _replace_selectors(expr.a, replacements),
            _replace_selectors(expr.b, replacements),
        )
    if isinstance(expr, Scaled):
        return Scaled(_replace_selectors(expr.expr, replacements), expr.factor)
    return expr


def _apply_replacements(cs: ConstraintSystem, replacements):
    for gate in cs.gates:
        gate.polys = [_replace_selectors(p, replacements) for p in gate.polys]
    for lk in cs.lookups:
        lk.input_expressions = [
            _replace_selectors(e, replacements) for e in lk.input_expressions
        ]
        lk.table_expressions = [
            _replace_selectors(e, replacements) for e in lk.table_expressions
        ]


def _process_selector_combinations(descriptions, max_degree, allocate):
    """compress_selectors.rs:50-227 ``process`` — deterministic packing of
    disjoint simple selectors into combination fixed columns under the degree
    budget.  descriptions: list of (selector_index, activations, max_degree).
    Returns (combination_assignments [int lists], selector_assignments
    [(selector_index, combination_index, expression)])."""
    from .circuit import Constant

    if not descriptions:
        return [], []
    n = len(descriptions[0][1])
    assert all(len(d[1]) == n for d in descriptions)

    combination_assignments = []
    selector_assignments = []

    # degree-0 selectors (complex or unused in gates): own fixed column
    remaining = []
    for sel_idx, activations, degree in descriptions:
        if degree == 0:
            expression = allocate()
            combination_assignments.append([1 if b else 0 for b in activations])
            selector_assignments.append(
                (sel_idx, len(combination_assignments) - 1, expression)
            )
        else:
            remaining.append((sel_idx, activations, degree))

    # exclusion matrix over the simple selectors
    m = len(remaining)
    exclusion = [[False] * i for i in range(m)]
    for i in range(m):
        rows_i = remaining[i][1]
        for j in range(i):
            rows_j = remaining[j][1]
            if any(l and r for l, r in zip(rows_i, rows_j)):
                exclusion[i][j] = True

    added = [False] * m
    for i in range(m):
        if added[i]:
            continue
        added[i] = True
        sel_idx, activations, degree = remaining[i]
        assert degree <= max_degree
        d = degree - 1
        combination = [remaining[i]]
        combination_added = [i]

        for j in range(i + 1, m):
            if d + len(combination) == max_degree:
                break
            if added[j]:
                continue
            if any(exclusion[j][k] for k in combination_added):
                continue
            new_d = max(d, remaining[j][2] - 1)
            if new_d + len(combination) + 1 > max_degree:
                continue
            d = new_d
            combination.append(remaining[j])
            combination_added.append(j)
            added[j] = True

        combination_assignment = [0] * n
        combination_len = len(combination)
        combination_index = len(combination_assignments)
        query = allocate()

        assigned_root = 1
        for c_sel_idx, c_activations, _ in combination:
            # q * Prod[root != assigned_root](root - q)
            expression = query
            for root in range(1, combination_len + 1):
                if root != assigned_root:
                    expression = expression * (Constant(root) - query)
            for row, active in enumerate(c_activations):
                if active:
                    combination_assignment[row] = assigned_root
            selector_assignments.append((c_sel_idx, combination_index, expression))
            assigned_root += 1
        combination_assignments.append(combination_assignment)

    return combination_assignments, selector_assignments


def compress_selectors(cs: ConstraintSystem, selectors: List[np.ndarray]):
    """plonk/circuit.rs:1723-1800 ``compress_selectors``: pack boolean
    selectors into few fixed columns under the existing degree budget, rewrite
    gate/lookup expressions, and return the combination column values as
    numpy int arrays."""
    assert len(selectors) == cs.num_selectors
    if cs.num_selectors == 0:
        return []

    degrees = [0] * cs.num_selectors
    for gate in cs.gates:
        for poly in gate.polys:
            sel = poly.extract_simple_selector()
            if sel is not None:
                degrees[sel.index] = max(degrees[sel.index], poly.degree())

    max_degree = cs.degree()
    new_columns = []

    def allocate():
        column = cs.fixed_column()
        new_columns.append(column)
        idx = cs.query_fixed_index(column, Rotation.cur())
        return FixedExpr(FixedQuery(idx, column.index, Rotation.cur()))

    descriptions = [
        (i, [bool(b) for b in selectors[i]], degrees[i])
        for i in range(cs.num_selectors)
    ]
    combination_assignments, selector_assignments = _process_selector_combinations(
        descriptions, max_degree, allocate
    )

    replacements = [None] * cs.num_selectors
    selector_map = [None] * cs.num_selectors
    for sel_idx, combination_index, expression in selector_assignments:
        replacements[sel_idx] = expression
        selector_map[sel_idx] = new_columns[combination_index]
    cs.selector_map = selector_map
    _apply_replacements(cs, replacements)
    return [np.asarray(vals, dtype=np.int64) for vals in combination_assignments]


# ---------------------------------------------------------------------------
# keygen assembly
# ---------------------------------------------------------------------------


class KeygenAssembly(Assignment):
    """keygen.rs:50-200 — captures fixed values, selectors and copies."""

    def __init__(self, k: int, cs: ConstraintSystem, n: int):
        self.k = k
        self.n = n
        # fixed values as per-column dict {row: Assigned}; default zero
        self.fixed = [dict() for _ in range(cs.num_fixed_columns)]
        self.permutation = PermutationAssembly(n, cs.permutation)
        self.selectors = [np.zeros(n, dtype=bool) for _ in range(cs.num_selectors)]
        self.usable_rows = n - (cs.blinding_factors() + 1)

    def _check_row(self, row):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)

    def enable_selector(self, selector, row):
        self._check_row(row)
        self.selectors[selector.index][row] = True

    def query_instance(self, column, row):
        self._check_row(row)
        return Value.unknown()

    def assign_advice(self, column, row, to):
        return None  # only fixed matters during keygen

    def assign_fixed(self, column, row, to):
        self._check_row(row)
        v = to()
        if not v.is_none():
            self.fixed[column.index][row] = to_assigned(v.value())
        return v

    def copy(self, left_column, left_row, right_column, right_row):
        self._check_row(left_row)
        self._check_row(right_row)
        self.permutation.copy(left_column, left_row, right_column, right_row)

    def fill_from_row(self, column, from_row, to: Value):
        self._check_row(from_row)
        v = to_assigned(to.value()) if not to.is_none() else Assigned.zero()
        col = self.fixed[column.index]
        for row in range(from_row, self.usable_rows):
            col[row] = v


def batch_invert_assigned(spec: FieldSpec, columns: List[dict], n: int, device=None) -> List[Poly]:
    """Materialize Assigned columns: num * den^-1, batched on the device
    (reference poly.rs:180-209)."""
    if not columns:
        return []
    p = spec.p
    nums, dens = [], []
    all_trivial = True
    for col in columns:
        cn = [0] * n
        cd = [1] * n
        for row, a in col.items():
            cn[row] = a.numerator % p
            if a.denominator != 1:
                all_trivial = False
                cd[row] = a.denominator % p
        nums.extend(cn)
        dens.extend(cd)
    vals = limb.from_canonical_ints(spec, nums, device)
    if not all_trivial:
        # deferred-division (Rational) cells: one Fermat inversion per element
        den = limb.from_canonical_ints(spec, dens, device)
        vals = limb.fmul(spec, vals, limb.finv(spec, den))
    return [Poly(vals[:, i * n : (i + 1) * n], LAGRANGE) for i in range(len(columns))]


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


class VerifyingKey:
    """plonk.rs:49-259."""

    def __init__(self, domain, cs, fixed_commitments, permutation_commitments, selectors,
                 curve, synthesis=None):
        self.domain: EvaluationDomain = domain
        self.cs: ConstraintSystem = cs
        self.fixed_commitments = fixed_commitments  # host affine points
        self.permutation_commitments = permutation_commitments
        self.selectors = selectors  # (n,) bool arrays, written with the key
        self.curve = curve
        # keygen_vk's synthesis (fixed and sigma columns in Lagrange form),
        # reused by keygen_pk so the circuit is synthesized once; the
        # ProvingKey holds the same tensors, so keeping them costs nothing.
        # None for a key read from bytes: keygen_pk synthesizes again.
        self.synthesis = synthesis
        self.transcript_repr = self._compute_repr()

    def _compute_repr(self) -> int:
        """Blake2b('Halo2-Verify-Key') over Rust's `{:?}` Debug formatting of
        PinnedVerificationKey, byte-identical to plonk.rs:192-206 (the hash
        input is `s.len() as u64 LE || s`)."""
        from .rust_debug import pinned_vk_debug

        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        s = pinned_vk_debug(self, self.curve.base.p, self.curve.scalar.p, alternate=False).encode()
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
        return self.domain.spec.from_bytes_wide(h.digest())

    def hash_into(self, transcript):
        transcript.common_scalar(self.transcript_repr)


class ProvingKey:
    def __init__(
        self,
        vk: VerifyingKey,
        l0: Poly,
        l_last: Poly,
        l_active_row: Poly,
        fixed_values: List[Poly],
        fixed_polys: List[Poly],
        fixed_cosets: List[Poly],
        permutation_pk,
        ev,
    ):
        self.vk = vk
        self.l0 = l0
        self.l_last = l_last
        self.l_active_row = l_active_row
        self.fixed_values = fixed_values
        self.fixed_polys = fixed_polys
        self.fixed_cosets = fixed_cosets
        self.permutation = permutation_pk
        self.ev = ev


# ---------------------------------------------------------------------------
# keygen entry points (keygen.rs:203-367)
# ---------------------------------------------------------------------------


def create_domain(spec: FieldSpec, circuit_cls, k: int, device=None):
    cs = ConstraintSystem()
    config = circuit_cls.configure(cs)
    domain = EvaluationDomain(spec, cs.degree(), k, device)
    return domain, cs, config


def _run_keygen_synthesis(params, spec, circuit):
    """Synthesize the circuit once: fixed columns (selectors compressed in)
    and the sigma polynomials, all in Lagrange form on ``params.device``."""
    k = params.k
    domain, cs, config = create_domain(spec, type(circuit), k, params.device)
    n = 1 << k
    if n < cs.minimum_rows():
        raise NotEnoughRowsAvailable(k)
    assembly = KeygenAssembly(k, cs, n)
    circuit.floor_planner.synthesize(assembly, circuit, config, list(cs.constants))
    fixed = batch_invert_assigned(spec, assembly.fixed, n, params.device)
    for sv in compress_selectors(cs, assembly.selectors):
        vals = limb.from_canonical_ints(spec, [int(b) for b in sv], params.device)
        fixed.append(Poly(vals, LAGRANGE))
    sigmas = assembly.permutation.sigma_lagrange(spec, domain)
    return domain, cs, assembly, fixed, sigmas


def keygen_vk(params, circuit, spec: FieldSpec | None = None) -> VerifyingKey:
    spec = spec or params.curve.scalar
    synthesis = _run_keygen_synthesis(params, spec, circuit)
    domain, cs, assembly, fixed, sigmas = synthesis
    # every fixed and sigma column in ONE batched MSM, each with
    # Blind::default() = 1 (keygen.rs:247-250; KZG ignores it, IPA adds w)
    columns = fixed + sigmas
    commitments = to_affine_ints(
        params.curve, params.commit_lagrange_many(columns, [1] * len(columns))
    )
    return VerifyingKey(
        domain, cs, commitments[: len(fixed)], commitments[len(fixed) :], assembly.selectors,
        params.curve, synthesis,
    )


def keygen_pk(params, vk: VerifyingKey, circuit, spec: FieldSpec | None = None) -> ProvingKey:
    spec = spec or params.curve.scalar
    domain, cs, _, fixed, sigmas = vk.synthesis or _run_keygen_synthesis(params, spec, circuit)
    n = 1 << params.k
    dev = params.device

    fixed_polys = [domain.lagrange_to_coeff(p) for p in fixed]
    fixed_cosets = [domain.coeff_to_extended(p) for p in fixed_polys]
    perm_pk = build_pk(domain, sigmas)

    bf = cs.blinding_factors()

    def indicator(rows):
        vals = [0] * n
        for r in rows:
            vals[r] = 1
        lagr = Poly(limb.from_canonical_ints(spec, vals, dev), LAGRANGE)
        return domain.coeff_to_extended(domain.lagrange_to_coeff(lagr))

    l0 = indicator([0])
    l_blind = indicator(range(n - bf, n))
    l_last = indicator([n - bf - 1])
    ones_ext = domain.constant_extended(limb.from_int(spec, 1, dev))
    l_active_row = Poly(
        limb.fsub(spec, ones_ext.values, limb.fadd(spec, l_last.values, l_blind.values)),
        l_last.basis,
    )

    from .evaluation import Evaluator

    ev = Evaluator(vk.cs)
    return ProvingKey(
        vk, l0, l_last, l_active_row, fixed, fixed_polys, fixed_cosets, perm_pk, ev
    )
