"""MockProver: in-memory constraint checker (no commitments).

Port of the JAX package's ``dev/mock_prover.py``, a rebuild of dev.rs
(SURVEY.md §2.26-2.27): an Assignment backend that records CellValues, then
checks every gate/lookup/permutation constraint, returning structured
VerifyFailures.  Challenges are a deterministic blake2b hash chain like the
reference (dev.rs:560-569).

Two paths give the same failure list.  The per-row path evaluates each
constraint over host ints, row by row.  The vectorised path (``verify`` picks
it for n > 1024, as the JAX package does) evaluates each gate polynomial over
all n rows at once as (16, n) Montgomery limb tensors on the prover's device:
every product is K1 (``limb.fmul``) on the card, and the poison masks stay
there as ``torch.bool`` tensors until one copy of the flagged rows per
constraint.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..circuit.layouter import Assignment
from ..circuit.value import Value, to_assigned
from ..fields import limb
from ..fields.spec import NLIMBS, FieldSpec
from ..plonk.circuit import (
    ADVICE,
    FIXED,
    INSTANCE,
    AdviceExpr,
    ChallengeExpr,
    Column,
    Constant,
    ConstraintSystem,
    FixedExpr,
    InstanceExpr,
    Negated,
    Product,
    Scaled,
    Sum,
)
from ..plonk.error import NotEnoughRowsAvailable
from ..plonk.keygen import compress_selectors

UNASSIGNED = "unassigned"
POISON = "poison"


@dataclasses.dataclass
class VerifyFailure:
    kind: str  # CellNotAssigned | ConstraintNotSatisfied | ConstraintPoisoned | Lookup | Permutation
    gate: Optional[str] = None
    constraint: Optional[str] = None
    row: Optional[int] = None
    region: Optional[str] = None
    lookup_index: Optional[int] = None
    column: Optional[object] = None
    # reference-parity metadata (dev/failure.rs)
    gate_index: Optional[int] = None
    constraint_index: Optional[int] = None
    location: Optional[object] = None  # FailureLocation
    cell_values: Optional[tuple] = None  # ((virtual_cell_str, value_str), ...)
    name: Optional[str] = None  # lookup name

    def __str__(self):
        """Reference Display wording (dev/failure.rs:191-255) when location
        metadata is present; compact key=value rendering otherwise."""
        from .failure import column_str, constraint_str, render_cell_values

        if self.kind == "ConstraintNotSatisfied" and self.location is not None:
            head = constraint_str(
                self.gate_index, self.gate, self.constraint_index, self.constraint or ""
            )
            body = render_cell_values(list(self.cell_values or ()))
            return f"{head} is not satisfied {self.location}{body}"
        if self.kind == "ConstraintPoisoned" and self.gate_index is not None:
            head = constraint_str(
                self.gate_index, self.gate, self.constraint_index, self.constraint or ""
            )
            return f"{head} is active on an unusable row - missing selector?"
        if self.kind == "Lookup" and self.location is not None:
            return (
                f"Lookup {self.name}(index: {self.lookup_index}) is not "
                f"satisfied {self.location}"
            )
        if self.kind == "Permutation" and self.location is not None:
            col = column_str(self.column.kind, self.column.index)
            return f"Equality constraint not satisfied by cell ({col}, {self.location})"
        if self.kind == "CellNotAssigned" and self.column is not None and self.gate:
            col = column_str(self.column.kind, self.column.index)
            return (
                f"Region ('{self.region}') uses Gate ('{self.gate}') which "
                f"requires cell in column {col} at row {self.row} to be assigned."
            )
        parts = [self.kind]
        if self.gate:
            parts.append(f"gate={self.gate!r}")
        if self.constraint:
            parts.append(f"constraint={self.constraint!r}")
        if self.region:
            parts.append(f"region={self.region!r}")
        if self.row is not None:
            parts.append(f"row={self.row}")
        if self.lookup_index is not None:
            parts.append(f"lookup={self.lookup_index}")
        return " ".join(parts)


@dataclasses.dataclass
class _Region:
    name: str
    rows: set
    enabled_selectors: Dict[object, List[int]]
    cells: set  # (column, row)


class MockProver(Assignment):
    def __init__(self, spec: FieldSpec, k: int, cs: ConstraintSystem, device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.usable_rows = self.n - (cs.blinding_factors() + 1)
        self.fixed = [
            [UNASSIGNED] * self.n for _ in range(cs.num_fixed_columns)
        ]
        self.advice = [
            ([POISON] * self.usable_rows + [UNASSIGNED] * (self.n - self.usable_rows))
            for _ in range(cs.num_advice_columns)
        ]
        # usable advice rows start Unassigned; poison only unusable rows
        for col in self.advice:
            for r in range(self.usable_rows):
                col[r] = UNASSIGNED
            for r in range(self.usable_rows, self.n):
                col[r] = POISON
        self.instance: List[List[int]] = []
        self.selectors = [[False] * self.n for _ in range(cs.num_selectors)]
        self.challenges = self._mock_challenges(cs.num_challenges)
        self.regions: List[_Region] = []
        self._current_region: Optional[_Region] = None
        self.copies: List[Tuple[Column, int, Column, int]] = []

    def _mock_challenges(self, num):
        out = []
        state = b"Halo2-MockProver"
        for i in range(num):
            state = hashlib.blake2b(state, digest_size=64).digest()
            out.append(self.spec.from_bytes_wide(state))
        return out

    # -- classmethod run --------------------------------------------------
    @classmethod
    def run(cls, spec: FieldSpec, k: int, circuit, instances, device="cuda") -> "MockProver":
        """Synthesize ``circuit`` into a new prover.  ``device`` holds the
        vectorised path's columns: the card unless the caller asks for the
        CPU."""
        cs = ConstraintSystem()
        config = type(circuit).configure(cs)
        prover = cls(spec, k, cs, device)
        if prover.n < cs.minimum_rows():
            raise NotEnoughRowsAvailable(k)
        if len(instances) != cs.num_instance_columns:
            from ..plonk.error import InvalidInstances

            raise InvalidInstances()
        for col in instances:
            if len(col) > prover.usable_rows:
                from ..plonk.error import InstanceTooLarge

                raise InstanceTooLarge()
            prover.instance.append([v % spec.p for v in col])
        circuit.floor_planner.synthesize(prover, circuit, config, list(cs.constants))
        # compress selectors into combination fixed columns (dev.rs:588-596)
        selector_values = compress_selectors(cs, prover.selectors)
        for sv in selector_values:
            prover.fixed.append([int(b) for b in sv])
        return prover

    # -- Assignment impl ---------------------------------------------------
    def enter_region(self, name):
        self._current_region = _Region(str(name), set(), {}, set())

    def exit_region(self):
        if self._current_region is not None:
            self.regions.append(self._current_region)
        self._current_region = None

    def enable_selector(self, selector, row):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if self._current_region is not None:
            self._current_region.enabled_selectors.setdefault(selector, []).append(row)
            self._current_region.rows.add(row)
        self.selectors[selector.index][row] = True

    def query_instance(self, column, row):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        col = self.instance[column.index]
        return Value.known(col[row] if row < len(col) else 0)

    def assign_advice(self, column, row, to):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if self._current_region is not None:
            self._current_region.rows.add(row)
            self._current_region.cells.add((column, row))
        v = to()
        if not v.is_none():
            self.advice[column.index][row] = to_assigned(v.value()).evaluate(self.spec.p)
        return v

    def assign_fixed(self, column, row, to):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if self._current_region is not None:
            self._current_region.rows.add(row)
            self._current_region.cells.add((column, row))
        v = to()
        if not v.is_none():
            self.fixed[column.index][row] = to_assigned(v.value()).evaluate(self.spec.p)
        return v

    def copy(self, left_column, left_row, right_column, right_row):
        if left_row >= self.usable_rows or right_row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.copies.append((left_column, left_row, right_column, right_row))

    def fill_from_row(self, column, from_row, to: Value):
        if from_row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        v = to_assigned(to.value()).evaluate(self.spec.p) if not to.is_none() else 0
        col = self.fixed[column.index]
        for row in range(from_row, self.usable_rows):
            col[row] = v

    def get_challenge(self, challenge):
        return Value.known(self.challenges[challenge.index])

    # -- verification -------------------------------------------------------
    def _cell(self, kind, index, row):
        row %= self.n
        if kind == FIXED:
            v = self.fixed[index][row]
            return 0 if v == UNASSIGNED else v
        if kind == ADVICE:
            return self.advice[index][row]
        col = self.instance[index]
        return col[row] if row < len(col) else 0

    def _eval_expr(self, expr, row):
        """Evaluate over CellValues; returns int or POISON."""
        p = self.spec.p

        def add_op(a, b):
            if a == POISON or b == POISON:
                return POISON
            return (a + b) % p

        def mul_op(a, b):
            # dev.rs Value::mul: poison * known-zero = zero, so disabled
            # (selector = 0) gates never report poison.
            if a == POISON or b == POISON:
                if a == 0 or b == 0:
                    return 0
                return POISON
            return (a * b) % p

        def cellval(kind):
            def f(q):
                v = self._cell(kind, q.column_index, row + q.rotation.i)
                if v == UNASSIGNED:
                    return 0
                return v

            return f

        return expr.evaluate(
            lambda c: c % p,
            lambda s: (_ for _ in ()).throw(ValueError("unconverted selector")),
            cellval(FIXED),
            cellval(ADVICE),
            cellval(INSTANCE),
            lambda c: self.challenges[c.index],
            lambda a: POISON if a == POISON else (-a) % p,
            add_op,
            mul_op,
            lambda a, s: mul_op(a, s % p),
        )

    # -- vectorized verification (device) ------------------------------------

    def _vec_columns(self):
        """Columns as (16, n) Montgomery limb tensors on ``self.device`` plus
        per-column poison masks (``torch.bool`` (n,), same device).

        UNASSIGNED evaluates as zero (like _eval_expr's cellval); POISON rows
        carry value zero plus a True mask bit, and the (value, poison) lattice
        below mirrors dev.rs Value arithmetic exactly.  Every column goes
        through one bytes round trip on the host, one host-to-device copy and
        one Montgomery conversion (K1 on the card).
        """
        n = self.n
        cols = (
            list(self.fixed)
            + list(self.advice)
            + [list(c) + [0] * (n - len(c)) for c in self.instance]
        )
        ints = [0 if v == UNASSIGNED or v == POISON else v for col in cols for v in col]
        mask = np.array([v == POISON for col in cols for v in col], dtype=bool)
        vals = torch.from_numpy(limb.ints_to_limbs_np(ints)).to(self.device)
        vals = limb.to_mont(self.spec, vals).reshape(NLIMBS, len(cols), n)
        masks = torch.from_numpy(mask).to(self.device).reshape(len(cols), n)
        out = [(vals[:, i], masks[i]) for i in range(len(cols))]
        nf, na = len(self.fixed), len(self.advice)
        return out[:nf], out[nf:nf + na], out[nf + na:]

    def _eval_expr_vec(self, expr, cols):
        """Vectorized expression evaluation over all n rows at once.

        Returns (values (16, n) Montgomery limbs, poison mask (n,) bool), both
        on the columns' device.  The device analog of the reference's rayon
        verify_par (dev.rs:959-1357): each gate polynomial is one batched
        limb graph instead of O(rows) Python tree-walks.
        """
        spec = self.spec
        n = self.n
        fixed, advice, instance = cols
        no_poison = torch.zeros(n, dtype=torch.bool, device=self.device)

        def const(v):
            # a broadcast view: the limb ops below never write in place
            c = limb.from_int(spec, v % spec.p, self.device)
            return c.reshape(NLIMBS, 1).expand(NLIMBS, n), no_poison

        def rotated(source, q):
            vals, mask = source[q.column_index]
            r = q.rotation.i
            if r == 0:
                return vals, mask
            # row i reads row i + r (mod n), as jnp.roll(vals, -r)
            return torch.roll(vals, -r, dims=1), torch.roll(mask, -r, dims=0)

        def go(e):
            if isinstance(e, Constant):
                return const(e.value)
            if isinstance(e, FixedExpr):
                return rotated(fixed, e.query)
            if isinstance(e, AdviceExpr):
                return rotated(advice, e.query)
            if isinstance(e, InstanceExpr):
                return rotated(instance, e.query)
            if isinstance(e, ChallengeExpr):
                return const(self.challenges[e.challenge.index])
            if isinstance(e, Negated):
                v, m = go(e.expr)
                return limb.fneg(spec, v), m
            if isinstance(e, Sum):
                (av, am), (bv, bm) = go(e.a), go(e.b)
                return limb.fadd(spec, av, bv), am | bm
            if isinstance(e, Product):
                (av, am), (bv, bm) = go(e.a), go(e.b)
                # dev.rs Value::mul: poison * known-zero = zero (not poison)
                a_zero = limb.is_zero(av) & ~am
                b_zero = limb.is_zero(bv) & ~bm
                poison = (am | bm) & ~a_zero & ~b_zero
                return limb.fmul(spec, av, bv), poison
            if isinstance(e, Scaled):
                v, m = go(e.expr)
                cv, _ = const(e.factor)
                # a scale by 0 clears poison
                return limb.fmul(spec, v, cv), (m if e.factor % spec.p else no_poison)
            raise TypeError(f"unknown expression {type(e)}")

        return go(expr)

    def _constraint_failure(self, kind, gate_index, gate, cidx, cname, row, poly):
        from .failure import FailureLocation

        loc = FailureLocation.find_expressions(self.cs, self.regions, row, [poly])
        cell_values = None
        if kind == "ConstraintNotSatisfied":
            cell_values = tuple(self._collect_cell_values(poly, row))
        return VerifyFailure(
            kind,
            gate=gate.name,
            constraint=cname,
            row=row,
            gate_index=gate_index,
            constraint_index=cidx,
            location=loc,
            cell_values=cell_values,
        )

    def _collect_cell_values(self, poly, row):
        """Virtual cells queried by the constraint + their values at the row
        (failure.rs cell_values via util::cell_value)."""
        from .failure import column_str

        out, seen = [], set()

        def walk(e):
            if isinstance(e, (FixedExpr, AdviceExpr, InstanceExpr)):
                q = e.query
                kind = (
                    FIXED
                    if isinstance(e, FixedExpr)
                    else ADVICE if isinstance(e, AdviceExpr) else INSTANCE
                )
                key = (kind, q.column_index, q.rotation.i)
                if key not in seen:
                    seen.add(key)
                    v = self._cell(kind, q.column_index, (row + q.rotation.i) % self.n)
                    vs = hex(v) if isinstance(v, int) else str(v)
                    out.append(
                        (f"{column_str(kind, q.column_index)}@{q.rotation.i}", vs)
                    )
            for attr in ("expr", "a", "b"):
                child = getattr(e, attr, None)
                if child is not None:
                    walk(child)

        walk(poly)
        return out

    def _verify_gates_vec(self, failures):
        cols = self._vec_columns()
        usable = self.usable_rows
        for gi, gate in enumerate(self.cs.gates):
            for ci, (cname, poly) in enumerate(
                zip(gate.constraint_names, gate.polys)
            ):
                vals, poison = self._eval_expr_vec(poly, cols)
                poison = poison[:usable]
                flagged = torch.nonzero(poison | ~limb.is_zero(vals[:, :usable])).flatten()
                # one device-to-host copy per constraint: the flagged rows in
                # ascending order and their poison bits (the dense per-row
                # loop cost O(rows x constraints) at k=17)
                rows, poisoned = torch.stack([flagged, poison[flagged].long()]).cpu().tolist()
                for row, pz in zip(rows, poisoned):
                    kind = "ConstraintPoisoned" if pz else "ConstraintNotSatisfied"
                    failures.append(
                        self._constraint_failure(kind, gi, gate, ci, cname, row, poly)
                    )
        return cols

    def _verify_lookups_vec(self, failures, cols):
        usable = self.usable_rows
        for lk_idx, arg in enumerate(self.cs.lookups):
            table_cols, table_masks = [], []
            for e in arg.table_expressions:
                v, m = self._eval_expr_vec(e, cols)
                table_cols.append(limb.to_ints(self.spec, v))
                table_masks.append(m.cpu().numpy())
            input_cols, input_masks = [], []
            for e in arg.input_expressions:
                v, m = self._eval_expr_vec(e, cols)
                input_cols.append(limb.to_ints(self.spec, v))
                input_masks.append(m.cpu().numpy())
            table = set()
            for row in range(usable):
                if not any(m[row] for m in table_masks):
                    table.add(tuple(c[row] for c in table_cols))
            for row in range(usable):
                if any(m[row] for m in input_masks):
                    continue
                if tuple(c[row] for c in input_cols) not in table:
                    failures.append(self._lookup_failure(lk_idx, arg, row))

    def verify(self, vectorized: Optional[bool] = None) -> List[VerifyFailure]:
        """``vectorized=None`` auto-selects, as the JAX package does: device
        whole-column evaluation for big circuits (n > 1024, up to the k=17
        SHA-256 scale), per-row Python for tiny ones.  Both paths produce
        identical failure lists (tests/test_torch_dev_tools.py holds them
        equal to each other and to the JAX package's per-row path)."""
        if vectorized is None:
            vectorized = self.n > 1024
        if vectorized:
            return self._verify_vectorized()
        return self._verify_python()

    def _verify_vectorized(self) -> List[VerifyFailure]:
        failures: List[VerifyFailure] = []
        self._check_cells_assigned(failures)
        cols = self._verify_gates_vec(failures)
        self._verify_lookups_vec(failures, cols)
        self._check_copies(failures)
        # match the per-row path's ordering: gates, then lookups, then copies
        return failures

    def _check_cells_assigned(self, failures):
        cs = self.cs
        for region in self.regions:
            for gate in cs.gates:
                for selector, rows in region.enabled_selectors.items():
                    if selector not in gate.queried_selectors:
                        continue
                    for row in rows:
                        for column, rotation in gate.queried_cells:
                            if column.kind != ADVICE:
                                continue
                            cell_row = (row + rotation.i) % self.n
                            if (column, cell_row) not in region.cells and self.advice[
                                column.index
                            ][cell_row] in (UNASSIGNED,):
                                failures.append(
                                    VerifyFailure(
                                        "CellNotAssigned",
                                        gate=gate.name,
                                        region=region.name,
                                        row=cell_row,
                                        column=column,
                                    )
                                )

    def _lookup_failure(self, lk_idx, arg, row):
        from .failure import FailureLocation

        loc = FailureLocation.find_expressions(
            self.cs, self.regions, row, arg.input_expressions
        )
        return VerifyFailure(
            "Lookup", lookup_index=lk_idx, row=row, name=arg.name, location=loc
        )

    def _check_copies(self, failures):
        from .failure import FailureLocation

        for left_col, left_row, right_col, right_row in self.copies:
            lv = self._cell(left_col.kind, left_col.index, left_row)
            rv = self._cell(right_col.kind, right_col.index, right_row)
            if lv in (UNASSIGNED, POISON) or rv in (UNASSIGNED, POISON) or lv != rv:
                loc = FailureLocation.find(
                    self.regions, left_row, {(left_col.kind, left_col.index)}
                )
                failures.append(
                    VerifyFailure(
                        "Permutation", row=left_row, column=left_col, location=loc
                    )
                )

    def _verify_python(self) -> List[VerifyFailure]:
        failures: List[VerifyFailure] = []
        cs = self.cs

        # CellNotAssigned: shared with the vectorized path (ADVICE.md r3:
        # the inline duplicate could drift from _check_cells_assigned)
        self._check_cells_assigned(failures)

        # gate constraints on every usable row
        for gi, gate in enumerate(cs.gates):
            for ci, (cname, poly) in enumerate(
                zip(gate.constraint_names, gate.polys)
            ):
                for row in range(self.n):
                    v = self._eval_expr(poly, row)
                    if v == POISON:
                        if row < self.usable_rows:
                            failures.append(
                                self._constraint_failure(
                                    "ConstraintPoisoned", gi, gate, ci, cname, row, poly
                                )
                            )
                    elif v != 0 and row < self.usable_rows:
                        failures.append(
                            self._constraint_failure(
                                "ConstraintNotSatisfied", gi, gate, ci, cname, row, poly
                            )
                        )

        # lookups
        for lk_idx, arg in enumerate(cs.lookups):
            table = set()
            for row in range(self.usable_rows):
                entry = tuple(
                    self._eval_expr(e, row) for e in arg.table_expressions
                )
                if POISON not in entry:
                    table.add(entry)
            for row in range(self.usable_rows):
                inputs = tuple(
                    self._eval_expr(e, row) for e in arg.input_expressions
                )
                if POISON in inputs:
                    continue
                if inputs not in table:
                    failures.append(self._lookup_failure(lk_idx, arg, row))

        # permutation copies: shared with the vectorized path
        self._check_copies(failures)

        return failures

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            msg = "\n".join(str(f) for f in failures)
            raise AssertionError(f"circuit is not satisfied:\n{msg}")
