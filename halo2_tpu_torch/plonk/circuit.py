"""PLONKish constraint system frontend: columns, expressions, gates, lookups.

Python rebuild of the reference plonk/circuit.rs (SURVEY.md §2.13) with the
same consensus-critical semantics: column ordering (Instance < Advice(by
phase) < Fixed, then index; circuit.rs:50-66,207-229), query-index dedup
(:1571-1670), degree computation (:1974), blinding_factors (:2006) and
minimum_rows (:2035).  Expressions form a small AST evaluated either over host
ints (MockProver, verifier) or over (16, n) limb arrays (quotient evaluation);
constants are canonical Python ints so the AST stays field-agnostic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from ..poly.polynomial import Rotation

# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

FIRST_PHASE = 0
SECOND_PHASE = 1
THIRD_PHASE = 2


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------

INSTANCE = "instance"
ADVICE = "advice"
FIXED = "fixed"

_TYPE_ORDER = {INSTANCE: 0, ADVICE: 1, FIXED: 2}


@dataclasses.dataclass(frozen=True, order=False)
class Column:
    """A column of one of the three kinds; ordering is consensus-critical
    (Instance < Advice(phase) < Fixed, then index; circuit.rs:207-229)."""

    kind: str
    index: int
    phase: int = 0  # only meaningful for advice

    def __post_init__(self):
        # columns are hashed millions of times during synthesis (region
        # bookkeeping dicts); cache the tuple hash once
        object.__setattr__(self, "_cached_hash", hash((self.kind, self.index, self.phase)))

    def __hash__(self):
        return self._cached_hash

    def sort_key(self):
        return (_TYPE_ORDER[self.kind], self.phase if self.kind == ADVICE else 0, self.index)

    def __lt__(self, other):
        return self.sort_key() < other.sort_key()

    def __le__(self, other):
        return self.sort_key() <= other.sort_key()

    def cur(self) -> "Expression":
        return query_expr(self, Rotation.cur())

    def at(self, rotation: int) -> "Expression":
        return query_expr(self, Rotation(rotation))


@dataclasses.dataclass(frozen=True)
class Selector:
    index: int
    simple: bool

    def is_simple(self) -> bool:
        return self.simple

    def expr(self) -> "SelectorExpr":
        return SelectorExpr(self)

    def enable(self, region, offset):
        region.enable_selector(self, offset)


@dataclasses.dataclass(frozen=True)
class TableColumn:
    inner: Column  # fixed


@dataclasses.dataclass(frozen=True)
class Challenge:
    index: int
    phase: int

    def expr(self) -> "ChallengeExpr":
        return ChallengeExpr(self)


# ---------------------------------------------------------------------------
# Expressions (reference circuit.rs:679-700)
# ---------------------------------------------------------------------------


class Expression:
    def evaluate(
        self,
        constant,
        selector_column,
        fixed_column,
        advice_column,
        instance_column,
        challenge,
        negated,
        sum,
        product,
        scaled,
    ):
        raise NotImplementedError

    def degree(self) -> int:
        raise NotImplementedError

    # -- operator sugar (panics on simple-selector misuse like the reference)
    def __neg__(self):
        return Negated(self)

    def __add__(self, other):
        other = _wrap(other)
        if self.contains_simple_selector() or other.contains_simple_selector():
            raise ValueError("attempted to use a simple selector in an addition")
        return Sum(self, other)

    def __radd__(self, other):
        return _wrap(other) + self

    def __sub__(self, other):
        other = _wrap(other)
        if self.contains_simple_selector() or other.contains_simple_selector():
            raise ValueError("attempted to use a simple selector in a subtraction")
        return Sum(self, Negated(other))

    def __rsub__(self, other):
        return _wrap(other) - self

    def __mul__(self, other):
        if isinstance(other, Expression):
            if self.contains_simple_selector() and other.contains_simple_selector():
                raise ValueError(
                    "attempted to multiply two expressions containing simple selectors"
                )
            return Product(self, other)
        return Scaled(self, int(other))

    def __rmul__(self, other):
        return self * other

    def square(self):
        return self * self

    def contains_simple_selector(self) -> bool:
        return self.evaluate(
            lambda _: False,
            lambda s: s.is_simple(),
            lambda _: False,
            lambda _: False,
            lambda _: False,
            lambda _: False,
            lambda a: a,
            lambda a, b: a or b,
            lambda a, b: a or b,
            lambda a, _: a,
        )

    def extract_simple_selector(self) -> Optional[Selector]:
        def op(a, b):
            if a is not None and b is not None:
                raise ValueError("two simple selectors cannot be in the same expression")
            return a if a is not None else b

        return self.evaluate(
            lambda _: None,
            lambda s: s if s.is_simple() else None,
            lambda _: None,
            lambda _: None,
            lambda _: None,
            lambda _: None,
            lambda a: a,
            op,
            op,
            lambda a, _: a,
        )

    def identifier(self) -> str:
        return self.evaluate(
            lambda c: f"{c:#x}",
            lambda s: f"selector[{s.index}]",
            lambda q: f"fixed[{q.column_index}][{q.rotation.i}]",
            lambda q: f"advice[{q.column_index}][{q.rotation.i}]",
            lambda q: f"instance[{q.column_index}][{q.rotation.i}]",
            lambda c: f"challenge[{c.index}]",
            lambda a: f"(-{a})",
            lambda a, b: f"({a} + {b})",
            lambda a, b: f"({a} * {b})",
            lambda a, f: f"{a} * {f:#x}",
        )


def _wrap(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(f"cannot use {type(v)} in an expression")


@dataclasses.dataclass(frozen=True)
class Constant(Expression):
    value: int  # canonical int (field-agnostic)

    def evaluate(self, constant, *rest):
        return constant(self.value)

    def degree(self):
        return 0


@dataclasses.dataclass(frozen=True)
class SelectorExpr(Expression):
    selector: Selector

    def evaluate(self, constant, selector_column, *rest):
        return selector_column(self.selector)

    def degree(self):
        return 1


@dataclasses.dataclass(frozen=True)
class FixedQuery:
    index: Optional[int]
    column_index: int
    rotation: Rotation


@dataclasses.dataclass(frozen=True)
class AdviceQuery:
    index: Optional[int]
    column_index: int
    rotation: Rotation
    phase: int


@dataclasses.dataclass(frozen=True)
class InstanceQuery:
    index: Optional[int]
    column_index: int
    rotation: Rotation


@dataclasses.dataclass(frozen=True)
class FixedExpr(Expression):
    query: FixedQuery

    def evaluate(self, constant, selector_column, fixed_column, *rest):
        return fixed_column(self.query)

    def degree(self):
        return 1


@dataclasses.dataclass(frozen=True)
class AdviceExpr(Expression):
    query: AdviceQuery

    def evaluate(self, constant, selector_column, fixed_column, advice_column, *rest):
        return advice_column(self.query)

    def degree(self):
        return 1


@dataclasses.dataclass(frozen=True)
class InstanceExpr(Expression):
    query: InstanceQuery

    def evaluate(
        self, constant, selector_column, fixed_column, advice_column, instance_column, *rest
    ):
        return instance_column(self.query)

    def degree(self):
        return 1


@dataclasses.dataclass(frozen=True)
class ChallengeExpr(Expression):
    challenge: Challenge

    def evaluate(
        self,
        constant,
        selector_column,
        fixed_column,
        advice_column,
        instance_column,
        challenge,
        *rest,
    ):
        return challenge(self.challenge)

    def degree(self):
        return 0


@dataclasses.dataclass(frozen=True)
class Negated(Expression):
    expr: Expression

    def evaluate(self, *fns):
        a = self.expr.evaluate(*fns)
        return fns[6](a)

    def degree(self):
        return self.expr.degree()


@dataclasses.dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def evaluate(self, *fns):
        return fns[7](self.a.evaluate(*fns), self.b.evaluate(*fns))

    def degree(self):
        return max(self.a.degree(), self.b.degree())


@dataclasses.dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def evaluate(self, *fns):
        return fns[8](self.a.evaluate(*fns), self.b.evaluate(*fns))

    def degree(self):
        return self.a.degree() + self.b.degree()


@dataclasses.dataclass(frozen=True)
class Scaled(Expression):
    expr: Expression
    factor: int

    def evaluate(self, *fns):
        return fns[9](self.expr.evaluate(*fns), self.factor)

    def degree(self):
        return self.expr.degree()


def query_expr(column: Column, at: Rotation) -> Expression:
    """Unresolved query sugar used by Column.cur(); resolved by VirtualCells."""
    if column.kind == ADVICE:
        return AdviceExpr(AdviceQuery(None, column.index, at, column.phase))
    if column.kind == FIXED:
        return FixedExpr(FixedQuery(None, column.index, at))
    return InstanceExpr(InstanceQuery(None, column.index, at))


# ---------------------------------------------------------------------------
# Gates / lookups / permutation argument descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Gate:
    name: str
    constraint_names: List[str]
    polys: List[Expression]
    queried_selectors: List[Selector]
    queried_cells: List[Tuple[Column, Rotation]]

    def polynomials(self):
        return self.polys


@dataclasses.dataclass
class LookupArgument:
    """reference plonk/lookup.rs:13-95."""

    name: str
    input_expressions: List[Expression]
    table_expressions: List[Expression]

    def required_degree(self) -> int:
        assert len(self.input_expressions) == len(self.table_expressions)
        input_degree = max([1] + [e.degree() for e in self.input_expressions])
        table_degree = max([1] + [e.degree() for e in self.table_expressions])
        return max(4, 2 + input_degree + table_degree)


@dataclasses.dataclass
class PermutationArgument:
    """reference plonk/permutation.rs:18-76."""

    columns: List[Column] = dataclasses.field(default_factory=list)

    def required_degree(self) -> int:
        return 3

    def add_column(self, column: Column):
        if column not in self.columns:
            self.columns.append(column)

    def get_columns(self):
        return list(self.columns)


# ---------------------------------------------------------------------------
# VirtualCells
# ---------------------------------------------------------------------------


class VirtualCells:
    def __init__(self, cs: "ConstraintSystem"):
        self.cs = cs
        self.queried_selectors: List[Selector] = []
        self.queried_cells: List[Tuple[Column, Rotation]] = []

    def query_selector(self, selector: Selector) -> Expression:
        self.queried_selectors.append(selector)
        return SelectorExpr(selector)

    def query_fixed(self, column: Column, at: Rotation) -> Expression:
        assert column.kind == FIXED
        self.queried_cells.append((column, at))
        idx = self.cs.query_fixed_index(column, at)
        return FixedExpr(FixedQuery(idx, column.index, at))

    def query_advice(self, column: Column, at: Rotation) -> Expression:
        assert column.kind == ADVICE
        self.queried_cells.append((column, at))
        idx = self.cs.query_advice_index(column, at)
        return AdviceExpr(AdviceQuery(idx, column.index, at, column.phase))

    def query_instance(self, column: Column, at: Rotation) -> Expression:
        assert column.kind == INSTANCE
        self.queried_cells.append((column, at))
        idx = self.cs.query_instance_index(column, at)
        return InstanceExpr(InstanceQuery(idx, column.index, at))

    def query_any(self, column: Column, at: Rotation) -> Expression:
        return {
            ADVICE: self.query_advice,
            FIXED: self.query_fixed,
            INSTANCE: self.query_instance,
        }[column.kind](column, at)

    def query_challenge(self, challenge: Challenge) -> Expression:
        return ChallengeExpr(challenge)


# ---------------------------------------------------------------------------
# ConstraintSystem
# ---------------------------------------------------------------------------


class ConstraintSystem:
    def __init__(self):
        self.num_fixed_columns = 0
        self.num_advice_columns = 0
        self.num_instance_columns = 0
        self.num_selectors = 0
        self.num_challenges = 0
        self.advice_column_phase: List[int] = []
        self.challenge_phase: List[int] = []
        self.selector_map: List[Column] = []
        self.gates: List[Gate] = []
        self.advice_queries: List[Tuple[Column, Rotation]] = []
        self.num_advice_queries: List[int] = []
        self.instance_queries: List[Tuple[Column, Rotation]] = []
        self.fixed_queries: List[Tuple[Column, Rotation]] = []
        self.permutation = PermutationArgument()
        self.lookups: List[LookupArgument] = []
        self.constants: List[Column] = []
        self.minimum_degree: Optional[int] = None

    # -- column constructors ------------------------------------------------
    def fixed_column(self) -> Column:
        c = Column(FIXED, self.num_fixed_columns)
        self.num_fixed_columns += 1
        return c

    def advice_column(self, phase: int = FIRST_PHASE) -> Column:
        if phase > 0 and phase - 1 not in self.advice_column_phase:
            raise ValueError(f"Phase {phase - 1} must be used before phase {phase}")
        c = Column(ADVICE, self.num_advice_columns, phase)
        self.num_advice_columns += 1
        self.advice_column_phase.append(phase)
        self.num_advice_queries.append(0)
        return c

    def advice_column_in(self, phase: int) -> Column:
        return self.advice_column(phase)

    def instance_column(self) -> Column:
        c = Column(INSTANCE, self.num_instance_columns)
        self.num_instance_columns += 1
        return c

    def selector(self) -> Selector:
        s = Selector(self.num_selectors, True)
        self.num_selectors += 1
        return s

    def complex_selector(self) -> Selector:
        s = Selector(self.num_selectors, False)
        self.num_selectors += 1
        return s

    def lookup_table_column(self) -> TableColumn:
        return TableColumn(self.fixed_column())

    def challenge_usable_after(self, phase: int) -> Challenge:
        """Challenge squeezed at the END of ``phase`` (so usable from the next
        phase on).  The stored phase is the GIVEN phase, matching the
        reference (circuit.rs:1931-1943): the prover/verifier squeeze
        challenges whose phase equals the phase just committed
        (prover.rs:386-392)."""
        c = Challenge(self.num_challenges, phase)
        self.num_challenges += 1
        self.challenge_phase.append(phase)
        return c

    # -- equality / constants -------------------------------------------------
    def enable_constant(self, column: Column):
        assert column.kind == FIXED
        if column not in self.constants:
            self.constants.append(column)
            self.enable_equality(column)

    def enable_equality(self, column: Column):
        self.query_any_index(column, Rotation.cur())
        self.permutation.add_column(column)

    # -- query indices (dedup; circuit.rs:1571-1670) --------------------------
    def query_fixed_index(self, column: Column, at: Rotation) -> int:
        for index, q in enumerate(self.fixed_queries):
            if q == (column, at):
                return index
        self.fixed_queries.append((column, at))
        return len(self.fixed_queries) - 1

    def query_advice_index(self, column: Column, at: Rotation) -> int:
        for index, q in enumerate(self.advice_queries):
            if q == (column, at):
                return index
        self.advice_queries.append((column, at))
        self.num_advice_queries[column.index] += 1
        return len(self.advice_queries) - 1

    def query_instance_index(self, column: Column, at: Rotation) -> int:
        for index, q in enumerate(self.instance_queries):
            if q == (column, at):
                return index
        self.instance_queries.append((column, at))
        return len(self.instance_queries) - 1

    def query_any_index(self, column: Column, at: Rotation) -> int:
        return {
            ADVICE: self.query_advice_index,
            FIXED: self.query_fixed_index,
            INSTANCE: self.query_instance_index,
        }[column.kind](column, at)

    def get_any_query_index(self, column: Column, at: Rotation) -> int:
        qs = {
            ADVICE: self.advice_queries,
            FIXED: self.fixed_queries,
            INSTANCE: self.instance_queries,
        }[column.kind]
        for index, q in enumerate(qs):
            if q == (column, at):
                return index
        raise KeyError("query index called for non-existent query")

    # -- gates / lookups -------------------------------------------------------
    def create_gate(self, name: str, constraints: Callable[[VirtualCells], list]):
        cells = VirtualCells(self)
        items = constraints(cells)
        names, polys = [], []
        for item in items:
            if isinstance(item, tuple):
                cname, poly = item
            else:
                cname, poly = "", item
            names.append(cname)
            polys.append(poly)
        assert polys, "Gates must contain at least one constraint."
        self.gates.append(
            Gate(name, names, polys, cells.queried_selectors, cells.queried_cells)
        )

    def lookup(self, name: str, table_map: Callable[[VirtualCells], list]) -> int:
        cells = VirtualCells(self)
        mapped = []
        for inp, table in table_map(cells):
            if inp.contains_simple_selector():
                raise ValueError(
                    "expression containing simple selector supplied to lookup argument"
                )
            table_expr = cells.query_fixed(table.inner, Rotation.cur())
            mapped.append((inp, table_expr))
        self.lookups.append(
            LookupArgument(name, [i for i, _ in mapped], [t for _, t in mapped])
        )
        return len(self.lookups) - 1

    def lookup_any(self, name: str, table_map: Callable[[VirtualCells], list]) -> int:
        cells = VirtualCells(self)
        mapped = table_map(cells)
        self.lookups.append(
            LookupArgument(name, [i for i, _ in mapped], [t for _, t in mapped])
        )
        return len(self.lookups) - 1

    def set_minimum_degree(self, degree: int):
        self.minimum_degree = degree

    # -- derived quantities ----------------------------------------------------
    def phases(self):
        max_phase = max(self.advice_column_phase, default=0)
        return range(0, max_phase + 1)

    def degree(self) -> int:
        degree = self.permutation.required_degree()
        degree = max(degree, max([l.required_degree() for l in self.lookups], default=1))
        degree = max(
            degree,
            max(
                [p.degree() for g in self.gates for p in g.polynomials()],
                default=0,
            ),
        )
        return max(degree, self.minimum_degree or 1)

    def blinding_factors(self) -> int:
        factors = max(self.num_advice_queries, default=1)
        if not self.num_advice_queries:
            factors = 1
        factors = max(3, factors)
        factors += 1  # multiopen at x_3
        return factors + 1  # off-by-one defense

    def minimum_rows(self) -> int:
        return self.blinding_factors() + 3

    def pinned(self):
        return {
            "num_fixed_columns": self.num_fixed_columns,
            "num_advice_columns": self.num_advice_columns,
            "num_instance_columns": self.num_instance_columns,
            "num_selectors": self.num_selectors,
            "gates": [p.identifier() for g in self.gates for p in g.polynomials()],
            "advice_queries": [(c.index, r.i) for c, r in self.advice_queries],
            "instance_queries": [(c.index, r.i) for c, r in self.instance_queries],
            "fixed_queries": [(c.index, r.i) for c, r in self.fixed_queries],
            "permutation": [(c.kind, c.index) for c in self.permutation.columns],
            "lookups": [
                (
                    [e.identifier() for e in l.input_expressions],
                    [e.identifier() for e in l.table_expressions],
                )
                for l in self.lookups
            ],
            "constants": [(c.kind, c.index) for c in self.constants],
            "minimum_degree": self.minimum_degree,
        }
