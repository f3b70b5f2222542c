"""A constraint system in plain Python: columns, queries, gate expressions,
the permutation and lookups, as halo2's ``ConstraintSystem`` records them,
with the degree and blinding rules of plonk/circuit.rs and the Rust ``{:?}``
text of ``PinnedConstraintSystem`` that the verifying key's hash covers.

Expressions are tuples:
  ("const", v) | ("fixed", q, col, rot) | ("advice", q, col, rot) |
  ("instance", q, col, rot) | ("neg", e) | ("sum", a, b) | ("prod", a, b) |
  ("scaled", e, v)
where ``q`` is the query's index in its kind's query list.
"""

from __future__ import annotations

from . import bn254

_KIND = {"advice": "Advice", "fixed": "Fixed", "instance": "Instance"}


class CS:
    def __init__(self):
        self.num = {"advice": 0, "fixed": 0, "instance": 0}
        self.queries = {"advice": [], "fixed": [], "instance": []}  # [(col, rot)]
        self.gates = []  # flattened gate polynomials, in creation order
        self.permutation = []  # [(kind, col)] in enable_equality order
        self.lookups = []  # [(input expressions, table expressions)]
        self.num_selectors = 0  # simple selectors are plain fixed columns here

    # -- building (the order of calls fixes every index) ---------------------
    def column(self, kind: str):
        self.num[kind] += 1
        return (kind, self.num[kind] - 1)

    def enable_equality(self, column):
        if column not in self.permutation:
            self.permutation.append(column)

    def query(self, column, rot: int = 0):
        kind, col = column
        qs = self.queries[kind]
        if (col, rot) not in qs:
            qs.append((col, rot))
        return (kind, qs.index((col, rot)), col, rot)

    # -- derived sizes -------------------------------------------------------
    def degree(self) -> int:
        d = 3  # the permutation argument's
        for inputs, tables in self.lookups:
            d = max(d, 2 + max([1] + [degree(e) for e in inputs])
                    + max([1] + [degree(e) for e in tables]), 4)
        for g in self.gates:
            d = max(d, degree(g))
        return d

    def blinding_factors(self) -> int:
        per_column = [sum(1 for c, _ in self.queries["advice"] if c == i)
                      for i in range(self.num["advice"])]
        return max([3] + per_column) + 2

    def extended_k(self, k: int) -> int:
        ek = k
        while (1 << ek) < (1 << k) * (self.degree() - 1):
            ek += 1
        return ek

    def permutation_sets(self) -> int:
        chunk = self.degree() - 2
        return (len(self.permutation) + chunk - 1) // chunk

    def query_index(self, column, rot: int = 0) -> int:
        kind, col = column
        return self.queries[kind].index((col, rot))

    # -- the pinned text -----------------------------------------------------
    def debug(self) -> str:
        def qlist(kind):
            return "[" + ", ".join(f"({column_debug((kind, c))}, Rotation({r}))"
                                   for c, r in self.queries[kind]) + "]"

        lookups = ", ".join(
            "Argument { input_expressions: [" + ", ".join(map(expr_debug, i))
            + "], table_expressions: [" + ", ".join(map(expr_debug, t)) + "] }"
            for i, t in self.lookups)
        return (
            "PinnedConstraintSystem { "
            f"num_fixed_columns: {self.num['fixed']}, "
            f"num_advice_columns: {self.num['advice']}, "
            f"num_instance_columns: {self.num['instance']}, "
            f"num_selectors: {self.num_selectors}, "
            "gates: [" + ", ".join(expr_debug(g) for g in self.gates) + "], "
            f"advice_queries: {qlist('advice')}, "
            f"instance_queries: {qlist('instance')}, "
            f"fixed_queries: {qlist('fixed')}, "
            "permutation: Argument { columns: ["
            + ", ".join(column_debug(c) for c in self.permutation) + "] }, "
            f"lookups: [{lookups}], "
            "constants: [], minimum_degree: None }"
        )


def degree(e) -> int:
    tag = e[0]
    if tag == "const":
        return 0
    if tag in ("fixed", "advice", "instance"):
        return 1
    if tag in ("neg", "scaled"):
        return degree(e[1])
    if tag == "sum":
        return max(degree(e[1]), degree(e[2]))
    if tag == "prod":
        return degree(e[1]) + degree(e[2])
    raise ValueError(f"unknown expression {tag}")


def evaluate(e, evals) -> int:
    """``e`` at a point, ``evals[kind][query index]`` the queries' values."""
    tag = e[0]
    if tag == "const":
        return e[1] % bn254.R
    if tag in ("fixed", "advice", "instance"):
        return evals[tag][e[1]]
    if tag == "neg":
        return -evaluate(e[1], evals) % bn254.R
    if tag == "scaled":
        return evaluate(e[1], evals) * e[2] % bn254.R
    if tag == "sum":
        return (evaluate(e[1], evals) + evaluate(e[2], evals)) % bn254.R
    if tag == "prod":
        return evaluate(e[1], evals) * evaluate(e[2], evals) % bn254.R
    raise ValueError(f"unknown expression {tag}")


def hex64(v: int) -> str:
    return f"0x{v:064x}"


def column_debug(column) -> str:
    kind, col = column
    return f"Column {{ index: {col}, column_type: {_KIND[kind]} }}"


def expr_debug(e) -> str:
    """plonk/circuit.rs's Debug of Expression, for first-phase columns."""
    tag = e[0]
    if tag == "const":
        return f"Constant({hex64(e[1] % bn254.R)})"
    if tag in ("fixed", "advice", "instance"):
        return (f"{_KIND[tag]} {{ query_index: {e[1]}, column_index: {e[2]}, "
                f"rotation: Rotation({e[3]}) }}")
    if tag == "neg":
        return f"Negated({expr_debug(e[1])})"
    if tag == "scaled":
        return f"Scaled({expr_debug(e[1])}, {hex64(e[2] % bn254.R)})"
    name = {"sum": "Sum", "prod": "Product"}[tag]
    return f"{name}({expr_debug(e[1])}, {expr_debug(e[2])})"


def add(a, b):
    return ("sum", a, b)


def sub(a, b):
    return ("sum", a, ("neg", b))


def mul(a, b):
    return ("prod", a, b)
