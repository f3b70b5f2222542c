"""Byte-exact emulation of Rust's Debug formatting for PinnedVerificationKey.

The reference computes ``vk.transcript_repr`` as
``blake2b('Halo2-Verify-Key', len || format!("{:?}", vk.pinned()))``
(plonk.rs:185-206), and pins ``format!("{:#?}", vk.pinned())`` in
tests/plonk_api.rs:622-626.  To produce bit-identical proofs the very first
transcript absorb must match, so this module reproduces both formatting
modes of std::fmt's Debug builders over our VK structure:

- compact ``{:?}``: ``Name { f: v, g: w }``, ``Name(a, b)``, ``[a, b]``
- alternate ``{:#?}``: one item per line, 4-space indent, trailing commas

plus the reference's custom Debug impls: field elements print as bare
``0x`` + 64 lowercase hex nibbles, affine points as single-line
``(0x…, 0x…)`` tuples (ignoring the alternate flag), Expression variants
hide the enum wrapper and the first-phase ``phase`` field
(plonk/circuit.rs:1083-1137), and PinnedConstraintSystem omits the
challenge fields when no challenges are used (circuit.rs:1416-1442).
"""

from __future__ import annotations

from typing import List, Tuple, Union

from .circuit import (
    ADVICE,
    FIXED,
    INSTANCE,
    AdviceExpr,
    ChallengeExpr,
    Constant,
    ConstraintSystem,
    FixedExpr,
    InstanceExpr,
    Negated,
    Product,
    Scaled,
    SelectorExpr,
    Sum,
)

# ---------------------------------------------------------------------------
# Debug-value tree + renderer (std::fmt debug_struct / debug_tuple / debug_list)
# ---------------------------------------------------------------------------


class Raw:
    """Pre-rendered atom (numbers, hex scalars, strings, None, points)."""

    def __init__(self, text: str):
        self.text = text


class Struct:
    def __init__(self, name: str, fields: List[Tuple[str, "Node"]]):
        self.name = name
        self.fields = fields


class TupleNode:
    """Tuple struct/variant when named; plain tuple when name == ''."""

    def __init__(self, name: str, items: List["Node"]):
        self.name = name
        self.items = items


class ListNode:
    def __init__(self, items: List["Node"]):
        self.items = items


Node = Union[Raw, Struct, TupleNode, ListNode]


def render(node: Node, alternate: bool, indent: int = 0) -> str:
    pad = "    " * indent
    pad1 = "    " * (indent + 1)
    if isinstance(node, Raw):
        return node.text
    if isinstance(node, Struct):
        if not node.fields:
            return node.name
        if alternate:
            inner = "".join(
                f"{pad1}{fname}: {render(v, True, indent + 1)},\n"
                for fname, v in node.fields
            )
            return f"{node.name} {{\n{inner}{pad}}}"
        inner = ", ".join(
            f"{fname}: {render(v, False)}" for fname, v in node.fields
        )
        return f"{node.name} {{ {inner} }}"
    if isinstance(node, TupleNode):
        if alternate:
            inner = "".join(
                f"{pad1}{render(v, True, indent + 1)},\n" for v in node.items
            )
            return f"{node.name}(\n{inner}{pad})"
        inner = ", ".join(render(v, False) for v in node.items)
        return f"{node.name}({inner})"
    if isinstance(node, ListNode):
        if not node.items:
            return "[]"
        if alternate:
            inner = "".join(
                f"{pad1}{render(v, True, indent + 1)},\n" for v in node.items
            )
            return f"[\n{inner}{pad}]"
        return "[" + ", ".join(render(v, False) for v in node.items) + "]"
    raise TypeError(node)


# ---------------------------------------------------------------------------
# Builders mirroring the reference Debug impls
# ---------------------------------------------------------------------------


def hex64(v: int) -> str:
    return f"0x{v:064x}"


def scalar_node(v: int) -> Raw:
    return Raw(hex64(v))


def point_node(pt) -> Raw:
    """Affine point: custom single-line Debug `(0x…, 0x…)` (halo2curves)."""
    if pt is None:
        # identity prints with both coordinates zero in the reference encoding
        return Raw(f"({hex64(0)}, {hex64(0)})")
    return Raw(f"({hex64(pt[0])}, {hex64(pt[1])})")


def rotation_node(rot) -> TupleNode:
    return TupleNode("Rotation", [Raw(str(rot.i))])


_KIND_NAME = {ADVICE: "Advice", FIXED: "Fixed", INSTANCE: "Instance"}


def column_node(col) -> Struct:
    return Struct(
        "Column",
        [("index", Raw(str(col.index))), ("column_type", Raw(_KIND_NAME[col.kind]))],
    )


def expression_node(expr) -> Node:
    """plonk/circuit.rs:1083-1137 custom Debug for Expression."""
    if isinstance(expr, Constant):
        return TupleNode("Constant", [scalar_node(expr.value)])
    if isinstance(expr, SelectorExpr):
        s = expr.selector
        return TupleNode(
            "Selector",
            [Raw(str(s.index)), Raw("true" if s.is_simple else "false")],
        )
    if isinstance(expr, FixedExpr):
        q = expr.query
        return Struct(
            "Fixed",
            [
                ("query_index", Raw(str(q.index))),
                ("column_index", Raw(str(q.column_index))),
                ("rotation", rotation_node(q.rotation)),
            ],
        )
    if isinstance(expr, AdviceExpr):
        q = expr.query
        fields = [
            ("query_index", Raw(str(q.index))),
            ("column_index", Raw(str(q.column_index))),
            ("rotation", rotation_node(q.rotation)),
        ]
        if q.phase != 0:  # only shown when not FirstPhase
            fields.append(("phase", TupleNode("Phase", [Raw(str(q.phase))])))
        return Struct("Advice", fields)
    if isinstance(expr, InstanceExpr):
        q = expr.query
        return Struct(
            "Instance",
            [
                ("query_index", Raw(str(q.index))),
                ("column_index", Raw(str(q.column_index))),
                ("rotation", rotation_node(q.rotation)),
            ],
        )
    if isinstance(expr, ChallengeExpr):
        c = expr.challenge
        return Struct(
            "Challenge",
            [("index", Raw(str(c.index))), ("phase", TupleNode("Phase", [Raw(str(c.phase))]))],
        )
    if isinstance(expr, Negated):
        return TupleNode("Negated", [expression_node(expr.expr)])
    if isinstance(expr, Sum):
        return TupleNode("Sum", [expression_node(expr.a), expression_node(expr.b)])
    if isinstance(expr, Product):
        return TupleNode("Product", [expression_node(expr.a), expression_node(expr.b)])
    if isinstance(expr, Scaled):
        return TupleNode("Scaled", [expression_node(expr.expr), scalar_node(expr.factor)])
    raise TypeError(f"unknown expression node {type(expr)}")


def pinned_cs_node(cs: ConstraintSystem) -> Struct:
    """PinnedConstraintSystem Debug (circuit.rs:1396-1442)."""
    fields = [
        ("num_fixed_columns", Raw(str(cs.num_fixed_columns))),
        ("num_advice_columns", Raw(str(cs.num_advice_columns))),
        ("num_instance_columns", Raw(str(cs.num_instance_columns))),
        ("num_selectors", Raw(str(cs.num_selectors))),
    ]
    if cs.num_challenges > 0:
        fields += [
            ("num_challenges", Raw(str(cs.num_challenges))),
            (
                "advice_column_phase",
                ListNode([TupleNode("Phase", [Raw(str(p))]) for p in cs.advice_column_phase]),
            ),
            (
                "challenge_phase",
                ListNode([TupleNode("Phase", [Raw(str(p))]) for p in cs.challenge_phase]),
            ),
        ]

    def query_list(queries):
        return ListNode(
            [
                TupleNode("", [column_node(c), rotation_node(r)])
                for c, r in queries
            ]
        )

    fields += [
        (
            "gates",
            ListNode(
                [expression_node(p) for g in cs.gates for p in g.polynomials()]
            ),
        ),
        ("advice_queries", query_list(cs.advice_queries)),
        ("instance_queries", query_list(cs.instance_queries)),
        ("fixed_queries", query_list(cs.fixed_queries)),
        (
            "permutation",
            Struct(
                "Argument",
                [("columns", ListNode([column_node(c) for c in cs.permutation.get_columns()]))],
            ),
        ),
        (
            "lookups",
            ListNode(
                [
                    Struct(
                        "Argument",
                        [
                            (
                                "input_expressions",
                                ListNode([expression_node(e) for e in l.input_expressions]),
                            ),
                            (
                                "table_expressions",
                                ListNode([expression_node(e) for e in l.table_expressions]),
                            ),
                        ],
                    )
                    for l in cs.lookups
                ]
            ),
        ),
        ("constants", ListNode([column_node(c) for c in cs.constants])),
        (
            "minimum_degree",
            Raw("None")
            if cs.minimum_degree is None
            else TupleNode("Some", [Raw(str(cs.minimum_degree))]),
        ),
    ]
    return Struct("PinnedConstraintSystem", fields)


def pinned_vk_node(vk, base_modulus: int, scalar_modulus: int) -> Struct:
    """PinnedVerificationKey Debug (plonk.rs:219-259)."""
    return Struct(
        "PinnedVerificationKey",
        [
            ("base_modulus", Raw(f'"{hex64(base_modulus)}"')),
            ("scalar_modulus", Raw(f'"{hex64(scalar_modulus)}"')),
            (
                "domain",
                Struct(
                    "PinnedEvaluationDomain",
                    [
                        ("k", Raw(str(vk.domain.k))),
                        ("extended_k", Raw(str(vk.domain.extended_k))),
                        ("omega", scalar_node(vk.domain.omega)),
                    ],
                ),
            ),
            ("cs", pinned_cs_node(vk.cs)),
            (
                "fixed_commitments",
                ListNode([point_node(pt) for pt in vk.fixed_commitments]),
            ),
            (
                "permutation",
                Struct(
                    "VerifyingKey",
                    [
                        (
                            "commitments",
                            ListNode([point_node(pt) for pt in vk.permutation_commitments]),
                        )
                    ],
                ),
            ),
        ],
    )


def pinned_vk_debug(vk, base_modulus: int, scalar_modulus: int, alternate: bool) -> str:
    return render(pinned_vk_node(vk, base_modulus, scalar_modulus), alternate)
