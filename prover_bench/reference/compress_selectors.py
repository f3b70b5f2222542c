"""halo2's selector compression in plain Python: ``process`` of
plonk/circuit/compress_selectors.rs and ``ConstraintSystem::
compress_selectors`` of plonk/circuit.rs, over ``cs_selectors.SelectorCS``.

A simple selector is ("selector", index) in a gate expression until it is
compressed.  Each selector's degree is the largest degree of a gate
polynomial that holds it (0 where none does).  Selectors of degree 0 get a
fixed column each; the others are taken in index order, and each one not yet
placed opens a combination and pulls in every later one that is never active
on the same row as a member and keeps the combination within the constraint
system's degree.  A combination of m selectors is one new fixed column q
holding the member's root (1..m) on its active rows, 0 elsewhere; the member
with root a is replaced in every expression by q * prod over the other roots
b of (b - q).  New columns are fixed columns appended after the existing
ones, each queried at Rotation(0).
"""

from __future__ import annotations


def degree(e) -> int:
    """An expression's degree, a selector counting 1."""
    tag = e[0]
    if tag == "const":
        return 0
    if tag in ("fixed", "advice", "instance", "selector"):
        return 1
    if tag in ("neg", "scaled"):
        return degree(e[1])
    if tag == "sum":
        return max(degree(e[1]), degree(e[2]))
    if tag == "prod":
        return degree(e[1]) + degree(e[2])
    raise ValueError(f"unknown expression {tag}")


def simple_selector(e):
    """The index of the one selector in ``e``, or None (Expression::
    extract_simple_selector)."""
    tag = e[0]
    if tag == "selector":
        return e[1]
    if tag in ("neg", "scaled"):
        return simple_selector(e[1])
    if tag in ("sum", "prod"):
        a, b = simple_selector(e[1]), simple_selector(e[2])
        if a is not None and b is not None:
            raise ValueError("two simple selectors cannot be in the same expression")
        return a if b is None else b
    return None


def replace(e, replacements: dict):
    tag = e[0]
    if tag == "selector":
        return replacements[e[1]]
    if tag == "neg":
        return (tag, replace(e[1], replacements))
    if tag == "scaled":
        return (tag, replace(e[1], replacements), e[2])
    if tag in ("sum", "prod"):
        return (tag, replace(e[1], replacements), replace(e[2], replacements))
    return e


def process(selectors: list, max_degree: int, allocate):
    """compress_selectors.rs ``process``.  ``selectors``: [(index, set of
    active rows, degree)]; ``allocate()`` makes a new fixed column and
    returns its query expression.  Returns ([{row: value}] one per new
    column, {selector index: replacement expression})."""
    columns, replacements = [], {}
    rest = []
    for index, rows, deg in selectors:
        if deg == 0:
            replacements[index] = allocate()
            columns.append({row: 1 for row in rows})
        else:
            rest.append((index, rows, deg))
    excluded = [[not rest[i][1].isdisjoint(rest[j][1]) for j in range(i)]
                for i in range(len(rest))]
    added = [False] * len(rest)
    for i, (_, _, deg) in enumerate(rest):
        if added[i]:
            continue
        added[i] = True
        if deg > max_degree:
            raise ValueError("a selector's gate exceeds the constraint system's degree")
        d = deg - 1
        members = [i]
        for j in range(i + 1, len(rest)):
            if d + len(members) == max_degree:
                break
            if added[j] or any(excluded[j][m] for m in members):
                continue
            new_d = max(d, rest[j][2] - 1)
            if new_d + len(members) + 1 > max_degree:
                continue
            d = new_d
            members.append(j)
            added[j] = True
        query = allocate()
        column = {}
        for root, m in enumerate(members, start=1):
            expr = query
            for other in range(1, len(members) + 1):
                if other != root:
                    expr = ("prod", expr, ("sum", ("const", other), ("neg", query)))
            replacements[rest[m][0]] = expr
            column.update(dict.fromkeys(rest[m][1], root))
        columns.append(column)
    return columns, replacements


def compress(cs, activations: list) -> list:
    """Compress ``cs``'s selectors in place, ``activations[i]`` the set of
    rows on which selector i is enabled; the new fixed columns' values as
    [{row: value}], in column order."""
    if len(activations) != cs.num_selectors:
        raise ValueError("one set of rows a selector")
    degrees = [0] * cs.num_selectors
    for g in cs.gates:
        s = simple_selector(g)
        if s is not None:
            degrees[s] = max(degrees[s], degree(g))
    columns, replacements = process(
        [(i, set(rows), degrees[i]) for i, rows in enumerate(activations)], cs.degree(),
        lambda: cs.query(cs.column("fixed")))
    cs.gates = [replace(g, replacements) for g in cs.gates]
    cs.lookups = [([replace(e, replacements) for e in inputs],
                   [replace(e, replacements) for e in tables]) for inputs, tables in cs.lookups]
    return columns
