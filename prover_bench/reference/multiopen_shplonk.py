"""The SHPLONK multiopen's check (BDFG20; poly/kzg/multiopen/shplonk/
verifier.rs) for a verifier that knows the SRS's secret s.

The queries are grouped into rotation sets: each commitment's set of points,
commitments in the order of their first query, sets in the order of their
first commitment, the value of a (commitment, point) pair that of its first
query.  A commitment is the query's object, compared by identity, not by
value: two columns with equal commitments (BenchPlonk's sa and sb) stay two
commitments, as the prover's polynomials do.  The identity point (None) is
one object to Python, so two commitments at infinity would be taken for one;
no configuration's key or proof holds one.

After y and v the proof holds h, after u it holds h'.  With T the union of
all points, set i's points S_i, Z_i(u) the vanishing polynomial of T \\ S_i
at u over that of set 0 (1 for set 0) and r_ij(u) the value at u of the
polynomial through the evaluations of commitment C_ij on S_i:

  F = sum_i v^i Z_i(u) sum_j y^j (C_ij - r_ij(u) * G) - Z_(S_0)(u) * h

and the pairing check e(h', s*G2) == e(F + u*h', G2) is (s - u) * h' == F in
G1 when s is known.  The proof must end with h'.
"""

from __future__ import annotations

from . import bn254


def opening_msms(points: int) -> int:
    """MSMs of the prover's openings, whatever the number of points: h and
    h'."""
    return 2


def rotation_sets(queries: list):
    """[(points, [(commitment, [value at each point])])] in first-occurrence
    order, and the union of the points."""
    first = {}  # (id of the commitment, point) -> value of its first query
    order, points_of = [], {}
    for c, z, ev in queries:
        if id(c) not in points_of:
            order.append(c)
            points_of[id(c)] = []
        if z not in points_of[id(c)]:
            points_of[id(c)].append(z)
        first.setdefault((id(c), z), ev)
    sets = []
    for c in order:
        key = frozenset(points_of[id(c)])
        entry = next((s for s in sets if frozenset(s[0]) == key), None)
        if entry is None:
            entry = (points_of[id(c)], [])
            sets.append(entry)
        entry[1].append((c, [first[(id(c), z)] for z in entry[0]]))
    union = {z for _, z, _ in queries}
    return sets, union


def vanishing(points, u: int) -> int:
    acc = 1
    for z in points:
        acc = acc * (u - z) % bn254.R
    return acc


def interpolate_at(points: list, values: list, u: int) -> int:
    """The value at u of the polynomial of degree < len(points) through
    (points[k], values[k])."""
    r = bn254.R
    acc = 0
    for k, (zk, ek) in enumerate(zip(points, values)):
        num, den = 1, 1
        for m, zm in enumerate(points):
            if m != k:
                num = num * (u - zm) % r
                den = den * (zk - zm) % r
        acc = (acc + ek * num * pow(den, -1, r)) % r
    return acc


def verify(tr, queries: list, s: int) -> bool:
    r = bn254.R
    sets, union = rotation_sets(queries)
    y = tr.squeeze()
    v = tr.squeeze()
    h = tr.read_point()
    u = tr.squeeze()
    h2 = tr.read_point()
    if not tr.at_end():
        return False
    terms, r_outer, pv = [], 0, 1
    z0 = z0_diff = None
    for i, (points, members) in enumerate(sets):
        z_diff = vanishing([z for z in union if z not in points], u)
        if i == 0:
            z0, z0_diff = vanishing(points, u), z_diff
        z_diff = z_diff * pow(z0_diff, -1, r) % r
        py, r_inner = 1, 0
        for c, values in members:
            terms.append((pv * z_diff % r * py % r, c))
            r_inner = (r_inner + py * interpolate_at(points, values, u)) % r
            py = py * y % r
        r_outer = (r_outer + pv * z_diff % r * r_inner) % r
        pv = pv * v % r
    terms += [(-r_outer % r, bn254.G1), (-z0 % r, h)]
    return bn254.mul(h2, (s - u) % r) == bn254.lincomb(terms)
