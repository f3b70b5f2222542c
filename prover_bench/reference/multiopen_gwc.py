"""The GWC multiopen's check (poly/kzg/multiopen/gwc/verifier.rs) for a
verifier that knows the SRS's secret s.

The queries are grouped by point in first-occurrence order and batched with
powers of v within a point and of u across points.  The last check,
e(W, s*G2) == e(R, G2) over the pairing, is s * W == R in G1 when s is known.
The proof must end with the opening witnesses.
"""

from __future__ import annotations

from . import bn254


def opening_msms(points: int) -> int:
    """MSMs of the prover's openings over ``points`` distinct points: one
    witness a point."""
    return points


def verify(tr, queries: list, s: int) -> bool:
    r = bn254.R
    v = tr.squeeze()
    points, groups = [], []
    for c, z, ev in queries:
        if z not in points:
            points.append(z)
            groups.append([])
        groups[points.index(z)].append((c, ev))
    ws = [tr.read_point() for _ in points]
    u = tr.squeeze()
    if not tr.at_end():
        return False
    left, right, eval_multi, pu = [], [], 0, 1
    for z, group, w in zip(points, groups, ws):
        pv = 1
        for c, ev in group:
            right.append((pu * pv, c))
            eval_multi += pu * pv * ev
            pv = pv * v % r
        left.append((pu, w))
        right.append((pu * z, w))
        pu = pu * u % r
    right.append((-eval_multi % r, bn254.G1))
    return bn254.mul(bn254.lincomb(left), s) == bn254.lincomb(right)
