"""halo2's verifier (plonk/verifier.rs) for one proof over KZG on BN254
in plain Python, for a verifier that knows the SRS's secret s.

The instance values are hashed as scalars and evaluated at x
barycentrically, as the KZG scheme does.  The proof is read in the
transcript's order; the quotient's value at x is recomputed from the gate,
permutation and lookup expressions; the queries, (commitment, point, value)
in the verifier's order, go to the multiopen's check.
"""

from __future__ import annotations

from . import bn254
from .cs import evaluate


def _rotate(x: int, k: int, rot: int) -> int:
    return x * pow(bn254.omega(k), rot, bn254.R) % bn254.R


def _l_i(x: int, xn: int, k: int, rots) -> list:
    """[L_i(x) for i in rots], L_i for a negative i being L_{n+i}."""
    r, n = bn254.R, 1 << k
    common = (xn - 1) * pow(n, -1, r) % r
    out = []
    for i in rots:
        wi = pow(bn254.omega(k), i, r)
        out.append(wi * common % r * pow((x - wi) % r, -1, r) % r)
    return out


def verify(vk, instance: list, proof: bytes, s: int, reader, multiopen) -> bool:
    """True when ``proof`` verifies for ``instance`` (a list of value lists,
    one per instance column) against ``vk``; False when it is rejected,
    malformed included.  ``reader`` is a transcript's ``Reader`` class
    (``transcript_<name>.py``), ``multiopen`` a multiopen's ``verify``
    (``multiopen_<name>.py``)."""
    try:
        return _verify(vk, instance, proof, s, reader, multiopen)
    except (ValueError, ZeroDivisionError):
        return False


def _verify(vk, instance, proof, s, reader, multiopen) -> bool:
    cs, k, r = vk.cs, vk.k, bn254.R
    n = 1 << k
    if len(instance) != cs.num["instance"]:
        return False
    tr = reader(proof)
    tr.common_scalar(vk.repr)
    for col in instance:
        for v in col:
            tr.common_scalar(v)

    advice = [tr.read_point() for _ in range(cs.num["advice"])]
    theta = tr.squeeze()
    permuted = [(tr.read_point(), tr.read_point()) for _ in cs.lookups]
    beta = tr.squeeze()
    gamma = tr.squeeze()
    nsets = cs.permutation_sets()
    products = [tr.read_point() for _ in range(nsets)]
    lookup_products = [tr.read_point() for _ in cs.lookups]
    random_commitment = tr.read_point()
    y = tr.squeeze()
    h_pieces = [tr.read_point() for _ in range(cs.degree() - 1)]
    x = tr.squeeze()
    xn = pow(x, n, r)

    rots = [rot for _, rot in cs.queries["instance"]]
    max_rot, min_rot = max([0] + rots), min([0] + rots)
    longest = max([0] + [len(col) for col in instance])
    lis = _l_i(x, xn, k, range(-max_rot, longest + abs(min_rot)))
    instance_evals = []
    for col, rot in cs.queries["instance"]:
        off = max_rot - rot
        instance_evals.append(sum(v * li for v, li in zip(instance[col], lis[off:])) % r)

    advice_evals = [tr.read_scalar() for _ in cs.queries["advice"]]
    fixed_evals = [tr.read_scalar() for _ in cs.queries["fixed"]]
    random_eval = tr.read_scalar()
    sigma_evals = [tr.read_scalar() for _ in cs.permutation]
    sets = []
    for i in range(nsets):
        ev, nxt = tr.read_scalar(), tr.read_scalar()
        last = tr.read_scalar() if i < nsets - 1 else None
        sets.append((ev, nxt, last))
    lookup_evals = [[tr.read_scalar() for _ in range(5)] for _ in cs.lookups]

    # the quotient's value at x
    bf = cs.blinding_factors()
    ls = _l_i(x, xn, k, range(-(bf + 1), 1))
    l_last, l_blind, l_0 = ls[0], sum(ls[1:bf + 1]) % r, ls[bf + 1]
    active = (1 - l_last - l_blind) % r
    evals = {"advice": advice_evals, "fixed": fixed_evals, "instance": instance_evals}
    exprs = [evaluate(g, evals) for g in cs.gates]
    if sets:
        exprs.append(l_0 * (1 - sets[0][0]) % r)
        exprs.append((sets[-1][0] ** 2 - sets[-1][0]) * l_last % r)
        for i in range(1, nsets):
            exprs.append((sets[i][0] - sets[i - 1][2]) * l_0 % r)
        chunk = cs.degree() - 2
        for i, (ev, nxt, _) in enumerate(sets):
            cols = cs.permutation[i * chunk:(i + 1) * chunk]
            left, right = nxt, ev
            delta = beta * x * pow(bn254.DELTA, i * chunk, r) % r
            for j, col in enumerate(cols):
                val = evals[col[0]][cs.query_index(col)]
                left = left * (val + beta * sigma_evals[i * chunk + j] + gamma) % r
                right = right * (val + delta + gamma) % r
                delta = delta * bn254.DELTA % r
            exprs.append((left - right) * active % r)
    for (inputs, tables), (z, z_next, a, a_prev, t) in zip(cs.lookups, lookup_evals):
        def compress(es):
            acc = 0
            for e in es:
                acc = (acc * theta + evaluate(e, evals)) % r
            return acc

        exprs.append(l_0 * (1 - z) % r)
        exprs.append(l_last * (z * z - z) % r)
        left = z_next * (a + beta) * (t + gamma) % r
        right = z * (compress(inputs) + beta) * (compress(tables) + gamma) % r
        exprs.append((left - right) * active % r)
        exprs.append(l_0 * (a - t) % r)
        exprs.append((a - t) * (a - a_prev) * active % r)
    h_eval = 0
    for e in exprs:
        h_eval = (h_eval * y + e) % r
    h_eval = h_eval * pow(xn - 1, -1, r) % r
    h_commitment = bn254.lincomb([(pow(xn, i, r), pt) for i, pt in enumerate(h_pieces)])

    # the queries, in the verifier's order
    x_next, x_prev = _rotate(x, k, 1), _rotate(x, k, -1)
    x_last = _rotate(x, k, -(bf + 1))
    queries = [(advice[col], _rotate(x, k, rot), v)
               for (col, rot), v in zip(cs.queries["advice"], advice_evals)]
    for c, (ev, nxt, _) in zip(products, sets):
        queries += [(c, x, ev), (c, x_next, nxt)]
    for c, (_, _, last) in list(zip(products, sets))[::-1][1:]:
        queries.append((c, x_last, last))
    for (pin, ptab), prod, (z, z_next, a, a_prev, t) in zip(permuted, lookup_products, lookup_evals):
        queries += [(prod, x, z), (pin, x, a), (ptab, x, t), (pin, x_prev, a_prev),
                    (prod, x_next, z_next)]
    queries += [(vk.fixed[col], _rotate(x, k, rot), v)
                for (col, rot), v in zip(cs.queries["fixed"], fixed_evals)]
    queries += [(c, x, v) for c, v in zip(vk.permutation, sigma_evals)]
    queries += [(h_commitment, x, h_eval), (random_commitment, x, random_eval)]
    return multiopen(tr, queries, s)
