"""Vectorized polynomial arithmetic.

Port of the JAX package's ``ops/arith.py`` (replacements for the reference
arithmetic.rs helpers):
- eval_polynomial (Horner loop)   -> batched power-table dot + tree reduce
- kate_division (synthetic div.)  -> suffix-scan closed form
- lagrange_interpolate            -> host ints (tiny inputs only)
"""

from __future__ import annotations

import torch

from ..fields import limb
from ..fields.spec import FieldSpec
from . import ntt as ntt_ops


def _tree_sum(spec: FieldSpec, a):
    """Tree-sum a (16, ..., n) limb tensor over its last axis."""
    n = a.shape[-1]
    while n > 1:
        half = n // 2
        s = limb.fadd(spec, a[..., :half], a[..., half : 2 * half])
        if n % 2:
            s = torch.cat([s, a[..., -1:]], dim=-1)
            n = half + 1
        else:
            n = half
        a = s
    return a[..., 0]


def reduce_add(spec: FieldSpec, a):
    """Tree-sum a (16, n) limb tensor over axis 1 -> (16,)."""
    return _tree_sum(spec, a)


def eval_polynomials_batched(spec: FieldSpec, coeffs, x_mont):
    """Evaluate m coefficient-form polys at m points in one batched pass.

    coeffs: (16, m, n); x_mont: (16, m) Montgomery points.  Returns (16, m).
    """
    m, n = coeffs.shape[1], coeffs.shape[2]
    table = limb.one_like(spec, coeffs[:, :, :1])
    step = x_mont[:, :, None]  # x^size per point
    size = 1
    while size < n:
        table = torch.cat([table, limb.fmul(spec, table, step)], dim=2)
        if 2 * size < n:
            step = limb.fmul(spec, step, step)
        size *= 2
    return _tree_sum(spec, limb.fmul(spec, coeffs, table[:, :, :n]))


def kate_division(spec: FieldSpec, coeffs, b: int):
    """q(X) = (p(X) - p(b)) / (X - b) for canonical host scalar b != 0.

    Closed form (parallel, replaces the reference's sequential synthetic
    division, arithmetic.rs): q_i = b^{-(i+1)} * sum_{j>i} p_j b^j.  The
    suffix sums are a Hillis–Steele scan of ``fadd`` (log2 n steps) in place
    of the JAX package's ``associative_scan``.
    """
    assert b % spec.p != 0
    n = coeffs.shape[1]
    dev = coeffs.device
    pj_bj = limb.fmul(spec, coeffs, ntt_ops.power_table(spec, b, n, dev))
    suff = limb.prefix_add(spec, pj_bj, reverse=True)
    # S_i excludes j = i
    s_excl = torch.cat([suff[:, 1:], limb.zeros((1,), dev)], dim=1)
    binv = pow(b, -1, spec.p)
    binv_pow = ntt_ops.power_table(spec, binv, n + 1, dev)[:, 1:]  # b^{-(i+1)}
    # q has degree n-2; q[n-1] = 0 structurally
    return limb.fmul(spec, s_excl, binv_pow)


def lagrange_interpolate(spec: FieldSpec, points, evals):
    """Host-side Lagrange interpolation on canonical ints (small inputs only;
    reference arithmetic.rs:446-488). Returns coefficient list of len(points)."""
    p = spec.p
    n = len(points)
    assert len(set(points)) == n
    if n == 1:
        return [evals[0] % p]
    coeffs = [0] * n
    for i, (xi, yi) in enumerate(zip(points, evals)):
        # numerator poly prod_{j!=i} (X - x_j), denominator prod (x_i - x_j)
        num = [1]
        denom = 1
        for j, xj in enumerate(points):
            if j == i:
                continue
            new = [0] * (len(num) + 1)
            for d, c in enumerate(num):
                new[d] = (new[d] - c * xj) % p
                new[d + 1] = (new[d + 1] + c) % p
            num = new
            denom = denom * (xi - xj) % p
        scale = yi * pow(denom, -1, p) % p
        for d, c in enumerate(num):
            coeffs[d] = (coeffs[d] + c * scale) % p
    return coeffs
