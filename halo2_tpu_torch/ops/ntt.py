"""Six-step NTT over multi-limb field tensors.

Port of the six-step path of the JAX package's ``ops/ntt.py``.  The transform
computes the standard DFT out[i] = sum_j a[j] * omega^(i*j) of a (16, 2^k)
Montgomery limb tensor, as the reference's ``best_fft`` does
(arithmetic.rs:171-274).  With n = n1*n2:

    (16, n2, n1):  Stockham NTT of size n2 along axis 1   (batch n1)
    twiddle by W[i2, j1] = w^(i2*j1)                      (one elementwise mul)
    transpose -> (16, n1, n2)
    Stockham NTT of size n1 along axis 1                  (batch n2)
    reshape -> X[i1*n2 + i2]  (natural order, no bit-reversal)

Every Stockham stage is a contiguous half-split, one batched add, sub and
multiply (K1) and a concat: no gathers.  The JAX package puts an XLA:TPU
miscompile barrier after each stage; eager torch needs none.
"""

from __future__ import annotations

import torch

from ..fields import limb
from ..fields.spec import NLIMBS, FieldSpec


def bitrev_indices(k: int, device=None) -> torch.Tensor:
    """The bit-reversal permutation of 0 .. 2^k - 1 (int64 index tensor)."""
    idx = torch.arange(1 << k, device=device)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def power_table(spec: FieldSpec, base: int, n: int, device=None) -> torch.Tensor:
    """(16, n) Montgomery table of [1, base, base^2, ..., base^(n-1)].

    Doubling construction P_{2m} = [P_m, base^m * P_m]: log2(n) batched
    multiplies instead of n host multiplies.  ``base`` is a canonical int.
    """
    table = limb.from_int(spec, 1, device).reshape(NLIMBS, 1)
    step = base % spec.p
    while table.shape[1] < n:
        s = limb.from_int(spec, step, device).reshape(NLIMBS, 1)
        table = torch.cat([table, limb.fmul(spec, table, s)], dim=1)
        step = step * step % spec.p
    return table[:, :n]


def _stockham_axis1(spec: FieldSpec, x, tw, k: int):
    """Size-2^k DIF Stockham transform along axis 1 of (16, m, B); ``tw`` is
    the (16, m/2) table of the m-th root's powers.  Output in natural order."""
    m = 1 << k
    b = x.shape[2]
    x = x.reshape(NLIMBS, m, 1, b)
    for t in range(k):
        h = m >> (t + 1)
        a, c = x[:, :h], x[:, h:]
        u = limb.fadd(spec, a, c)
        w = tw[:, :: 1 << t][:, :h]  # (w^(2^t))^j for j < h
        v = limb.fmul(spec, limb.fsub(spec, a, c), w[:, :, None, None])
        x = torch.cat([u, v], dim=2)  # new output bit on the slow side
    return x.reshape(NLIMBS, m, b)


def ntt_sixstep(spec: FieldSpec, a, tw, w_cross, k: int):
    """DFT of a (16, 2^k) limb tensor via the six-step algorithm.

    ``tw``: (16, 2^(k-1)) powers of the length-n root w.  ``w_cross``: the
    (16, n2, n1) cross-twiddle table W[i2, j1] = w^(i2*j1) (:func:`cross_twiddles`).
    """
    n = 1 << k
    assert a.shape == (NLIMBS, n)
    k1 = k // 2
    k2 = k - k1
    n1, n2 = 1 << k1, 1 << k2
    # x[j], j = j1 + n1*j2  ->  view [j2][j1]
    x = a.reshape(NLIMBS, n2, n1)
    tw2 = tw[:, ::n1][:, : n2 // 2]  # powers of w^n1 (the n2-th root)
    x = _stockham_axis1(spec, x, tw2, k2)  # Y[i2, j1]
    x = limb.fmul(spec, x, w_cross)
    x = x.transpose(1, 2).contiguous()  # (16, n1, n2)
    tw1 = tw[:, ::n2][:, : n1 // 2]  # powers of w^n2 (the n1-th root)
    x = _stockham_axis1(spec, x, tw1, k1)  # D[i1, i2]
    return x.reshape(NLIMBS, n)  # X[i1*n2 + i2]


def intt_sixstep(spec: FieldSpec, a, inv_tw, inv_cross, k: int, n_inv_mont):
    """Inverse DFT on the six-step path (forward with omega^-1, scaled)."""
    out = ntt_sixstep(spec, a, inv_tw, inv_cross, k)
    return limb.fmul(spec, out, n_inv_mont.reshape(NLIMBS, 1))


def cross_twiddles(spec: FieldSpec, omega: int, k: int, device=None) -> torch.Tensor:
    """(16, n2, n1) Montgomery table W[i2, j1] = omega^(i2*j1) for the six-step
    transform (host-built once per domain, cached by the caller)."""
    k1 = k // 2
    n1, n2 = 1 << k1, 1 << (k - k1)
    p = spec.p
    flat = []
    for i2 in range(n2):
        step = pow(omega, i2, p)  # row i2: geometric sequence with this ratio
        v = 1
        for _ in range(n1):
            flat.append(spec.to_mont(v))
            v = v * step % p
    return torch.from_numpy(limb.ints_to_limbs_np(flat)).reshape(NLIMBS, n2, n1).to(device)


def distribute_powers(spec: FieldSpec, a, table):
    """Elementwise a[i] *= table[i] (generic coset power distribution)."""
    return limb.fmul(spec, a, table)
