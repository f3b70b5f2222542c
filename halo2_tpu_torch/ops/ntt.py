"""NTTs over multi-limb field tensors: six-step and radix-2 butterfly.

Port of the JAX package's ``ops/ntt.py``: the six-step path, which the
domain's transforms take, the butterfly ``ntt`` / ``intt``, which the bench
times as the JAX bench does, and its batched form ``ntt_batched``, which the
four-step multi-device transform (``parallel/ntt.py``) runs on each shard.
The six-step transform computes the standard DFT out[i] = sum_j a[j] * omega^(i*j) of a (16, 2^k)
Montgomery limb tensor, as the reference's ``best_fft`` does
(arithmetic.rs:171-274).  With n = n1*n2:

    (16, n2, n1):  Stockham NTT of size n2 along axis 1   (batch n1)
    twiddle by W[i2, j1] = w^(i2*j1)                      (one elementwise mul)
    transpose -> (16, n1, n2)
    Stockham NTT of size n1 along axis 1                  (batch n2)
    reshape -> X[i1*n2 + i2]  (natural order, no bit-reversal)

Each Stockham pass is one launch of K1's transform entry ``stockham_axis``
(``csrc/ntt.cu``), which runs every stage in shared memory; its plain version
``stockham_axis_plain`` is the JAX package's stage loop, each stage a
contiguous half-split, one batched add, sub and multiply and a concat.  The
JAX package puts an XLA:TPU miscompile barrier after each stage; eager torch
needs none.
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..fields import limb
from ..fields.field_ops import check_dtype, field_add_plain, field_sub_plain
from ..fields.mont_mul import mont_mul_plain
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


def ntt_batched(spec: FieldSpec, a, twiddles, k: int):
    """DFT along the last axis of a (16, ..., 2^k) limb tensor by the radix-2
    butterfly network.

    The JAX package's ``ntt_batched``: bit-reverse the last axis, then k
    decimation-in-time stages.  Stage s pairs positions lo and lo + 2^(s-1)
    inside each block of 2^s and multiplies the upper one by the twiddle
    ``twiddles[off << (k - s)]`` (K1); ``twiddles`` is the (16, 2^(k-1))
    table of powers of the generator (:func:`power_table`).  A block's pairs
    are a reshape here, where the JAX package gathers them.
    """
    n = 1 << k
    assert a.shape[0] == NLIMBS and a.shape[-1] == n
    if k == 0:
        return a
    batch = a.shape[1:-1]
    x = a[..., bitrev_indices(k, a.device)]
    for s in range(1, k + 1):
        h = 1 << (s - 1)
        x = x.reshape((NLIMBS,) + batch + (n >> s, 2, h))
        u, v = x[..., 0, :], x[..., 1, :]
        tw = twiddles[:, :: 1 << (k - s)][:, :h]
        t = limb.fmul(spec, v, tw.reshape((NLIMBS,) + (1,) * (len(batch) + 1) + (h,)))
        x = torch.stack([limb.fadd(spec, u, t), limb.fsub(spec, u, t)], dim=-2)
    return x.reshape(a.shape)


def ntt(spec: FieldSpec, a, twiddles, k: int):
    """DFT of a (16, 2^k) limb tensor: :func:`ntt_batched` without a batch."""
    assert a.shape == (NLIMBS, 1 << k)
    return ntt_batched(spec, a, twiddles, k)


def intt(spec: FieldSpec, a, inv_twiddles, k: int, n_inv_mont):
    """Inverse DFT: :func:`ntt` with omega^-1, scaled by 1/2^k
    (EvaluationDomain::ifft, poly/domain.rs:355-362)."""
    return limb.fmul(spec, ntt(spec, a, inv_twiddles, k), n_inv_mont.reshape(NLIMBS, 1))


MAX_STAGES = 11  # stages one stockham_axis launch runs (csrc/ntt.cu kMaxStages)


def stockham_axis_plain(spec: FieldSpec, x, tw, k: int):
    """Size-2^k DIF Stockham transform along axis 1 of (16, m, B); ``tw`` is
    the (16, m/2) table of the m-th root's powers.  Output in natural order.

    Stage by stage: a half-split, one add, sub and multiply and a concat, on
    the plain chains and ``mont_mul_plain``, never on K1's kernels."""
    m = 1 << k
    b = x.shape[2]
    x = x.reshape(NLIMBS, m, 1, b)
    for t in range(k):
        h = m >> (t + 1)
        a, c = x[:, :h], x[:, h:]
        u = field_add_plain(spec, a, c)
        w = tw[:, :: 1 << t][:, :h]  # (w^(2^t))^j for j < h
        v = mont_mul_plain(spec, field_sub_plain(spec, a, c), w[:, :, None, None])
        x = torch.cat([u, v], dim=2)  # new output bit on the slow side
    return x.reshape(NLIMBS, m, b)


def stockham_axis(spec: FieldSpec, x, tw, k: int):
    """:func:`stockham_axis_plain` as K1's transform entry (``csrc/ntt.cu``):
    every stage in one launch, or one launch per ``MAX_STAGES`` stages for an
    axis longer than 2^MAX_STAGES.  ``x`` (16, 2^k, B) and ``tw`` (16, 2^(k-1))
    contiguous int32; a tensor on the CPU takes the plain version."""
    check_dtype("stockham_axis", (x, tw))
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return stockham_axis_plain(spec, x, tw, k)
    m = 1 << k
    for t in (x, tw):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("stockham_axis: x and tw must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("stockham_axis: x and tw must be contiguous")
    if x.dim() != 3 or x.shape[:2] != (NLIMBS, m) or tw.shape != (NLIMBS, m // 2):
        raise ValueError(f"stockham_axis: x {tuple(x.shape)} and tw {tuple(tw.shape)} are not "
                         f"(16, {m}, B) and (16, {m // 2})")
    if x.numel() == 0:
        return torch.empty_like(x)
    lib = _cuda.library()
    words, n0 = _cuda.modulus_args(spec)
    passes = [(t0, min(MAX_STAGES, k - t0)) for t0 in range(0, max(k, 1), MAX_STAGES)]
    src = x
    for t0, stages in passes:
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            rc = lib.h2_stockham(src.data_ptr(), out.data_ptr(), tw.data_ptr(), m, x.shape[2],
                                 t0, stages, words, n0, _cuda.stream_ptr(x))
        _cuda.check(rc, "stockham_axis")
        stockham_axis.launches += 1
        src = out
    return out


stockham_axis.launches = 0


def sixstep_twiddles(tw, k: int) -> tuple:
    """The six-step's two axis tables, contiguous, from the (16, 2^(k-1))
    table ``tw`` of w's powers: (powers of w^n1, the n2-th root; powers of
    w^n2, the n1-th root)."""
    k1 = k // 2
    n1, n2 = 1 << k1, 1 << (k - k1)
    return tw[:, ::n1][:, : n2 // 2].contiguous(), tw[:, ::n2][:, : n1 // 2].contiguous()


def ntt_sixstep(spec: FieldSpec, a, tw, w_cross, k: int, axis_tw=None):
    """DFT of a (16, 2^k) limb tensor via the six-step algorithm.

    ``tw``: (16, 2^(k-1)) powers of the length-n root w.  ``w_cross``: the
    (16, n2, n1) cross-twiddle table W[i2, j1] = w^(i2*j1) (:func:`cross_twiddles`).
    ``axis_tw``: :func:`sixstep_twiddles` of ``tw``, where the caller caches it.
    """
    n = 1 << k
    assert a.shape == (NLIMBS, n)
    k1 = k // 2
    k2 = k - k1
    n1, n2 = 1 << k1, 1 << k2
    tw2, tw1 = sixstep_twiddles(tw, k) if axis_tw is None else axis_tw
    # x[j], j = j1 + n1*j2  ->  view [j2][j1]
    x = a.reshape(NLIMBS, n2, n1).contiguous()
    x = stockham_axis(spec, x, tw2, k2)  # Y[i2, j1]
    x = limb.fmul(spec, x, w_cross)
    x = x.transpose(1, 2).contiguous()  # (16, n1, n2)
    x = stockham_axis(spec, x, tw1, k1)  # D[i1, i2]
    return x.reshape(NLIMBS, n)  # X[i1*n2 + i2]


def intt_sixstep(spec: FieldSpec, a, inv_tw, inv_cross, k: int, n_inv_mont, axis_tw=None):
    """Inverse DFT on the six-step path (forward with omega^-1, scaled)."""
    out = ntt_sixstep(spec, a, inv_tw, inv_cross, k, axis_tw)
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
