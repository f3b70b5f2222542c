"""K1 and K4: elementwise Montgomery products on (16, n) int32 limb arrays.

``mont_mul`` is the wrapper of the CUDA kernel ``csrc/mont_mul.cu``, which
replaces the JAX package's Pallas kernel ``fields/pallas_kernels.py``
``mont_mul_rows`` (body ``fields/vreg.py`` ``vmul``).  A tensor on the CPU
takes ``mont_mul_plain``, the same 16-bit schoolbook product and word-by-word
REDC written as torch ops in int64; a CUDA tensor launches the kernel or
raises.  Both return the unique a*b*2^-256 mod p in [0, p) for inputs in
[0, p), so they agree limb for limb.

``mont_pow`` is K1's chain entry, the kernel ``mont_pow_kernel`` of the same
source: a^e for one exponent, square-and-multiply in registers, one launch
for the whole chain (the Fermat inversion a^(p-2) of ``limb.finv`` is its main
caller).  Its plain version ``mont_pow_plain`` is the same chain as a loop of
``mont_mul_plain``; both agree limb for limb with a loop of K1 launches.

``mont_mul_tiled`` is the wrapper of K4, ``csrc/mont_mul_tiled.cu``, which
replaces the lane-tiled Pallas kernel ``mont_mul_pallas`` (body
``_mont_mul_block``) with the TPU's own 16-bit algorithm; its plain version
is ``mont_mul_plain`` too.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .spec import LIMB_BITS, LIMB_MASK, NLIMBS, FieldSpec


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product in plain torch ops (int64), any device.

    Columns accumulate without carrying: a column of the 16x16 product sums
    16 products below 2^32, and REDC adds at most 16 more plus carries, so
    every column stays below 2^38 and ``t * n0`` below 2^54 — inside int64.
    Every value is non-negative, so ``>>`` is a logical shift here.
    """
    prods = a.to(torch.int64).unsqueeze(1) * b.to(torch.int64).unsqueeze(0)  # (16, 16, ...)
    # column sums of the schoolbook: row i of prods lands shifted by i (a
    # strided view of buf with buf[i, i + j] = prods[i, j]), then one sum
    buf = torch.zeros(
        (NLIMBS, 2 * NLIMBS + 1) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device
    )
    s0, s1 = buf.stride(0), buf.stride(1)
    buf.as_strided(prods.shape, (s0 + s1, s1) + buf.stride()[2:]).copy_(prods)
    t = buf.sum(dim=0)  # (33, ...)
    p_col = torch.tensor(
        [int(x) for x in spec.p_limbs], dtype=torch.int64, device=a.device
    ).reshape((NLIMBS,) + (1,) * (a.dim() - 1))
    n0 = spec.n0
    for i in range(NLIMBS):
        m = (t[i] * n0) & LIMB_MASK
        t[i : i + NLIMBS] += m * p_col
        # the low 16 bits of t[i] are now zero: the shift is an exact carry
        t[i + 1] += t[i] >> LIMB_BITS
    out = []
    carry = None
    for d in t[NLIMBS : 2 * NLIMBS]:
        v = d if carry is None else d + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    # the value is below 2p < 2^256, so the final carry is zero
    from .limb import cond_sub_p

    return cond_sub_p(spec, torch.stack(out).to(torch.int32))


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of two (16, n) int32 limb arrays (K1 wrapper)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    n = _cuda.check_operands("mont_mul", a, b)
    out = torch.empty_like(a)
    if n == 0:
        return out
    lib = _cuda.library()
    words, n0 = _cuda.modulus_args(spec)
    with torch.cuda.device(a.device):
        rc = lib.h2_mont_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, words, n0, _cuda.stream_ptr(a)
        )
    _cuda.check(rc, "mont_mul")
    mont_mul.launches += 1
    return out


mont_mul.launches = 0


def _check_exponent(e: int) -> None:
    if not 0 < e < 1 << 256:
        raise ValueError(f"mont_pow: the exponent must lie in [1, 2^256), got {e}")


def mont_pow_plain(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a (16, n) Montgomery array, square-and-multiply over the bits
    of e, low bit first, as a loop of ``mont_mul_plain``: a zero bit costs no
    product.  0 maps to 0."""
    _check_exponent(e)
    acc = None
    base = a
    while e:
        if e & 1:
            acc = base if acc is None else mont_mul_plain(spec, acc, base)
        e >>= 1
        if e:
            base = mont_mul_plain(spec, base, base)
    return acc


def mont_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a (16, n) int32 Montgomery array and an exponent in [1, 2^256)
    (K1's chain entry): one launch for the whole chain."""
    _check_exponent(e)
    if a.device.type == "cpu":
        return mont_pow_plain(spec, a, e)
    n = _cuda.check_operands("mont_pow", a)
    out = torch.empty_like(a)
    if n == 0:
        return out
    lib = _cuda.library()
    words, n0 = _cuda.modulus_args(spec)
    e_words = _cuda.words_arg(e)
    with torch.cuda.device(a.device):
        rc = lib.h2_mont_pow(
            a.data_ptr(), out.data_ptr(), n, words, n0, e_words, e.bit_length(),
            _cuda.stream_ptr(a),
        )
    _cuda.check(rc, "mont_pow")
    mont_pow.launches += 1
    return out


mont_pow.launches = 0


def mont_mul_tiled(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of two (16, n) int32 limb arrays (K4 wrapper).

    The kernel computes the JAX package's ``_mont_mul_block`` algorithm:
    16-bit schoolbook with lo/hi halves, word-by-word REDC, conditional
    subtract, in (16, 512) column tiles with the ragged last tile masked.
    Its plain version is ``mont_mul_plain``, which computes that algorithm
    in int64; a tensor on the CPU takes it.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    n = _cuda.check_operands("mont_mul_tiled", a, b)
    out = torch.empty_like(a)
    if n == 0:
        return out
    lib = _cuda.library()
    limbs, n0 = _cuda.modulus16_args(spec)
    with torch.cuda.device(a.device):
        rc = lib.h2_mont_mul_tiled(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, limbs, n0, _cuda.stream_ptr(a)
        )
    _cuda.check(rc, "mont_mul_tiled")
    mont_mul_tiled.launches += 1
    return out


mont_mul_tiled.launches = 0
