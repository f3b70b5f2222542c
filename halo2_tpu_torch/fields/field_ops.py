"""K1's field entries: a + b, a - b and p - a on (16, n) int32 limb arrays.

``field_add``, ``field_sub`` and ``field_neg`` wrap the CUDA kernel
``csrc/field_ops.cu``, one launch a call, where the JAX package jits each of
``fields/limb.py`` ``fadd`` / ``fsub`` / ``fneg`` into one fused XLA program
beside its Pallas product ``mont_mul_rows``.  A tensor on the CPU takes the
plain version (``field_add_plain``, ...): the 16-step carry and borrow chains
as eager torch ops, which the port ran on the card before (134, 165 and 86
launches a call).  Every intermediate of those chains is kept non-negative
(``a + 2^16 - b - borrow``), so a right shift never meets a negative int and
stays a logical shift; CPU torch has no uint32 ``+ - >>``.  Both return the
unique value in [0, p) for inputs in [0, p), so they agree limb for limb.

A wrapper's operands are (16, n) and contiguous, or (16, 1): one element
(a challenge or a constant), which the kernel reads with element stride 0
instead of an expanded copy.  ``flat_operands`` brings any broadcastable
limb tensors to that form, for ``limb.fadd`` / ``fsub`` / ``fneg`` / ``fmul``.
"""

from __future__ import annotations

import math

import torch

from .. import _cuda
from .spec import LIMB_BITS, LIMB_MASK, NLIMBS, FieldSpec

_BASE = 1 << LIMB_BITS
_ADD, _SUB, _NEG = 0, 1, 2


# ---------------------------------------------------------------------------
# plain versions: carry / borrow chains (16 steps over the limb axis)
# ---------------------------------------------------------------------------

def _carry_propagate(digits):
    """Normalize a list of digits (< 2^31) to 16-bit digits; drops the carry."""
    out = []
    carry = None
    for d in digits:
        v = d if carry is None else d + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return out


def cond_sub_p(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Reduce a (16, ...) value in [0, 2p) to [0, p) branch-free."""
    diff = []
    borrow = None
    for ai, pi in zip(a, spec.p_limbs):
        t = ai + (_BASE - int(pi))
        if borrow is not None:
            t = t - borrow
        diff.append(t & LIMB_MASK)
        borrow = 1 - (t >> LIMB_BITS)
    # borrow == 1  =>  a < p  =>  keep a
    return torch.where(borrow.bool().unsqueeze(0), a, torch.stack(diff))


def field_add_plain(spec: FieldSpec, a, b):
    return cond_sub_p(spec, torch.stack(_carry_propagate(a + b)))


def field_sub_plain(spec: FieldSpec, a, b):
    a, b = torch.broadcast_tensors(a, b)
    d = []
    borrow = None
    for ai, bi in zip(a, b):
        t = ai + _BASE - bi
        if borrow is not None:
            t = t - borrow
        d.append(t & LIMB_MASK)
        borrow = 1 - (t >> LIMB_BITS)
    # a - b + p where it underflowed
    dp = _carry_propagate([x + int(pi) for x, pi in zip(d, spec.p_limbs)])
    return torch.where(borrow.bool().unsqueeze(0), torch.stack(dp), torch.stack(d))


def field_neg_plain(spec: FieldSpec, a):
    """p - a, with 0 -> 0."""
    d = []
    borrow = None
    for pi, ai in zip(spec.p_limbs, a):
        t = (int(pi) + _BASE) - ai
        if borrow is not None:
            t = t - borrow
        d.append(t & LIMB_MASK)
        borrow = 1 - (t >> LIMB_BITS)
    return torch.where((a == 0).all(dim=0).unsqueeze(0), torch.zeros_like(a), torch.stack(d))


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def flat_operands(*operands):
    """([each operand as (16, n) or (16, 1)], the broadcast result shape).

    An operand of one element keeps its storage as a (16, 1) view; any other
    is broadcast to the result's shape and made a contiguous (16, n) array.
    """
    shape = torch.broadcast_shapes(*(t.shape for t in operands))
    n = math.prod(shape[1:])
    flat = []
    for t in operands:
        if t.numel() == NLIMBS and n != 0:
            flat.append(t.reshape(NLIMBS, 1))
        else:
            flat.append(t.expand(shape).reshape(NLIMBS, n).contiguous())
    return flat, shape


def check_dtype(what: str, tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: operands must be int32 limbs, got {t.dtype}")


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def strided_operands(what: str, *tensors) -> tuple:
    """Checks (16, n) / (16, 1) CUDA operands; (n, [(tensor, limb stride,
    element stride)]): a (16, 1) operand is read with element stride 0."""
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{what}: all operands must lie on one CUDA device")
        if t.dim() != 2 or t.shape[0] != NLIMBS:
            raise ValueError(f"{what}: operands must be (16, n) or (16, 1), got {tuple(t.shape)}")
    lens = {t.shape[1] for t in tensors} - {1}
    if len(lens) > 1:
        raise ValueError(f"{what}: operand shapes {[tuple(t.shape) for t in tensors]} differ")
    n = lens.pop() if lens else 1
    out = []
    for t in tensors:
        if t.shape[1] == 1:
            out.append((t, t.stride(0), 0))
        elif not t.is_contiguous():
            raise ValueError(f"{what}: a (16, n) operand must be contiguous")
        else:
            out.append((t, n, 1))
    return n, out


def _launch(what: str, op: int, spec: FieldSpec, a, b):
    n, ((a, a_ls, a_es), (b, b_ls, b_es)) = strided_operands(what, a, b)
    out = torch.empty((NLIMBS, n), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    lib = _cuda.library()
    words, n0 = _cuda.modulus_args(spec)
    with torch.cuda.device(a.device):
        rc = lib.h2_field_op(op, a.data_ptr(), a_ls, a_es, b.data_ptr(), b_ls, b_es,
                             out.data_ptr(), n, words, n0, _cuda.stream_ptr(a))
    _cuda.check(rc, what)
    return out


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def field_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p for (16, n) / (16, 1) int32 limb arrays: one launch."""
    check_dtype("field_add", (a, b))
    if _on_cpu((a, b)):
        return field_add_plain(spec, a, b)
    out = _launch("field_add", _ADD, spec, a, b)
    if out.shape[1]:
        field_add.launches += 1
    return out


def field_sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p for (16, n) / (16, 1) int32 limb arrays: one launch."""
    check_dtype("field_sub", (a, b))
    if _on_cpu((a, b)):
        return field_sub_plain(spec, a, b)
    out = _launch("field_sub", _SUB, spec, a, b)
    if out.shape[1]:
        field_sub.launches += 1
    return out


def field_neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """p - a (0 -> 0) for a (16, n) int32 limb array: one launch."""
    check_dtype("field_neg", (a,))
    if _on_cpu((a,)):
        return field_neg_plain(spec, a)
    out = _launch("field_neg", _NEG, spec, a, a)
    if out.shape[1]:
        field_neg.launches += 1
    return out


field_add.launches = 0
field_sub.launches = 0
field_neg.launches = 0
