"""Vectorized multi-limb Montgomery field arithmetic in PyTorch.

Port of the JAX package's ``fields/limb.py``.  Field elements are 16
little-endian 16-bit limbs with the **limb axis leading**: n elements are a
``(16, n)`` tensor.  Limbs are stored as ``torch.int32`` (every limb is below
2^16); CPU torch has no uint32 ``+ - >>`` or comparisons.  Values are in
Montgomery form (v·R mod p, R = 2^256).

``fmul`` goes through the K1 wrapper (``fields/mont_mul.py``) and
``fpow_const``/``finv`` through its chain entry ``mont_pow``: the CUDA kernel
for tensors on the card, its plain torch version for tensors on the CPU.
``fadd``/``fsub``/``fneg`` are the reference's 16-step carry and borrow chains
as eager torch ops (about 130 launches each; see PERF.md).  Every intermediate
of those chains is kept non-negative (``a + 2^16 - b - borrow``), so a right
shift never meets a negative int and stays a logical shift.

Every function takes the :class:`FieldSpec` first; tensors carry their
device, and constructors take an explicit ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .mont_mul import mont_mul, mont_pow
from .spec import LIMB_BITS, LIMB_MASK, NLIMBS, FieldSpec, int_to_limbs

DTYPE = torch.int32
_BASE = 1 << LIMB_BITS


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def zeros(shape=(), device=None) -> torch.Tensor:
    return torch.zeros((NLIMBS,) + tuple(shape), dtype=DTYPE, device=device)


def const(limbs16, ndim: int, device) -> torch.Tensor:
    """(16,) host limb vector -> (16, 1, ...) tensor broadcastable to ndim dims."""
    t = torch.tensor(np.asarray(limbs16, dtype=np.int64), dtype=DTYPE, device=device)
    return t.reshape((NLIMBS,) + (1,) * (ndim - 1))


def from_int(spec: FieldSpec, v: int, device=None) -> torch.Tensor:
    """Canonical Python int -> Montgomery-form limb vector (16,)."""
    return torch.tensor(int_to_limbs(spec.to_mont(v)).astype(np.int32), device=device)


def ints_to_limbs_np(vs) -> np.ndarray:
    """Canonical ints -> (16, n) int32 canonical limbs, via one bytes round-trip."""
    buf = b"".join(v.to_bytes(32, "little") for v in vs)
    arr = np.frombuffer(buf, dtype=np.uint16).reshape(len(vs), NLIMBS)
    return np.ascontiguousarray(arr.T).astype(np.int32)


def limbs_np_to_ints(a) -> list:
    """(16, n) canonical limbs -> list of canonical ints (bytes round-trip)."""
    arr = np.ascontiguousarray(np.asarray(a).astype(np.uint16).T)  # (n, 16)
    raw = arr.tobytes()
    return [
        int.from_bytes(raw[32 * j : 32 * (j + 1)], "little") for j in range(arr.shape[0])
    ]


def from_ints(spec: FieldSpec, vs, device=None) -> torch.Tensor:
    """Iterable of canonical ints -> Montgomery limb array (16, n)."""
    return torch.from_numpy(ints_to_limbs_np([spec.to_mont(v) for v in vs])).to(device)


def to_ints(spec: FieldSpec, a: torch.Tensor) -> list:
    """Montgomery limb array (16, ...) -> list of canonical ints (flattened)."""
    arr = a.cpu().numpy().reshape(NLIMBS, -1)
    rinv = pow(spec.r, -1, spec.p)
    return [v * rinv % spec.p for v in limbs_np_to_ints(arr)]


def from_canonical_ints(spec: FieldSpec, vs, device=None) -> torch.Tensor:
    """Canonical ints -> Montgomery limbs via one device to_mont fmul."""
    return to_mont(spec, torch.from_numpy(ints_to_limbs_np(vs)).to(device))


# ---------------------------------------------------------------------------
# carry / borrow chains (16 steps over the limb axis)
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


def fadd(spec: FieldSpec, a, b):
    return cond_sub_p(spec, torch.stack(_carry_propagate(a + b)))


def fsub(spec: FieldSpec, a, b):
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


def fneg(spec: FieldSpec, a):
    """p - a, with 0 -> 0."""
    d = []
    borrow = None
    for pi, ai in zip(spec.p_limbs, a):
        t = (int(pi) + _BASE) - ai
        if borrow is not None:
            t = t - borrow
        d.append(t & LIMB_MASK)
        borrow = 1 - (t >> LIMB_BITS)
    return torch.where(is_zero(a).unsqueeze(0), torch.zeros_like(a), torch.stack(d))


def is_zero(a):
    return (a == 0).all(dim=0)


def select(cond, a, b):
    """Elementwise select between two limb arrays (cond broadcast over batch)."""
    return torch.where(cond.unsqueeze(0), a, b)


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------

def fmul(spec: FieldSpec, a, b):
    """Montgomery product a*b/R mod p (broadcasting), through K1."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    out = mont_mul(
        spec, a.reshape(NLIMBS, -1).contiguous(), b.reshape(NLIMBS, -1).contiguous()
    )
    return out.reshape(shape)


def fsquare(spec: FieldSpec, a):
    return fmul(spec, a, a)


def to_mont(spec: FieldSpec, a):
    """Canonical limbs -> Montgomery form (multiply by R^2)."""
    return fmul(spec, a, const(spec.r2_limbs, a.dim(), a.device))


def from_mont(spec: FieldSpec, a):
    """Montgomery form -> canonical limbs (REDC with 1)."""
    return fmul(spec, a, const(int_to_limbs(1), a.dim(), a.device))


def one_like(spec: FieldSpec, a):
    return const(spec.r_limbs, a.dim(), a.device).expand(a.shape)


# ---------------------------------------------------------------------------
# pow / inverse
# ---------------------------------------------------------------------------

def fpow_const(spec: FieldSpec, a, e: int):
    """a^e for a Python-int exponent, through K1's chain entry ``mont_pow``:
    one launch on the card, its plain loop on the CPU."""
    if e == 0:
        return one_like(spec, a).clone()
    shape = a.shape
    return mont_pow(spec, a.reshape(NLIMBS, -1).contiguous(), e).reshape(shape)


def finv(spec: FieldSpec, a):
    """Batched inverse via Fermat: a^(p-2).  Maps 0 -> 0."""
    return fpow_const(spec, a, spec.p - 2)


def _scan(op, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of an associative field op along axis 1 of (16, n, ...).

    Replaces ``jax.lax.associative_scan`` with a Hillis–Steele scan: log2(n)
    steps, each one batched ``op`` over the shifted array, instead of n
    sequential ops.
    """
    n = x.shape[1]
    shift = 1
    while shift < n:
        step = op(x[:, : n - shift], x[:, shift:])
        if reverse:  # x[i] <- x[i] op x[i + shift]
            x = torch.cat([step, x[:, n - shift :]], dim=1)
        else:  # x[i] <- x[i - shift] op x[i]
            x = torch.cat([x[:, :shift], step], dim=1)
        shift *= 2
    return x


def prefix_mul(spec: FieldSpec, a, reverse: bool = False):
    """Inclusive prefix (or suffix) products along axis 1."""
    return _scan(lambda x, y: fmul(spec, x, y), a, reverse)


def prefix_add(spec: FieldSpec, a, reverse: bool = False):
    """Inclusive prefix (or suffix) sums along axis 1."""
    return _scan(lambda x, y: fadd(spec, x, y), a, reverse)


def batch_inv(spec: FieldSpec, a):
    """Montgomery-trick batched inversion over axis 1 of a (16, n) array.

    Two log-depth scans of products plus one Fermat inversion of the total,
    instead of n inversions.  Requires all entries nonzero (reference
    batch_invert has the same contract, poly.rs:180-209).
    """
    n = a.shape[1]
    if n == 1:
        return finv(spec, a)
    prefix = prefix_mul(spec, a)
    suffix = prefix_mul(spec, a, reverse=True)
    total_inv = finv(spec, prefix[:, -1:])
    one = one_like(spec, a[:, :1])
    # inv_i = prefix_{i-1} * suffix_{i+1} * total_inv
    pre = torch.cat([one, prefix[:, :-1]], dim=1)
    suf = torch.cat([suffix[:, 1:], one], dim=1)
    return fmul(spec, fmul(spec, pre, suf), total_inv)
