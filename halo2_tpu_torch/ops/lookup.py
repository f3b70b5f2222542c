"""The lookup argument's multiset matching on limbs: the permuted columns.

The reference matches the compressed input and table columns on the host
(lookup/prover.rs:391-475), and so does the JAX package
(``plonk/prover.py::_permute_expression_pair``) over Python ints: the sorted
inputs; each distinct input value's first row holds that value in the table
column too, which uses up one table entry of it; the leftover table values,
ascending, fill the repeated rows from the last one up.  Here the columns
stay (16, n) Montgomery limb arrays on their device, and the result is the
same, limb for limb:

  1. keys: the first ``usable`` values of both columns in canonical form (a
     product by 1), each as four 64-bit words (``sort_keys``), so that the
     words' order is the order of the canonical ints;
  2. sort: both columns at once by an LSD pass of torch's stable sort per
     word (``sort_order``); the permuted input is the input column gathered
     in that order, which needs no conversion back to Montgomery form;
  3. match: ``lookup_match`` (``csrc/lookup.cu``, three launches on the card)
     flags each distinct input value's first row, finds its first entry in
     the sorted table by a lower bound on the 256-bit key and marks it used,
     raises a flag for a value the table lacks, lists the repeated rows and
     the unused table entries in ascending order, and writes the permuted
     columns.

``lookup_permute`` runs the three for tensors on the card; a tensor on the
CPU takes ``lookup_permute_plain``, the same steps as torch ops, with the
plain K1 product and ``lookup_match_plain``, which repeats the kernels'
binary search and scans.  Neither draws the blinding rows or reads the flag:
the prover does (``plonk/prover.py::permute_expression_pair_dev``).
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..fields import limb
from ..fields.mont_mul import mont_mul, mont_mul_plain
from ..fields.spec import NLIMBS, FieldSpec, int_to_limbs

KEY_WORDS = 4  # 64-bit words of a 256-bit key, word 3 the most significant
_LIMBS_PER_WORD = NLIMBS // KEY_WORDS
_BIAS = 1 << 15  # the top limb of each word is biased: signed int64 order = unsigned order


# ---------------------------------------------------------------------------
# 1-2. keys and their order (torch ops on either device)
# ---------------------------------------------------------------------------

def sort_keys(canon: torch.Tensor) -> torch.Tensor:
    """(16, m) canonical limbs -> (4, m) int64 words whose lexicographic
    order, word 3 first, is the order of the values.  Word w holds limbs
    4w..4w+3; its top limb is biased by -2^15, so that torch's signed
    comparison of the words agrees with the unsigned one of the limbs."""
    m = canon.shape[1]
    limbs = canon.to(torch.int64).reshape(KEY_WORDS, _LIMBS_PER_WORD, m)
    shift = torch.tensor([1 << (16 * j) for j in range(_LIMBS_PER_WORD)], dtype=torch.int64,
                         device=canon.device).reshape(1, _LIMBS_PER_WORD, 1)
    bias = torch.tensor([0] * (_LIMBS_PER_WORD - 1) + [_BIAS], dtype=torch.int64,
                        device=canon.device).reshape(1, _LIMBS_PER_WORD, 1)
    return ((limbs - bias) * shift).sum(dim=1)


def sort_order(keys: torch.Tensor) -> torch.Tensor:
    """(c, 4, u) int64 keys -> (c, u) int64 indices that sort each row
    ascending: a stable sort by word 0, then word 1, ..., word 3 (LSD), so
    equal keys keep their order."""
    idx = None
    for w in range(KEY_WORDS):
        word = keys[:, w] if idx is None else torch.gather(keys[:, w], 1, idx)
        order = torch.sort(word, dim=1, stable=True).indices
        idx = order if idx is None else torch.gather(idx, 1, order)
    return idx


def _sorted(spec: FieldSpec, comp_input, comp_table, usable: int, product):
    """(sorted keys (2, 4, u), their indices (2, u)) of the first ``usable``
    values of both columns; ``product`` is K1 or its plain version."""
    mont = torch.cat([comp_input[:, :usable], comp_table[:, :usable]], dim=1)
    canon = product(spec, mont, limb.const(int_to_limbs(1), 2, mont.device))
    keys = sort_keys(canon).reshape(KEY_WORDS, 2, usable).transpose(0, 1).contiguous()
    idx = sort_order(keys)
    return torch.gather(keys, 2, idx.unsqueeze(1).expand(2, KEY_WORDS, usable)), idx


# ---------------------------------------------------------------------------
# 3. the match: plain version
# ---------------------------------------------------------------------------

def _less(a, b):
    """a < b for (4, m) keys, word 3 first: (m,) bool."""
    lt = torch.zeros(a.shape[1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for w in reversed(range(KEY_WORDS)):
        lt |= eq & (a[w] < b[w])
        eq &= a[w] == b[w]
    return lt


def _lower_bound(table, keys):
    """For each key of (4, m), the first index of the sorted (4, u) table
    whose key is not below it (u if none): the kernel's binary search."""
    u = table.shape[1]
    lo = torch.zeros(keys.shape[1], dtype=torch.int64, device=keys.device)
    hi = torch.full_like(lo, u)
    for _ in range(u.bit_length()):
        mid = (lo + hi) // 2
        active = lo < hi
        below = _less(table[:, mid.clamp(max=max(u - 1, 0))], keys)
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def lookup_match_plain(skeys, idx, comp_input, comp_table):
    """The permuted columns' first u rows, written into (16, n) arrays, and
    a (1,) int32 flag, 1 where an input value is missing from the table.

    ``skeys`` (2, 4, u) are both columns' keys in sorted order, ``idx`` (2,
    u) their indices into ``comp_input`` / ``comp_table`` (16, n).  Where the
    flag is 1 the repeated rows are left partly unwritten."""
    u = idx.shape[1]
    n = comp_input.shape[1]
    kin, ktab = skeys[0], skeys[1]
    perm_input = torch.empty((NLIMBS, n), dtype=torch.int32, device=comp_input.device)
    perm_table = torch.empty_like(perm_input)
    first = torch.ones(u, dtype=torch.bool, device=kin.device)
    first[1:] = (kin[:, 1:] != kin[:, :-1]).any(dim=0)
    pos = _lower_bound(ktab, kin)
    found = (pos < u) & (ktab[:, pos.clamp(max=max(u - 1, 0))] == kin).all(dim=0)
    missing = (first & ~found).any().to(torch.int32).reshape(1)
    consumed = torch.zeros(u, dtype=torch.bool, device=kin.device)
    consumed[pos[first & found]] = True

    perm_input[:, :u] = comp_input[:, idx[0]]
    perm_table[:, :u] = perm_input[:, :u]
    rows = torch.nonzero(~first).flatten()  # the repeated rows, ascending
    left = torch.nonzero(~consumed).flatten()  # the unused table entries, ascending
    c = min(rows.numel(), left.numel())
    # the leftover values ascending, the repeated rows popped from the last
    perm_table[:, rows.flip(0)[:c]] = comp_table[:, idx[1][left[:c]]]
    return perm_input, perm_table, missing


# ---------------------------------------------------------------------------
# 3. the match: the kernels
# ---------------------------------------------------------------------------

def _check(what: str, t, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: all operands must lie on one CUDA device")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dtype} tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def lookup_match(skeys, idx, comp_input, comp_table):
    """``lookup_match_plain``'s result (the repeated rows alike where no
    value is missing): three launches of ``csrc/lookup.cu``, for CUDA
    tensors only (``lookup_permute`` sends CPU tensors to the plain
    version)."""
    u = idx.shape[1]
    n = comp_input.shape[1]
    _check("lookup_match", skeys, torch.int64, (2, KEY_WORDS, u))
    _check("lookup_match", idx, torch.int64, (2, u))
    _check("lookup_match", comp_input, torch.int32, (NLIMBS, n))
    _check("lookup_match", comp_table, torch.int32, (NLIMBS, n))
    if len({t.device for t in (skeys, idx, comp_input, comp_table)}) != 1:
        raise ValueError("lookup_match: all operands must lie on one CUDA device")
    if not 0 <= u <= n < 1 << 31:
        raise ValueError(f"lookup_match: needs 0 <= u <= n < 2^31, got u={u}, n={n}")
    dev = comp_input.device
    perm_input = torch.empty((NLIMBS, n), dtype=torch.int32, device=dev)
    perm_table = torch.empty_like(perm_input)
    flags = torch.empty(2 * u, dtype=torch.uint8, device=dev)  # first rows, used entries
    ranks = torch.empty(2 * u, dtype=torch.int32, device=dev)  # repeated rows, unused entries
    counts = torch.empty(3, dtype=torch.int32, device=dev)  # |rows|, |unused|, missing
    if u:
        with torch.cuda.device(dev):
            rc = _cuda.library().h2_lookup_match(
                skeys.data_ptr(), idx.data_ptr(), comp_input.data_ptr(), comp_table.data_ptr(),
                perm_input.data_ptr(), perm_table.data_ptr(), flags.data_ptr(),
                ranks.data_ptr(), counts.data_ptr(), u, n, _cuda.stream_ptr(comp_input))
        _cuda.check(rc, "lookup_match")
        lookup_match.launches += 3
    else:
        counts.zero_()
    return perm_input, perm_table, counts[2:]


lookup_match.launches = 0


# ---------------------------------------------------------------------------
# steps 1-3
# ---------------------------------------------------------------------------

def lookup_permute_plain(spec: FieldSpec, comp_input, comp_table, usable: int):
    """(perm_input, perm_table, missing flag): the permuted columns' first
    ``usable`` rows in (16, n) Montgomery limb arrays, from the plain K1
    product and ``lookup_match_plain``."""
    skeys, idx = _sorted(spec, comp_input, comp_table, usable, mont_mul_plain)
    return lookup_match_plain(skeys, idx, comp_input, comp_table)


def lookup_permute(spec: FieldSpec, comp_input, comp_table, usable: int):
    """``lookup_permute_plain``'s result: for CUDA tensors K1 makes the
    keys, torch's stable sort orders them and ``lookup_match`` launches."""
    if comp_input.device.type == "cpu":
        return lookup_permute_plain(spec, comp_input, comp_table, usable)
    comp_input, comp_table = comp_input.contiguous(), comp_table.contiguous()
    skeys, idx = _sorted(spec, comp_input, comp_table, usable, mont_mul)
    return lookup_match(skeys, idx, comp_input, comp_table)
