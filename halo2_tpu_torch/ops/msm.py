"""Multi-scalar multiplication: signed-digit Straus windows.

Port of the JAX package's ``ops/msm.py`` (itself the replacement for the
reference ``best_multiexp``, arithmetic.rs:16-159), on the flat (16, n)
layout without the TPU's 128-lane rows.  ``msm_many`` runs four entries,
each one hand-written CUDA launch on the card (``csrc/msm.cu``, and
``csrc/ec.cu`` for the last):

  1. ``msm_digits``: scalars Montgomery -> canonical (a product by 1) ->
     signed c-bit digits d in [-2^(c-1), 2^(c-1)], (m, W, npad) int16, 0 for
     the padding points i >= n
  2. ``ec_window_table``: T_j = j*P_i for j = 0..2^(c-1), one double then
     adds, point-major records of the card's own layout (the plain version
     keeps the (16, h+1, n) limb arrays; ``table_unpack`` maps the records
     to them)
  3. ``ec_window_fold``: every window of every column picks T_|d| (y
     negated where d < 0, the identity for i >= n) and tree-sums over the
     points, in the order of the pairwise halving fold ``_fold_points``:
     one launch per log2(block) levels, 1-3 in all
  4. window combination by Horner over the windows, all columns in
     parallel: K3's chain entry ``ec_horner``, (W-1)c doublings and W-1 adds
     per column in one thread's registers

Each entry has a launch counter and a plain torch version beside it, which a
CPU tensor takes: the eager steps the kernels replaced (K1's product, the
Booth recode, ``_build_table``, the gather-select, ``limb.fneg`` and
``_fold_points`` over the plain EC formulas).  Kernel and plain outputs are
equal limb for limb, projective coordinates included; a CUDA tensor launches
the kernel or raises.

Work: (W + 2^(c-1) - 1) * n complete adds.  The result is the same group
element as any other MSM algorithm, so callers compare it in affine form
(``curves.point.to_affine_ints``).
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..curves import ec_kernels
from ..curves.ec_kernels import ec_add_plain, ec_double_plain
from ..curves.point import Point
from ..curves.spec import CurveSpec
from ..fields import limb
from ..fields.mont_mul import mont_mul_plain
from ..fields.spec import LIMB_BITS, NLIMBS, int_to_limbs

FOLD_BLOCK = 128  # threads of an ec_window_fold block: kFoldThreads in csrc/msm.cu
RECORD = 3 * NLIMBS // 2  # 32-bit words of one table record: x, y, z


def padded(n: int) -> int:
    """npad: n rounded up to a power of two (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def num_windows(c: int) -> int:
    """W for c-bit windows over 256-bit scalars, with one more window where
    the final carry of the recode needs it (c * ceil(256/c) < 257)."""
    w = (256 + c - 1) // c
    return w + 1 if c * w < 257 else w


def _extract_digits(scalars, c: int):
    """Canonical (16, N) limbs -> (ceil(256/c), N) int32 c-bit digits."""
    mask = (1 << c) - 1
    outs = []
    for w in range((256 + c - 1) // c):
        bit = w * c
        l0, off = bit // LIMB_BITS, bit % LIMB_BITS
        d = scalars[l0] >> off
        if off + c > LIMB_BITS and l0 + 1 < NLIMBS:
            d = d | (scalars[l0 + 1] << (LIMB_BITS - off))
        outs.append(d & mask)
    return torch.stack(outs)


def _signed_digits(scalars_canon, c: int):
    """(16, N) canonical limbs -> (W, N) int32 digits in [-2^(c-1), 2^(c-1)].

    Booth-style recode: a digit d >= 2^(c-1) becomes d - 2^c with a carry of
    1 into the next window.  Scalars are < 2^255 < 2^(cW-1), so the top
    window absorbs the final carry unrecoded.
    """
    raw = _extract_digits(scalars_canon, c)
    h = 1 << (c - 1)
    num = num_windows(c)
    outs = []
    carry = torch.zeros_like(raw[0])
    for w in range(num):
        t = raw[w] + carry if w < raw.shape[0] else carry
        if w == num - 1:
            outs.append(t)
            break
        ge = t >= h
        outs.append(torch.where(ge, t - (1 << c), t))
        carry = ge.to(t.dtype)
    return torch.stack(outs)


def _check(what: str, t, dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: all operands must lie on one CUDA device")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{what}: expected a {ndim}-d {dtype} tensor, got {t.dim()}-d {t.dtype}")


def _unit_stride(t):
    """t if its last axis is unit-stride (the kernels take the other strides),
    else a contiguous copy."""
    return t if t.stride(-1) == 1 or t.shape[-1] <= 1 else t.contiguous()


# ---------------------------------------------------------------------------
# 1. digits
# ---------------------------------------------------------------------------

def msm_digits_plain(curve: CurveSpec, scalars_mont, c: int):
    """(m, 16, n) Montgomery scalars -> (m, W, npad) int16 signed digits,
    digit 0 for the padding points (1 <= c <= 15: the digits fit in int16)."""
    if not 1 <= c <= 15:
        raise ValueError(f"msm_digits: int16 digits need 1 <= c <= 15, got {c}")
    m, _, n = scalars_mont.shape
    flat = scalars_mont.transpose(0, 1).reshape(NLIMBS, m * n)
    one = limb.const(int_to_limbs(1), 2, flat.device).expand_as(flat)
    digits = _signed_digits(mont_mul_plain(curve.scalar, flat, one), c)  # (W, m * n)
    digits = digits.reshape(-1, m, n).transpose(0, 1)
    return torch.nn.functional.pad(digits, (0, padded(n) - n)).to(torch.int16).contiguous()


def msm_digits(curve: CurveSpec, scalars_mont, c: int):
    """``msm_digits_plain``'s digits: one launch of ``msm_digits_kernel``
    (1 <= c <= 8) for a CUDA tensor."""
    if scalars_mont.device.type == "cpu":
        return msm_digits_plain(curve, scalars_mont, c)
    if not 1 <= c <= 8:
        raise ValueError(f"msm_digits: the kernel takes 1 <= c <= 8, got {c}")
    _check("msm_digits", scalars_mont, torch.int32, 3)
    s = _unit_stride(scalars_mont)
    m, nl, n = s.shape
    if nl != NLIMBS:
        raise ValueError(f"msm_digits: scalars must be (m, 16, n), got {tuple(s.shape)}")
    npad, w = padded(n), num_windows(c)
    out = torch.empty((m, w, npad), dtype=torch.int16, device=s.device)
    if m == 0:
        return out
    lib = _cuda.library()
    words, n0 = _cuda.modulus_args(curve.scalar)
    with torch.cuda.device(s.device):
        rc = lib.h2_msm_digits(s.data_ptr(), out.data_ptr(), m, n, npad, s.stride(0),
                               s.stride(1), c, w, words, n0, _cuda.stream_ptr(s))
    _cuda.check(rc, "msm_digits")
    msm_digits.launches += 1
    return out


msm_digits.launches = 0


# ---------------------------------------------------------------------------
# 2. window table
# ---------------------------------------------------------------------------

def table_unpack(table):
    """The card's (n, h+1, 24) int32 table records -> ``ec_window_table_plain``'s
    (x, y, z), each (16, h+1, n) limbs.  A record is x, y, z as 8
    little-endian 32-bit words each, limbs 2j and 2j+1 in word j."""
    n, h1, _ = table.shape
    words = table.reshape(n, h1, 3, NLIMBS // 2).to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([words & 0xFFFF, words >> LIMB_BITS], dim=-1).reshape(n, h1, 3, NLIMBS)
    return tuple(limbs[:, :, ci].permute(2, 1, 0).to(torch.int32).contiguous() for ci in range(3))


def _identity_columns(curve: CurveSpec, like, count: int):
    """(x, y, z) of ``count`` identity points (0, R, 0) beside ``like``'s
    leading axes."""
    shape = like.shape[:-1] + (count,)
    one = limb.const(curve.base.r_limbs, len(shape), like.device).expand(shape)
    zero = torch.zeros(shape, dtype=like.dtype, device=like.device)
    return zero, one, zero


def ec_window_table_plain(curve: CurveSpec, points, c: int):
    """[T_0 .. T_h], T_j = j * P for h = 2^(c-1): T_0 the identity, T_1 = P,
    T_2 = 2P, T_j = T_(j-1) + P, as (x, y, z), each (16, h+1, n) limbs."""
    pts = tuple(points)
    h = 1 << (c - 1)
    table = [_identity_columns(curve, pts[0], pts[0].shape[-1]), pts]
    if h >= 2:
        table.append(ec_double_plain(curve, pts))
    for _ in range(3, h + 1):
        table.append(ec_add_plain(curve, table[-1], pts))
    return tuple(torch.stack([t[ci] for t in table], dim=1) for ci in range(3))


def ec_window_table(curve: CurveSpec, points, c: int):
    """``ec_window_table_plain``'s table for CPU tensors; for CUDA tensors one
    launch of ``ec_window_table_kernel``, one thread per point, into (n, h+1,
    24) records that ``table_unpack`` turns into the plain table."""
    coords = tuple(points)
    if all(t.device.type == "cpu" for t in coords):
        return ec_window_table_plain(curve, points, c)
    if not 1 <= c <= 8:
        raise ValueError(f"ec_window_table: the kernel takes 1 <= c <= 8, got {c}")
    for t in coords:
        _check("ec_window_table", t, torch.int32, 2)
        if t.shape != coords[0].shape or t.shape[0] != NLIMBS or t.device != coords[0].device:
            raise ValueError("ec_window_table: coordinates must share one (16, n) shape and device")
    coords = tuple(_unit_stride(t) for t in coords)
    if len({t.stride(0) for t in coords}) > 1:
        coords = tuple(t.contiguous() for t in coords)
    n, ld, h = coords[0].shape[1], coords[0].stride(0), 1 << (c - 1)
    out = torch.empty((n, h + 1, RECORD), dtype=torch.int32, device=coords[0].device)
    if n == 0:
        return out
    lib = _cuda.library()
    words, n0, b3, one = ec_kernels.launch_args(curve)
    with torch.cuda.device(out.device):
        rc = lib.h2_ec_window_table(*[t.data_ptr() for t in coords], out.data_ptr(), n, ld, h,
                                    words, n0, b3, one, _cuda.stream_ptr(out))
    _cuda.check(rc, "ec_window_table")
    ec_window_table.launches += 1
    return out


ec_window_table.launches = 0


# ---------------------------------------------------------------------------
# 3. window fold
# ---------------------------------------------------------------------------

def _fold_points(curve: CurveSpec, pts: Point) -> Point:
    """Tree-sum a (16, ..., n) point batch over its last axis (n a power of
    two): level by level, element i plus element i + n/2, on the plain
    EC formulas."""
    while pts.x.shape[-1] > 1:
        half = pts.x.shape[-1] // 2
        pts = Point(*ec_add_plain(
            curve,
            tuple(c[..., :half].contiguous() for c in pts),
            tuple(c[..., half:].contiguous() for c in pts),
        ))
    return Point(*(c[..., 0] for c in pts))


def _select_window_points(curve: CurveSpec, table, digits) -> Point:
    """(16, m, W, npad) points: T_i[|d|] from the plain (x, y, z) table by
    the (m, W, npad) digits, y negated where d < 0, the identity for i >= n."""
    n = table[0].shape[-1]
    npad = digits.shape[-1]
    d = digits[..., :n].long()
    cols = torch.arange(n, device=d.device)
    x, y, z = (t[:, d.abs(), cols] for t in table)  # (16, m, W, n)
    y = torch.where((d < 0).unsqueeze(0), limb.fneg(curve.base, y), y)
    if npad > n:
        pad = _identity_columns(curve, x, npad - n)
        x, y, z = (torch.cat([a, b], dim=-1) for a, b in zip((x, y, z), pad))
    return Point(x, y, z)


def ec_window_fold_plain(curve: CurveSpec, table, digits):
    """Window sums of every column, (x, y, z) each (16, m, W):
    ``_select_window_points`` folded by ``_fold_points``."""
    return tuple(_fold_points(curve, _select_window_points(curve, table, digits)))


def ec_window_fold(curve: CurveSpec, table, digits):
    """``ec_window_fold_plain``'s sums for CPU digits (and the plain table);
    for CUDA digits and ``ec_window_table``'s records one launch of
    ``ec_window_fold_kernel`` per log2(FOLD_BLOCK) fold levels.  The first
    pass selects from the table by digit; each later one folds the partials."""
    if digits.device.type == "cpu":
        return ec_window_fold_plain(curve, table, digits)
    if not isinstance(table, torch.Tensor):
        raise ValueError("ec_window_fold: CUDA digits take ec_window_table's (n, h+1, 24) records")
    _check("ec_window_fold", table, torch.int32, 3)
    _check("ec_window_fold", digits, torch.int16, 3)
    if table.device != digits.device or not (table.is_contiguous() and digits.is_contiguous()):
        raise ValueError("ec_window_fold: table and digits must be contiguous, on one device")
    n, h1, rec = table.shape
    m, w, npad = digits.shape
    c = (h1 - 1).bit_length()  # a table of 2^(c-1) + 1 entries: digits of c bits
    if rec != RECORD or npad != padded(n) or h1 - 1 != 1 << (c - 1) or w != num_windows(c):
        raise ValueError(f"ec_window_fold: table {tuple(table.shape)} and digits "
                         f"{tuple(digits.shape)} do not fit")
    rows = m * w
    dev = table.device
    out = tuple(torch.empty((NLIMBS, rows), dtype=torch.int32, device=dev) for _ in range(3))
    if rows == 0:
        return tuple(o.reshape(NLIMBS, m, w) for o in out)
    lib = _cuda.library()
    words, n0, b3, one = ec_kernels.launch_args(curve)
    src, first, count = table, True, npad
    while True:
        threads = min(FOLD_BLOCK, count)
        nb = count // threads
        dst = None if nb == 1 else torch.empty((rows, nb, RECORD), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.h2_ec_window_fold(
                digits.data_ptr() if first else None, src.data_ptr(),
                None if dst is None else dst.data_ptr(), *[o.data_ptr() for o in out],
                rows, count, n, h1, threads, words, n0, b3, one, _cuda.stream_ptr(table))
        _cuda.check(rc, "ec_window_fold")
        ec_window_fold.launches += 1
        if dst is None:
            return tuple(o.reshape(NLIMBS, m, w) for o in out)
        src, first, count = dst, False, nb


ec_window_fold.launches = 0


# ---------------------------------------------------------------------------
# the MSM
# ---------------------------------------------------------------------------

def choose_window(n: int) -> int:
    """The window width ``msm_many`` takes for n points."""
    return 5 if n >= 2048 else 4


def msm_many(curve: CurveSpec, scalars_mont, points: Point, c: int = 0) -> Point:
    """m MSMs over one shared base set, in one batched pass.

    scalars_mont: (m, 16, n) Montgomery-form scalar-field limbs; points: a
    (16, n) Point.  Returns a projective Point with coordinates (16, m).
    The window table is built once and every column's windows join the same
    fold and the same Horner launch.
    """
    n = scalars_mont.shape[2]
    if c == 0:
        c = choose_window(n)
    digits = msm_digits(curve, scalars_mont, c)
    table = ec_window_table(curve, points, c)
    sums = ec_window_fold(curve, table, digits)
    return Point(*ec_kernels.ec_horner(curve, sums, c))


def msm(curve: CurveSpec, scalars_mont, points: Point, c: int = 0) -> Point:
    """sum_i scalars[i] * points[i] for (16, n) Montgomery scalars; returns a
    single projective Point (coordinates of shape (16,))."""
    r = msm_many(curve, scalars_mont.unsqueeze(0), points, c)
    return Point(r.x[:, 0], r.y[:, 0], r.z[:, 0])
