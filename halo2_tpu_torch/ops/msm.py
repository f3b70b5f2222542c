"""Multi-scalar multiplication: signed-digit Straus windows.

Port of the JAX package's ``ops/msm.py`` (itself the replacement for the
reference ``best_multiexp``, arithmetic.rs:16-159), on the flat (16, n)
layout without the TPU's 128-lane rows:

  1. scalars Montgomery -> canonical: one multiply by 1 (K1)
  2. scalars -> signed c-bit digits d in [-2^(c-1), 2^(c-1)]   (torch ops)
  3. table T_j = j*P_i for j = 0..2^(c-1): one double (K3), then adds (K2)
  4. every window of every scalar selects T_|d| (one gather), y negated
     where d < 0
  5. one pairwise tree-fold over the point axis for all windows and all
     columns at once: log2(n) K2 launches
  6. window combination by Horner over the windows, all columns in
     parallel: one launch of K3's chain entry ``ec_horner``, (W-1)c
     doublings and W-1 adds per column in one thread's registers

Work: (ceil(256/c) + 2^(c-1) - 1) * n complete adds.  The result is the same
group element as any other MSM algorithm, so callers compare it in affine
form (``curves.point.to_affine_ints``).
"""

from __future__ import annotations

import torch

from ..curves import ec_kernels
from ..curves.point import Point, ec_add, ec_double, identity
from ..curves.spec import CurveSpec
from ..fields import limb
from ..fields.spec import LIMB_BITS, NLIMBS, int_to_limbs


def _extract_digits(scalars, c: int):
    """Canonical (16, N) limbs -> (num_windows, N) int32 c-bit digits."""
    num_windows = (256 + c - 1) // c
    mask = (1 << c) - 1
    outs = []
    for w in range(num_windows):
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
    num = raw.shape[0]
    if c * num < 257:  # c <= 4 with 256 bits: the final carry needs one more window
        num += 1
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


def _build_table(curve: CurveSpec, pts: Point, h: int):
    """[T_0 .. T_h], T_j = j * P, stacked per coordinate as (16, h+1, n)."""
    table = [identity(curve, pts.x.shape[1:], pts.x.device), pts]
    if h >= 2:
        table.append(ec_double(curve, pts))
    for _ in range(3, h + 1):
        table.append(ec_add(curve, table[-1], pts))
    return [torch.stack([t[ci] for t in table], dim=1) for ci in range(3)]


def _fold_points(curve: CurveSpec, pts: Point) -> Point:
    """Tree-sum a (16, B, n) point batch over its last axis (n a power of two)."""
    while pts.x.shape[-1] > 1:
        half = pts.x.shape[-1] // 2
        pts = ec_add(
            curve,
            Point(*(c[..., :half].contiguous() for c in pts)),
            Point(*(c[..., half:].contiguous() for c in pts)),
        )
    return Point(*(c[..., 0] for c in pts))


def msm_many(curve: CurveSpec, scalars_mont, points: Point, c: int = 0) -> Point:
    """m MSMs over one shared base set, in one batched pass.

    scalars_mont: (m, 16, n) Montgomery-form scalar-field limbs; points: a
    (16, n) Point.  Returns a projective Point with coordinates (16, m).
    The window table is built once and every column's windows join the same
    tree-fold and the same Horner launch.
    """
    m, _, n = scalars_mont.shape
    dev = scalars_mont.device
    if c == 0:
        c = 5 if n >= 2048 else 4
    h = 1 << (c - 1)
    npad = 1 << max(n - 1, 0).bit_length()
    # padded scalars are 0 -> every digit 0 -> T_0 (the identity) is selected,
    # so the zero padding points never contribute
    pad = npad - n
    scal = torch.nn.functional.pad(scalars_mont, (0, pad))
    pts = Point(*(torch.nn.functional.pad(coord, (0, pad)) for coord in points))

    # Montgomery -> canonical for digit extraction: multiply by the literal 1
    flat = scal.transpose(0, 1).reshape(NLIMBS, m * npad)
    canon = limb.fmul(curve.scalar, flat, limb.const(int_to_limbs(1), 2, dev))
    digits = _signed_digits(canon, c)  # (W, m * npad)
    w = digits.shape[0]
    digits = digits.reshape(w, m, npad).transpose(0, 1)  # (m, W, npad)

    tx, ty, tz = _build_table(curve, pts, h)
    absd = digits.abs().long()
    cols = torch.arange(npad, device=dev)
    x, y, z = (t[:, absd, cols] for t in (tx, ty, tz))  # (16, m, W, npad)
    neg = (digits < 0).unsqueeze(0)
    y = torch.where(neg, limb.fneg(curve.base, y), y)

    sums = _fold_points(curve, Point(x, y, z))  # (16, m, W)
    return Point(*ec_kernels.ec_horner(curve, tuple(sums), c))


def msm(curve: CurveSpec, scalars_mont, points: Point, c: int = 0) -> Point:
    """sum_i scalars[i] * points[i] for (16, n) Montgomery scalars; returns a
    single projective Point (coordinates of shape (16,))."""
    r = msm_many(curve, scalars_mont.unsqueeze(0), points, c)
    return Point(r.x[:, 0], r.y[:, 0], r.z[:, 0])
