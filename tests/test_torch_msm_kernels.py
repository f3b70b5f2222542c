"""The MSM entries of ``halo2_tpu_torch.ops.msm`` against the JAX package.

``msm_many`` runs ``msm_digits``, ``ec_window_table``, ``ec_window_fold``
and ``ec_horner``; on the CPU each takes its plain version, which is held
here, on the same seeded inputs, to the JAX package's ``ops/msm.py``:

- ``msm_digits_plain`` to ``_signed_digits`` on the canonical scalars;
- ``ec_window_table_plain`` to ``_build_table``, limb for limb, and
  ``table_unpack`` (the card's table records -> the plain table) to the
  record layout that ``csrc/msm.cu`` writes;
- the card's fold order: ``_fold_points_blocked`` below emulates
  ``ec_window_fold_kernel`` (thread k of block j takes element j + k nb, a
  stride-halving tree in each block, then the partials again) and must give
  ``_fold_points``' limbs exactly, for identity padding and negated digits;
- ``msm_many`` to JAX's ``msm_many`` in affine form, and on a grid of
  shapes (n = 1, 5, 1000; m = 1, 3; BN254 and Pallas) to the JAX package's
  host MSM.

Tolerance: exact throughout (integer arithmetic; equal limbs or equal affine
ints).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.curves import ALL_CURVES as JAX_CURVES
from halo2_tpu.curves import host as jhost
from halo2_tpu.curves import point as jpoint
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.ops import msm as jmsm

from halo2_tpu_torch.curves import ec_kernels, host, point
from halo2_tpu_torch.curves.spec import BN254_G1, PALLAS
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.ops import msm as msm_ops

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers


def _jax(curve):
    (j,) = [c for c in JAX_CURVES if c.name == curve.name]
    return j


def _values(p: int, seed: int, n: int) -> list:
    """0, 1, p-1 and seeded random canonical values, n in all."""
    rs = np.random.default_rng(seed)
    raw = rs.integers(0, 1 << 62, size=(max(n - 3, 0), 5), dtype=np.int64)
    vals = [0, 1, p - 1]
    for row in raw:
        v = 0
        for w in row:
            v = (v << 62) | int(w)
        vals.append(v % p)
    return vals[:n]


def _points(curve, n: int, seed: int) -> list:
    """n affine points R + i*S (one host add each), the identity first."""
    g = host.generator(curve)
    r, s = (host.mul(curve, g, int(v))
            for v in np.random.default_rng(seed).integers(1, 1 << 62, size=2))
    pts = [r]
    for _ in range(n - 1):
        pts.append(host.add(curve, pts[-1], s))
    if n > 1:
        pts[0] = None
    return pts


def _mont_columns(curve, cols) -> np.ndarray:
    """(m, 16, n) Montgomery limbs of the scalar columns."""
    fr = curve.scalar
    return np.stack([jlimb.ints_to_limbs_np([fr.to_mont(v) for v in col]) for col in cols])


@pytest.mark.parametrize("c", [4, 5, 6])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_msm_digits_plain_matches_jax_signed_digits(c, n):
    curve = BN254_G1
    cols = [_values(curve.scalar.p, 10 + c, n), _values(curve.scalar.p, 20 + n, n)[::-1]]
    got = msm_ops.msm_digits_plain(curve, torch.from_numpy(_mont_columns(curve, cols)
                                                           .astype(np.int32)), c)
    npad = msm_ops.padded(n)
    assert got.dtype == torch.int16 and got.shape == (2, msm_ops.num_windows(c), npad)
    for j, col in enumerate(cols):
        want = jmsm._signed_digits(jnp.asarray(jlimb.ints_to_limbs_np(col)), c)
        np.testing.assert_array_equal(np.asarray(want), got[j, :, :n].numpy())
        back = [sum(int(d) << (c * w) for w, d in enumerate(got[j, :, i].tolist()))
                for i in range(n)]
        assert back == col
    assert not got[:, :, n:].any()  # the padding points' digits are 0


def test_msm_digits_plain_takes_every_c_the_card_refuses():
    curve = PALLAS
    vals = _values(curve.scalar.p, 30, 7)
    scal = limb.from_ints(curve.scalar, vals).unsqueeze(0)
    for c in (1, 9, 15):
        d = msm_ops.msm_digits(curve, scal, c)  # a CPU tensor: the plain version
        assert d.shape == (1, msm_ops.num_windows(c), 8)
        assert [sum(int(x) << (c * w) for w, x in enumerate(d[0, :, i].tolist()))
                for i in range(7)] == vals
    for c in (0, 16):
        with pytest.raises(ValueError, match="int16"):
            msm_ops.msm_digits(curve, scal, c)


def _records(coords):
    """ec_window_table_kernel's layout: three (16, h+1, n) limb arrays ->
    (n, h+1, 24) int32 records, x, y, z as 8 little-endian 32-bit words each
    (limbs 2j, 2j+1 in word j)."""
    limbs = torch.stack(coords).permute(3, 2, 0, 1).to(torch.int64)  # (n, h+1, 3, 16)
    words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)  # the int32 bit pattern
    return words.to(torch.int32).reshape(words.shape[0], words.shape[1], msm_ops.RECORD)


@pytest.mark.parametrize("curve", [BN254_G1, PALLAS], ids=lambda c: c.name)
@pytest.mark.parametrize("c", [1, 2, 4, 5])
def test_window_table_plain_matches_jax_build_table(curve, c):
    n = 6
    aff = _points(curve, n, 40 + c)
    aff[3] = host.neg(curve, aff[2])
    pts = ec_kernels.ec_double_plain(curve, tuple(point.from_affine_ints(curve, aff)))  # z != 1
    unpacked = msm_ops.ec_window_table_plain(curve, pts, c)
    h = 1 << (c - 1)
    assert all(t.dtype == torch.int32 and t.shape == (16, h + 1, n) for t in unpacked)
    records = _records(unpacked)
    assert records.shape == (n, h + 1, msm_ops.RECORD)
    for a, b in zip(msm_ops.table_unpack(records), unpacked):  # the helper round-trips
        assert torch.equal(a, b)
    rows = tuple(jnp.asarray(t.numpy().astype(np.uint32).reshape(16, 1, n)) for t in pts)
    want = jmsm._build_table(_jax(curve), rows, h, unroll=True)
    for j in range(h + 1):
        for ci in range(3):
            np.testing.assert_array_equal(np.asarray(want[j][ci]).reshape(16, n).astype(np.int64),
                                          unpacked[ci][:, j].numpy().astype(np.int64))
    assert point.to_affine_ints(curve, point.Point(*(t[:, h] for t in unpacked))) == [
        host.mul(curve, host.double(curve, q), h) for q in aff]


def _fold_points_blocked(curve, pts, block: int):
    """ec_window_fold_kernel's order on the plain formulas: each pass cuts the
    count elements into nb = count / T blocks of T = min(block, count)
    threads; thread k of block j takes element j + k nb; the block runs
    s[k] = s[k] + s[k + stride] for stride = T/2, ..., 1; block j's s[0] is
    element j of the next pass, until one element remains."""
    count = pts.x.shape[-1]
    while True:
        threads = min(block, count)
        nb = count // threads
        members = torch.tensor([[j + k * nb for k in range(threads)] for j in range(nb)])
        s = tuple(c[..., members] for c in pts)  # (..., nb, T)
        stride = threads // 2
        while stride:
            s = ec_kernels.ec_add_plain(curve, tuple(c[..., :stride] for c in s),
                                        tuple(c[..., stride:2 * stride] for c in s))
            stride //= 2
        pts = point.Point(*(c[..., 0] for c in s))  # (..., nb)
        if nb == 1:
            return point.Point(*(c[..., 0] for c in pts))
        count = nb


@pytest.mark.parametrize("npad", [1, 2, 8, 64, 1024])
@pytest.mark.parametrize("block", [2, 4, 16, 128, 256])  # 128: the kernel's
def test_blocked_fold_order_equals_the_halving_fold(npad, block):
    curve = BN254_G1
    n = max(npad - 3, 1)  # the last points are identity padding
    m, c = 2, 2
    rs = np.random.default_rng(npad * 7 + block)
    aff = _points(curve, n, npad + block)
    table = msm_ops.ec_window_table_plain(curve, point.from_affine_ints(curve, aff), c)
    h = 1 << (c - 1)
    digits = rs.integers(-h, h + 1, size=(m, 3, npad)).astype(np.int16)  # negatives included
    digits[:, :, n:] = 0
    sel = msm_ops._select_window_points(curve, table, torch.from_numpy(digits))
    assert sel.x.shape == (16, m, 3, npad)
    want = msm_ops._fold_points(curve, sel)
    got = _fold_points_blocked(curve, sel, block)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sums = msm_ops.ec_window_fold_plain(curve, table, torch.from_numpy(digits))
    for a, b in zip(sums, want):
        assert torch.equal(a, b)
    for col in range(m):
        for w in range(3):
            terms = [(int(d), q) for d, q in zip(digits[col, w, :n], aff)]
            expect = None
            for d, q in terms:
                expect = host.add(curve, expect, host.mul(curve, q if d >= 0 else host.neg(curve, q),
                                                          abs(d)))
            assert point.to_affine_ints(curve, point.Point(*(t[:, col, w] for t in got))) == [expect]


@pytest.mark.parametrize("curve", [BN254_G1, PALLAS], ids=lambda c: c.name)
@pytest.mark.parametrize("n,m", [(1, 1), (1, 3), (5, 1), (5, 3), (1000, 1)])
def test_msm_many_plain_matches_host(curve, n, m):
    aff = _points(curve, n, 50 + n)
    cols = [_values(curve.scalar.p, 60 + 7 * i + n, n) for i in range(m)]
    got = msm_ops.msm_many(curve, torch.from_numpy(_mont_columns(curve, cols).astype(np.int32)),
                           point.from_affine_ints(curve, aff))
    assert point.to_affine_ints(curve, got) == [jhost.msm(_jax(curve), col, aff) for col in cols]


@pytest.mark.parametrize("curve,n,m", [(BN254_G1, 5, 3), (PALLAS, 1, 1)],
                         ids=lambda v: getattr(v, "name", None))
def test_msm_many_plain_matches_jax_msm_many(curve, n, m):
    """Two shapes: each JAX msm_many shape costs 50-100 s of XLA compile on
    the CPU; the grid above holds every shape to the host MSM."""
    aff = _points(curve, n, 70 + n)
    cols = [_values(curve.scalar.p, 80 + 5 * i + n, n) for i in range(m)]
    scal = _mont_columns(curve, cols)
    jc = _jax(curve)
    want = jmsm.msm_many(jc, jnp.asarray(scal), jpoint.from_affine_ints(jc, aff))
    got = msm_ops.msm_many(curve, torch.from_numpy(scal.astype(np.int32)),
                           point.from_affine_ints(curve, aff))
    assert point.to_affine_ints(curve, got) == jpoint.to_affine_ints(jc, want)


def test_msm_many_takes_strided_operands():
    """The IPA rounds pass column slices of wider arrays."""
    curve = PALLAS
    aff = _points(curve, 12, 90)
    vals = _values(curve.scalar.p, 91, 12)
    scal = limb.from_ints(curve.scalar, vals)
    pts = point.from_affine_ints(curve, aff)
    got = msm_ops.msm(curve, scal[:, 4:], point.Point(*(c[:, 4:] for c in pts)))
    assert point.to_affine_ints(curve, got) == [jhost.msm(_jax(curve), vals[4:], aff[4:])]
