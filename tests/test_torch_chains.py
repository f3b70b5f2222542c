"""The chain entries of K1 and K3 against the JAX package, and their wiring.

``mont_pow`` (a^e, K1's chain entry), ``ec_scalar_mul`` and ``ec_horner``
(K3's chain entries) each run a whole chain of dependent kernel steps in one
launch on the card.  On the CPU their wrappers take the plain versions, which
are held here, on the same seeded inputs, to the JAX package's own chains:
``limb.finv`` / ``fpow_const``, ``ops.scalar_mul.batch_scalar_mul`` and
``ops.msm.msm_many``.  Tolerance: exact (equal limb arrays, projective
coordinates included, or equal affine ints), since all of it is exact
integer arithmetic.  The wiring tests show that ``finv``, ``batch_scalar_mul``
and ``msm_many`` reach the chain entries; the last test reads the default
device of the entry points from their signatures, without touching a device.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.curves import ALL_CURVES as JAX_CURVES
from halo2_tpu.curves import point as jpoint
from halo2_tpu.fields import ALL_FIELDS as JAX_FIELDS
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.ops import msm as jmsm
from halo2_tpu.ops import scalar_mul as jscalar_mul

from halo2_tpu_torch.curves import ec_kernels, host, point
from halo2_tpu_torch.curves.spec import BN254_G1, PALLAS
from halo2_tpu_torch.fields import ALL_FIELDS, limb
from halo2_tpu_torch.fields import mont_mul as mont_mul_mod
from halo2_tpu_torch.ops import msm as msm_ops
from halo2_tpu_torch.ops import scalar_mul
from halo2_tpu_torch.poly import ipa, kzg

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers


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


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.int64), torch_out.numpy().astype(np.int64)
    )


def _jax(spec, pool):
    (j,) = [x for x in pool if x.name == spec.name]
    return j


@pytest.mark.parametrize("name", [f.name for f in ALL_FIELDS])
def test_mont_pow_plain_matches_jax_finv_and_fpow_const(name):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    j = _jax(f, JAX_FIELDS)
    arr = jlimb.ints_to_limbs_np([f.to_mont(v) for v in _values(f.p, 40, 8)])
    ja, ta = jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32))
    inv = mont_mul_mod.mont_pow_plain(f, ta, f.p - 2)
    _same(jlimb.finv(j, ja), inv)
    _same(jlimb.finv(j, ja), limb.finv(f, ta))
    want = [0] + [pow(v, -1, f.p) for v in _values(f.p, 40, 8)[1:]]
    assert limb.to_ints(f, inv) == want
    for e in (1, 2, 5, 255, (1 << 70) + 12345):
        _same(jlimb.fpow_const(j, ja, e), mont_mul_mod.mont_pow_plain(f, ta, e))


def test_mont_pow_refuses_exponents_outside_its_range():
    f = ALL_FIELDS[0]
    a = limb.from_ints(f, [3], device="cpu")
    for e in (0, -1, 1 << 256):
        with pytest.raises(ValueError, match="exponent"):
            mont_mul_mod.mont_pow(f, a, e)


@pytest.mark.parametrize("curve", [BN254_G1, PALLAS], ids=lambda c: c.name)
def test_ec_scalar_mul_plain_matches_jax_batch_scalar_mul(curve):
    fr = curve.scalar
    g = host.generator(curve)
    rs = np.random.default_rng(41)
    pts = [host.mul(curve, g, int(k)) for k in rs.integers(1, 1 << 62, size=4)]
    pts[1] = None  # the identity
    scalars = [0, 1, fr.p - 1, int(rs.integers(1, 1 << 62)) ** 4 % fr.p]
    jc = _jax(curve, JAX_CURVES)
    want = jscalar_mul.batch_scalar_mul(
        jc, jlimb.from_ints(jc.scalar, scalars), jpoint.from_affine_ints(jc, pts))
    canon = torch.from_numpy(limb.ints_to_limbs_np(scalars))
    got = ec_kernels.ec_scalar_mul_plain(curve, canon, tuple(point.from_affine_ints(curve, pts)))
    for w, t in zip(want, got):
        _same(w, t)
    assert point.to_affine_ints(curve, point.Point(*got)) == [
        host.mul(curve, p, s) for p, s in zip(pts, scalars)]


@pytest.mark.parametrize("c", [4, 5])
def test_ec_horner_plain_matches_jax_msm_many(c):
    curve = BN254_G1
    fr = curve.scalar
    n, m, w = 6, 2, 7
    g = host.generator(curve)
    rs = np.random.default_rng(42 + c)
    # the fold alone: acc = S[W-1], then c doublings and + S[w] per window,
    # which is sum_w 2^(c w) S[w]
    sums_aff = [[host.mul(curve, g, int(k)) for k in rs.integers(1, 1 << 62, size=w)]
                for _ in range(m)]
    sums_aff[0][w - 1] = None  # the identity in the top window
    flat = point.from_affine_ints(curve, [q for col in sums_aff for q in col])
    got = ec_kernels.ec_horner_plain(curve, tuple(t.reshape(16, m, w) for t in flat), c)
    assert point.to_affine_ints(curve, point.Point(*got)) == [
        host.msm(curve, [1 << (c * v) for v in range(w)], col) for col in sums_aff]
    # the whole MSM through it, in affine form against JAX's msm_many
    pts = [host.mul(curve, g, int(k)) for k in rs.integers(1, 1 << 62, size=n)]
    cols = [_values(fr.p, 43 + c + i, n) for i in range(m)]
    jc = _jax(curve, JAX_CURVES)
    scal = np.stack([jlimb.ints_to_limbs_np([fr.to_mont(v) for v in col]) for col in cols])
    jr = jmsm.msm_many(jc, jnp.asarray(scal), jpoint.from_affine_ints(jc, pts), c)
    tr = msm_ops.msm_many(curve, torch.from_numpy(scal.astype(np.int32)),
                          point.from_affine_ints(curve, pts), c)
    assert point.to_affine_ints(curve, tr) == jpoint.to_affine_ints(jc, jr) == [
        host.msm(curve, col, pts) for col in cols]


class _Spy:
    """Counts the calls of a function and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)


def test_finv_and_fpow_const_run_one_mont_pow_and_no_k1(monkeypatch):
    f = ALL_FIELDS[1]
    pow_spy, mul_spy = _Spy(limb.mont_pow), _Spy(limb.mont_mul)
    monkeypatch.setattr(limb, "mont_pow", pow_spy)
    monkeypatch.setattr(limb, "mont_mul", mul_spy)
    a = limb.from_ints(f, _values(f.p, 44, 5), device="cpu")
    inv = limb.finv(f, a)
    assert [e for _, _, e in pow_spy.calls] == [f.p - 2] and not mul_spy.calls
    assert torch.equal(limb.fmul(f, inv[:, 1:], a[:, 1:]), limb.one_like(f, a[:, 1:]))
    limb.fpow_const(f, a.reshape(16, 5, 1), 7)
    assert [e for _, _, e in pow_spy.calls] == [f.p - 2, 7]
    assert torch.equal(limb.fpow_const(f, a, 0), limb.one_like(f, a))
    assert len(pow_spy.calls) == 2  # e = 0 is the constant one: nothing to run


def test_batch_scalar_mul_runs_one_ec_scalar_mul(monkeypatch):
    curve = PALLAS
    spies = {name: _Spy(getattr(ec_kernels, name))
             for name in ("ec_scalar_mul", "ec_add", "ec_double")}
    for name, spy in spies.items():
        monkeypatch.setattr(ec_kernels, name, spy)
    pts = [host.mul(curve, host.generator(curve), k) for k in (2, 3)]
    out = scalar_mul.batch_scalar_mul(
        curve, limb.from_ints(curve.scalar, [5, 7], device="cpu"),
        point.from_affine_ints(curve, pts, device="cpu"))
    assert [len(s.calls) for s in spies.values()] == [1, 0, 0]
    assert point.to_affine_ints(curve, out) == [host.mul(curve, p, k) for p, k in zip(pts, (5, 7))]


def test_msm_many_folds_its_windows_in_one_ec_horner(monkeypatch):
    curve = BN254_G1
    spies = {name: _Spy(getattr(ec_kernels, name)) for name in ("ec_horner", "ec_add", "ec_double")}
    for name, spy in spies.items():
        monkeypatch.setattr(ec_kernels, name, spy)
    entries = {name: _Spy(getattr(msm_ops, name))
               for name in ("msm_digits", "ec_window_table", "ec_window_fold")}
    for name, spy in entries.items():
        monkeypatch.setattr(msm_ops, name, spy)
    pts = [host.mul(curve, host.generator(curve), k) for k in (2, 3, 4)]
    scal = torch.stack([limb.from_ints(curve.scalar, col, device="cpu")
                        for col in ([1, 2, 3], [4, 5, 6])])
    out = msm_ops.msm_many(curve, scal, point.from_affine_ints(curve, pts, device="cpu"), 4)
    # each MSM entry once and one Horner launch; no standalone K2 / K3: the
    # table's double and adds and the fold's adds run inside the entries
    assert [len(s.calls) for s in entries.values()] == [1, 1, 1]
    assert [len(s.calls) for s in spies.values()] == [1, 0, 0]
    assert spies["ec_horner"].calls[0][2] == 4
    assert point.to_affine_ints(curve, out) == [
        host.msm(curve, col, pts) for col in ([1, 2, 3], [4, 5, 6])]


@pytest.mark.parametrize("fn", [
    kzg.ParamsKZG.setup, kzg.ParamsKZG.setup_host, kzg.ParamsKZG.read, kzg.params_from_numpy,
    ipa.ParamsIPA.setup, ipa.params_from_numpy,
], ids=lambda fn: fn.__qualname__)
def test_params_entry_points_default_to_the_card(fn):
    """Params made without a device live on the card, and so does every
    tensor of a proof made with them; CPU callers pass device="cpu"."""
    default = inspect.signature(fn).parameters["device"].default
    assert torch.device(default).type == "cuda"
