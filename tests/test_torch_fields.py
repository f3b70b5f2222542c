"""halo2_tpu_torch field arithmetic against the JAX package, exactly.

Both sides get the same seeded Montgomery limb arrays (numpy); on the CPU the
port runs the plain torch versions of its kernels.  Tolerance: exact (equal
limb arrays), since all of it is exact integer arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields import ALL_FIELDS as JAX_FIELDS
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.fields import vreg as jvreg

from halo2_tpu_torch.fields import ALL_FIELDS, limb
from halo2_tpu_torch.fields.mont_mul import mont_mul, mont_mul_plain

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

FIELD_NAMES = [f.name for f in ALL_FIELDS]


def _specs(name):
    (t,) = [f for f in ALL_FIELDS if f.name == name]
    (j,) = [f for f in JAX_FIELDS if f.name == name]
    return t, j


def _values(p: int, seed: int, n: int = 13) -> list:
    """n canonical values: 0, 1, p-1 and seeded random ones."""
    rs = np.random.default_rng(seed)
    raw = rs.integers(0, 1 << 62, size=(n - 3, 5), dtype=np.int64)
    vals = [0, 1, p - 1]
    for row in raw:
        v = 0
        for w in row:
            v = (v << 62) | int(w)
        vals.append(v % p)
    return vals


def _mont_np(spec, vals) -> np.ndarray:
    """(16, n) uint32 Montgomery limbs of canonical vals."""
    return jlimb.ints_to_limbs_np([spec.to_mont(v) for v in vals])


def _both(arr: np.ndarray):
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32))


def _assert_same(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.int64), torch_out.numpy().astype(np.int64)
    )


def _operands(name, seed=0):
    t, j = _specs(name)
    a = _mont_np(j, _values(j.p, seed))
    b = _mont_np(j, _values(j.p, seed + 1)[::-1])
    return t, j, _both(a), _both(b)


@pytest.mark.parametrize("name", FIELD_NAMES)
@pytest.mark.parametrize("op", ["fadd", "fsub", "fmul"])
def test_binary_ops_match_jax(name, op):
    t, j, (ja, ta), (jb, tb) = _operands(name)
    _assert_same(getattr(jlimb, op)(j, ja, jb), getattr(limb, op)(t, ta, tb))


@pytest.mark.parametrize("name", FIELD_NAMES)
@pytest.mark.parametrize("op", ["fneg", "fsquare", "to_mont", "from_mont", "finv"])
def test_unary_ops_match_jax(name, op):
    t, j, (ja, ta), _ = _operands(name, seed=2)
    _assert_same(getattr(jlimb, op)(j, ja), getattr(limb, op)(t, ta))


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_fpow_const_matches_jax(name):
    t, j, (ja, ta), _ = _operands(name, seed=3)
    for e in (0, 1, 5, (1 << 70) + 12345):
        _assert_same(jlimb.fpow_const(j, ja, e), limb.fpow_const(t, ta, e))


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_batch_inv_matches_jax(name):
    t, j = _specs(name)
    vals = [v for v in _values(j.p, 4) if v != 0]  # contract: nonzero entries
    ja, ta = _both(_mont_np(j, vals))
    _assert_same(jlimb.batch_inv(j, ja), limb.batch_inv(t, ta))


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_int_conversions_match_jax(name):
    t, j = _specs(name)
    vals = _values(j.p, 5)
    _assert_same(jlimb.from_ints(j, vals), limb.from_ints(t, vals))
    _assert_same(jlimb.from_canonical_ints(j, vals), limb.from_canonical_ints(t, vals))
    assert limb.to_ints(t, limb.from_ints(t, vals)) == vals
    assert limb.to_ints(t, limb.from_ints(t, vals)) == jlimb.to_ints(j, jlimb.from_ints(j, vals))


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_mont_mul_plain_matches_vreg(name):
    """K1's plain version against the TPU kernel's body (fields/vreg.py)."""
    t, j, (ja, ta), (jb, tb) = _operands(name, seed=6)
    ref = jvreg.to_array(jvreg.vmul(j, jvreg.from_array(ja), jvreg.from_array(jb)))
    _assert_same(ref, mont_mul_plain(t, ta, tb))
    _assert_same(ref, mont_mul(t, ta, tb))  # the wrapper takes the plain path on CPU
    rinv = pow(j.r, -1, j.p)
    xs, ys = jlimb.limbs_np_to_ints(np.asarray(ja)), jlimb.limbs_np_to_ints(np.asarray(jb))
    assert limb.limbs_np_to_ints(mont_mul_plain(t, ta, tb).numpy()) == [
        x * y * rinv % j.p for x, y in zip(xs, ys)
    ]


def test_prefix_scans_match_sequential():
    """The Hillis–Steele scans that replace jax.lax.associative_scan."""
    t, j = _specs("bn254_fr")
    vals = _values(j.p, 7, n=37)
    ta = limb.from_ints(t, vals)
    prods, sums, acc_p, acc_s = [], [], 1, 0
    for v in vals:
        acc_p, acc_s = acc_p * v % j.p, (acc_s + v) % j.p
        prods.append(acc_p)
        sums.append(acc_s)
    assert limb.to_ints(t, limb.prefix_mul(t, ta)) == prods
    assert limb.to_ints(t, limb.prefix_add(t, ta)) == sums
    suffix = [sum(vals[i:]) % j.p for i in range(len(vals))]
    assert limb.to_ints(t, limb.prefix_add(t, ta, reverse=True)) == suffix


def test_wrappers_refuse_bad_cuda_operands():
    """A tensor that is not on the CPU never takes the plain path."""
    t, _ = _specs("bn254_fr")
    a = limb.from_ints(t, [1, 2, 3]).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        mont_mul(t, a, a)
