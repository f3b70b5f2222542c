"""K1's field and transform entries against the JAX package, exactly.

``limb.fadd`` / ``fsub`` / ``fneg`` / ``fmul`` (the wrappers ``field_add``,
``field_sub``, ``field_neg`` and ``mont_mul``, which take their plain
versions on the CPU) against the JAX package's jitted ``fadd`` / ``fsub`` /
``fneg`` / ``fmul`` at the prover's broadcast shapes, on all four fields;
``stockham_axis`` against the JAX package's ``_stockham_axis1`` and
``ntt_sixstep`` / ``intt_sixstep`` against its own at k = 0..10.  Both sides
get the same seeded Montgomery limb arrays (numpy), with 0, 1 and p-1 among
them.  Tolerance: exact (equal limb arrays): all of it is exact integer
arithmetic.  The JAX side compiles one program per shape; the transforms at
k >= 6 compile graphs of 10-25 s each on one CPU core and are marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.fields import ALL_FIELDS as JAX_FIELDS
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.ops import ntt as jntt

from halo2_tpu_torch.curves import ec_kernels as ec
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.fields import ALL_FIELDS, field_ops, limb
from halo2_tpu_torch.fields import mont_mul as mont_mul_mod
from halo2_tpu_torch.ops import lookup as lookup_ops
from halo2_tpu_torch.ops import msm as msm_ops
from halo2_tpu_torch.ops import ntt as ntt_ops

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

FIELD_NAMES = [f.name for f in ALL_FIELDS]
SLOW_K = 6  # the first transform size whose JAX compile is marked slow


def _specs(name):
    (t,) = [f for f in ALL_FIELDS if f.name == name]
    (j,) = [f for f in JAX_FIELDS if f.name == name]
    return t, j


def _mont(spec, seed: int, shape) -> np.ndarray:
    """(16, *shape) uint32 Montgomery limbs of seeded values, 0, 1 and p-1 first."""
    n = int(np.prod(shape))
    rs = np.random.default_rng(seed)
    raw = rs.integers(0, 1 << 62, size=(max(n - 3, 0), 5), dtype=np.int64)
    vals = [0, 1, spec.p - 1]
    for row in raw:
        v = 0
        for w in row:
            v = (v << 62) | int(w)
        vals.append(v % spec.p)
    vals = vals[:n] if n >= 3 else vals[-n:] if n else []
    return jlimb.ints_to_limbs_np([spec.to_mont(v) for v in vals]).reshape((16,) + tuple(shape))


def _both(arr: np.ndarray):
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32))


def _assert_same(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.int64), torch_out.numpy().astype(np.int64)
    )


# the shapes the prover hands these ops: a column with a challenge or a
# constant, both ways round; (16, a, 1, b) against (16, a, h, b) (the
# butterfly's twiddles, the Stockham stage's) and a one-element constant
BROADCASTS = [((13,), (1,)), ((1,), (13,)), ((3, 1, 5), (3, 4, 5)), ((3, 4, 5), (3, 1, 5)),
              ((3, 4, 5), (1, 1, 1)), ((1, 1, 1), (1, 1, 1))]


@pytest.mark.parametrize("name", FIELD_NAMES)
@pytest.mark.parametrize("op", ["fadd", "fsub", "fmul"])
def test_binary_ops_at_broadcast_shapes_match_jax(name, op):
    t, j = _specs(name)
    for i, (sa, sb) in enumerate(BROADCASTS):
        (ja, ta), (jb, tb) = _both(_mont(j, 2 * i, sa)), _both(_mont(j, 2 * i + 1, sb))
        _assert_same(getattr(jlimb, op)(j, *jnp.broadcast_arrays(ja, jb)),
                     getattr(limb, op)(t, ta, tb))


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_fneg_matches_jax(name):
    t, j = _specs(name)
    for i, shape in enumerate([(13,), (1,), (3, 4, 5)]):
        ja, ta = _both(_mont(j, 20 + i, shape))
        _assert_same(jlimb.fneg(j, ja), limb.fneg(t, ta))
        flat = field_ops.field_neg(t, ta.reshape(16, -1))
        _assert_same(jlimb.fneg(j, ja), flat.reshape(ta.shape))


def test_one_element_operands_are_read_in_place():
    t, _ = _specs("bn254_fr")
    wide = torch.from_numpy(_mont(t, 30, (7,)).astype(np.int32))
    col = torch.from_numpy(_mont(t, 31, (2, 5)).astype(np.int32))
    (a, b), shape = field_ops.flat_operands(col, wide[:, 3:4].reshape(16, 1, 1))
    assert shape == (16, 2, 5) and a.shape == (16, 10) and b.shape == (16, 1)
    assert b.data_ptr() == wide[:, 3].data_ptr()  # a view, not a copy
    (a, b), shape = field_ops.flat_operands(col[:, :1], col)
    assert a.shape == b.shape == (16, 10) and a.is_contiguous()


def _roots(spec, k: int):
    omega = pow(spec.root_of_unity, 1 << (spec.s - k), spec.p)
    return omega, pow(omega, -1, spec.p)


def _power_np(spec, base: int, n: int) -> np.ndarray:
    return jlimb.ints_to_limbs_np([spec.to_mont(pow(base, i, spec.p)) for i in range(n)])


def _k_cases(ks):
    return [pytest.param(k, marks=pytest.mark.slow) if k >= SLOW_K else k for k in ks]


_jax_stockham = jax.jit(jntt._stockham_axis1, static_argnums=(0, 3))


@pytest.mark.parametrize("name", ["bn254_fr", "pasta_fq"])
@pytest.mark.parametrize("k", _k_cases([0, 1, 2, 3, 5, 8]))
def test_stockham_axis_matches_jax(name, k):
    t, j = _specs(name)
    m = 1 << k
    omega, _ = _roots(j, k)
    jx, tx = _both(_mont(j, 40 + k, (m, 3)))
    jtw, ttw = _both(_power_np(j, omega, m // 2))
    _assert_same(_jax_stockham(j, jx, jtw, k), ntt_ops.stockham_axis(t, tx, ttw, k))


@pytest.mark.parametrize("k", _k_cases(range(11)))
def test_ntt_sixstep_matches_jax(k):
    t, j = _specs("bn254_fr")
    n = 1 << k
    omega, _ = _roots(j, k)
    ja, ta = _both(_mont(j, 50 + k, (n,)))
    jtw, ttw = _both(_power_np(j, omega, n // 2))
    jwc = jntt.cross_twiddles(j, omega, k)
    twc = torch.from_numpy(np.asarray(jwc).astype(np.int32))
    _assert_same(jntt.ntt_sixstep(j, ja, jtw, jwc, k), ntt_ops.ntt_sixstep(t, ta, ttw, twc, k))


@pytest.mark.parametrize("k", _k_cases(range(11)))
def test_intt_sixstep_matches_jax(k):
    t, j = _specs("bn254_fr")
    n = 1 << k
    _, inv = _roots(j, k)
    ja, ta = _both(_mont(j, 60 + k, (n,)))
    jtw, ttw = _both(_power_np(j, inv, n // 2))
    jwc = jntt.cross_twiddles(j, inv, k)
    twc = torch.from_numpy(np.asarray(jwc).astype(np.int32))
    jn, tn = _both(jlimb.ints_to_limbs_np([j.to_mont(pow(n, -1, j.p))])[:, 0])
    got = ntt_ops.intt_sixstep(t, ta, ttw, twc, k, tn, ntt_ops.sixstep_twiddles(ttw, k))
    _assert_same(jntt.intt_sixstep(j, ja, jtw, jwc, k, jn), got)


def test_wrappers_refuse_a_device_mix_and_a_wrong_dtype():
    """A tensor that is not on the CPU never takes the plain path, and no
    wrapper takes limbs of another dtype (meta tensors stand in for the card)."""
    t, _ = _specs("bn254_fr")
    a = torch.from_numpy(_mont(t, 70, (8,)).astype(np.int32))
    for fn in (field_ops.field_add, field_ops.field_sub):
        for x, y in ((a, a.to("meta")), (a.to("meta"), a)):
            with pytest.raises(ValueError, match="CUDA"):
                fn(t, x, y)
        with pytest.raises(ValueError, match="int32"):
            fn(t, a.long(), a)
    with pytest.raises(ValueError, match="CUDA"):
        field_ops.field_neg(t, a.to("meta"))
    with pytest.raises(ValueError, match="int32"):
        field_ops.field_neg(t, a.long())
    x, tw = a.reshape(16, 8, 1), a[:, :4].contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        ntt_ops.stockham_axis(t, x, tw.to("meta"), 3)
    with pytest.raises(ValueError, match="int32"):
        ntt_ops.stockham_axis(t, x.long(), tw, 3)


def _refuse_wrappers(monkeypatch):
    """Make every wrapper of K1's field, product and chain entries raise."""
    def refused(*args, **kwargs):
        raise AssertionError("a plain version called a kernel's wrapper")

    for mod in (field_ops, limb):
        for name in ("field_add", "field_sub", "field_neg"):
            monkeypatch.setattr(mod, name, refused)
    for mod in (mont_mul_mod, limb):
        for name in ("mont_mul", "mont_pow"):
            monkeypatch.setattr(mod, name, refused)
    for name in ("mont_mul", "lookup_match"):
        monkeypatch.setattr(lookup_ops, name, refused)


def _plain_cases():
    """name -> a thunk running that plain version on small CPU inputs."""
    curve, fr = BN254_G1, _specs("bn254_fr")[0]

    def limbs(spec, seed, shape):
        return torch.from_numpy(_mont(spec, seed, shape).astype(np.int32))

    p = tuple(limbs(curve.base, 80 + i, (4,)) for i in range(3))
    q = tuple(limbs(curve.base, 83 + i, (4,)) for i in range(3))
    sums = tuple(limbs(curve.base, 86 + i, (1, 2)) for i in range(3))

    def window_fold():
        table = msm_ops.ec_window_table_plain(curve, p, 2)
        digits = msm_ops.msm_digits_plain(curve, limbs(curve.scalar, 89, (4,))[None], 2)
        assert (digits < 0).any()  # the select's negation runs
        return msm_ops.ec_window_fold_plain(curve, table, digits)

    omega, _ = _roots(fr, 3)
    x, tw = limbs(fr, 90, (8, 2)), torch.from_numpy(_power_np(fr, omega, 4).astype(np.int32))
    table = limbs(fr, 91, (32,))
    inputs = table[:, torch.from_numpy(np.random.default_rng(92).integers(0, 16, size=32))]

    def permute_dev():
        from halo2_tpu_torch.plonk import prover
        from halo2_tpu_torch.utils.rng import FieldRng

        return prover.permute_expression_pair_dev(fr, FieldRng(fr, b"plain"), inputs, table, 32, 5)

    return {
        "ec_add_plain": lambda: ec.ec_add_plain(curve, p, q),
        "ec_double_plain": lambda: ec.ec_double_plain(curve, p),
        "ec_horner_plain": lambda: ec.ec_horner_plain(curve, sums, 1),
        "ec_window_fold_plain": window_fold,
        "stockham_axis_plain": lambda: ntt_ops.stockham_axis_plain(fr, x, tw, 3),
        "lookup_permute_plain": lambda: tuple(  # the rows past usable are not written
            t[:, :26] for t in lookup_ops.lookup_permute_plain(fr, inputs, table, 26)[:2]),
        "permute_expression_pair_dev": permute_dev,
    }


@pytest.mark.parametrize("name", ["ec_add_plain", "ec_double_plain", "ec_horner_plain",
                                  "ec_window_fold_plain", "stockham_axis_plain",
                                  "lookup_permute_plain", "permute_expression_pair_dev"])
def test_plain_versions_call_no_kernel_wrapper(name, monkeypatch):
    """The plain versions that the card's kernels are held to run on the
    plain chains and ``mont_mul_plain`` alone, so no kernel code (``field.cuh``
    is shared by K1, K2, K3 and the field entries) is on both sides of a
    comparison on the card."""
    case = _plain_cases()[name]
    want = case()
    _refuse_wrappers(monkeypatch)
    got = case()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
