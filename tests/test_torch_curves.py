"""halo2_tpu_torch EC add / double against the JAX package, exactly.

K2 / K3's plain versions (``ec_add_plain`` / ``ec_double_plain``) against
``halo2_tpu.curves.pallas_ec.ec_add_rows`` / ``ec_double_rows`` run through
the JAX package's own CPU path (``interpret=None``, i.e. ``point.ec_add``),
on BN254 G1, Pallas and Vesta, with the identity, P+P and P+(-P) among the
inputs.  Both sides compute the same RCB formulas, so the projective limbs
agree exactly; affine coordinates are checked against host arithmetic too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.curves import ALL_CURVES as JAX_CURVES
from halo2_tpu.curves import pallas_ec as jec
from halo2_tpu.curves import point as jpoint

from halo2_tpu_torch.curves import ALL_CURVES, host, point
from halo2_tpu_torch.curves import ec_kernels as ec

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

CURVE_NAMES = [c.name for c in ALL_CURVES]
N = 8


def _curves(name):
    (t,) = [c for c in ALL_CURVES if c.name == name]
    (j,) = [c for c in JAX_CURVES if c.name == name]
    return t, j


def _points(curve, seed: int):
    """Two lists of N affine points (None = identity) with the special cases:
    identity + Q, P + identity, P + P, P + (-P), identity + identity."""
    rs = np.random.default_rng(seed)
    g = host.generator(curve)
    ks = [int(k) for k in rs.integers(1, 1 << 62, size=2 * N)]
    pts = [host.mul(curve, g, k) for k in ks]
    ps, qs = pts[:N], pts[N:]
    ps[0] = None
    qs[1] = None
    qs[2] = ps[2]
    qs[3] = host.neg(curve, ps[3])
    ps[4] = qs[4] = None
    return ps, qs


def _projective(tcurve, affine):
    """Port Point with z != 1 (doubled once through the plain formulas), and
    the same limbs as uint32 numpy for the JAX side."""
    pt = ec.ec_double_plain(tcurve, tuple(point.from_affine_ints(tcurve, affine)))
    pt = tuple(c.contiguous() for c in pt)
    return pt, tuple(c.numpy().astype(np.uint32) for c in pt)


def _rows(arr):
    return jnp.asarray(arr.reshape(16, 1, -1))


def _assert_same(jax_coords, torch_coords):
    for jc, tc in zip(jax_coords, torch_coords):
        np.testing.assert_array_equal(
            np.asarray(jc).reshape(16, -1).astype(np.int64), tc.numpy().astype(np.int64)
        )


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_ec_add_plain_matches_jax(name):
    t, j = _curves(name)
    ps, qs = _points(t, seed=1)
    tp, np_p = _projective(t, ps)
    tq, np_q = _projective(t, qs)
    ref = jec.ec_add_rows(j, tuple(map(_rows, np_p)), tuple(map(_rows, np_q)))
    out = ec.ec_add_plain(t, tp, tq)
    _assert_same(ref, out)
    _assert_same(ref, ec.ec_add(t, tp, tq))  # the wrapper takes the plain path on CPU
    want = [host.double(t, host.add(t, a, b)) for a, b in zip(ps, qs)]
    assert point.to_affine_ints(t, point.Point(*out)) == want


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_ec_double_plain_matches_jax(name):
    t, j = _curves(name)
    ps, _ = _points(t, seed=2)
    tp, np_p = _projective(t, ps)
    ref = jec.ec_double_rows(j, tuple(map(_rows, np_p)))
    out = ec.ec_double_plain(t, tp)
    _assert_same(ref, out)
    _assert_same(ref, ec.ec_double(t, tp))
    want = [host.double(t, host.double(t, a)) for a in ps]
    assert point.to_affine_ints(t, point.Point(*out)) == want


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_point_helpers_match_jax(name):
    """ec_neg, ec_select, batch_normalize and the affine converters."""
    t, j = _curves(name)
    ps, qs = _points(t, seed=3)
    tp, np_p = _projective(t, ps)
    jp = jpoint.Point(*(jnp.asarray(c) for c in np_p))
    tpt = point.Point(*tp)
    _assert_same(jpoint.ec_neg(j, jp), point.ec_neg(t, tpt))
    _assert_same(jpoint.batch_normalize(j, jp), point.batch_normalize(t, tpt))
    assert point.to_affine_ints(t, tpt) == jpoint.to_affine_ints(j, jp)
    _assert_same(jpoint.from_affine_ints(j, qs), point.from_affine_ints(t, qs))
    cond = np.arange(N) % 2 == 0
    tq = point.from_affine_ints(t, qs)
    jq = jpoint.from_affine_ints(j, qs)
    _assert_same(
        jpoint.ec_select(jnp.asarray(cond), jp, jq),
        point.ec_select(torch.from_numpy(cond), tpt, tq),
    )
    _assert_same(jpoint.identity(j, (N,)), point.identity(t, (N,)))
