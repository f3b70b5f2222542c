"""halo2_tpu_torch MSM, NTT and polynomial arithmetic against the JAX package.

MSM results are compared in affine form against ``halo2_tpu.curves.host.msm``
(the port's Straus MSM may end at another projective Z).  The six-step NTT,
iNTT, coset extension and the vanishing division are compared limb for limb
with ``halo2_tpu.poly.domain.EvaluationDomain`` at k in {2, 5}, and the port
alone against a naive Python-int DFT at the regression shapes k in
{9, 10, 13} of tests/test_ntt.py.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.curves import host as jhost
from halo2_tpu.curves.spec import BN254_G1 as J_G1
from halo2_tpu.ops import arith as jarith
from halo2_tpu.ops import ntt as jntt
from halo2_tpu.poly import domain as jdomain
from halo2_tpu.poly.polynomial import LAGRANGE as J_LAGRANGE
from halo2_tpu.poly.polynomial import Poly as JPoly
from halo2_tpu.poly.polynomial import Rotation as JRotation

from halo2_tpu_torch.curves import host, point
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.ops import arith, msm as msm_ops, ntt as ntt_ops
from halo2_tpu_torch.poly.domain import EvaluationDomain
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.poly.polynomial import LAGRANGE, Poly, Rotation

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

FR = BN254_G1.scalar
P = FR.p


def _ints(seed: int, n: int) -> list:
    rs = np.random.default_rng(seed)
    raw = rs.integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
    out = []
    for row in raw:
        v = 0
        for w in row:
            v = (v << 62) | int(w)
        out.append(v % P)
    return out


def _mont_np(vals) -> np.ndarray:
    return limb.ints_to_limbs_np([FR.to_mont(v) for v in vals]).astype(np.uint32)


def _both(arr):
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32))


def _assert_same(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.int64), torch_out.numpy().astype(np.int64)
    )


# ---------------------------------------------------------------------------
# MSM
# ---------------------------------------------------------------------------


def _msm_case(n: int, seed: int):
    rs = np.random.default_rng(seed)
    g = host.generator(BN254_G1)
    pts = [host.mul(BN254_G1, g, int(k)) for k in rs.integers(1, 1 << 62, size=n)]
    scalars = _ints(seed, n)
    scalars[0] = P - 1
    if n > 2:
        scalars[1] = 0
    return scalars, pts


@pytest.mark.parametrize("n,c", [(1, 0), (5, 0), (64, 0), (5, 5)])
def test_msm_matches_host(n, c):
    scalars, pts = _msm_case(n, seed=n + c)
    got = msm_ops.msm(
        BN254_G1, limb.from_ints(FR, scalars), point.from_affine_ints(BN254_G1, pts), c
    )
    assert point.to_affine_ints(BN254_G1, got) == [jhost.msm(J_G1, scalars, pts)]


def test_msm_many_matches_host():
    n, m = 5, 3
    _, pts = _msm_case(n, seed=11)
    cols = [_ints(20 + i, n) for i in range(m)]
    stacked = torch.stack([limb.from_ints(FR, c) for c in cols])
    got = msm_ops.msm_many(BN254_G1, stacked, point.from_affine_ints(BN254_G1, pts))
    assert point.to_affine_ints(BN254_G1, got) == [jhost.msm(J_G1, c, pts) for c in cols]


def test_kzg_commits_match_host():
    params = ParamsKZG.setup_host(3, seed=b"commit-test", device="cpu")
    g = point.to_affine_ints(BN254_G1, params.g)
    g_lag = point.to_affine_ints(BN254_G1, params.g_lagrange)
    vals = _ints(60, 8)
    got = params.commit_lagrange(Poly(limb.from_ints(FR, vals), LAGRANGE))
    assert point.to_affine_ints(BN254_G1, got) == [jhost.msm(J_G1, vals, g_lag)]
    got = params.commit_coeffs(limb.from_ints(FR, vals[:5]))
    assert point.to_affine_ints(BN254_G1, got) == [jhost.msm(J_G1, vals[:5], g[:5])]


def test_signed_digits_recompose():
    """The Booth recode reassembles every scalar, for both window widths."""
    vals = [0, 1, P - 1] + _ints(3, 5)
    canon = torch.from_numpy(limb.ints_to_limbs_np(vals))
    for c in (4, 5):
        digits = msm_ops._signed_digits(canon, c).numpy()
        assert digits.min() >= -(1 << (c - 1)) and digits.max() <= 1 << (c - 1)
        back = [sum(int(d) << (c * w) for w, d in enumerate(digits[:, i])) for i in range(len(vals))]
        assert back == vals


# ---------------------------------------------------------------------------
# NTT, cosets, vanishing division
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 5])
def test_domain_transforms_match_jax(k):
    jd = jdomain.EvaluationDomain(J_G1.scalar, 3, k)
    td = EvaluationDomain(FR, 3, k, device="cpu")
    assert (td.extended_k, td.omega, td.extended_omega) == (jd.extended_k, jd.omega, jd.extended_omega)
    ja, ta = _both(_mont_np(_ints(k, 1 << k)))

    jc = jd.lagrange_to_coeff(JPoly(ja, J_LAGRANGE))
    tc = td.lagrange_to_coeff(Poly(ta, LAGRANGE))
    _assert_same(jc.values, tc.values)
    _assert_same(jd.coeff_to_lagrange(jc).values, td.coeff_to_lagrange(tc).values)
    je = jd.coeff_to_extended(jc)
    te = td.coeff_to_extended(tc)
    _assert_same(je.values, te.values)
    _assert_same(jd.extended_to_coeff(je), td.extended_to_coeff(te))
    _assert_same(
        jd.divide_by_vanishing_poly(je).values, td.divide_by_vanishing_poly(te).values
    )
    for i in (-1, 1):
        _assert_same(
            jd.rotate_extended(je, JRotation(i)).values, td.rotate_extended(te, Rotation(i)).values
        )
    _assert_same(
        jntt.distribute_powers(J_G1.scalar, jc.values, jd._omega_pows_full),
        ntt_ops.distribute_powers(FR, tc.values, td._omega_pows_full),
    )


def _naive_dft_at(vals, omega, rows):
    """out[i] = sum_j vals[j] * omega^(i*j) for i in rows, on host ints."""
    n = len(vals)
    pows = [1] * n  # omega^t, t < n (omega^n = 1)
    for t in range(1, n):
        pows[t] = pows[t - 1] * omega % P
    return [sum(v * pows[i * j % n] for j, v in enumerate(vals)) % P for i in rows]


@pytest.mark.parametrize("k", [9, 10, 13])
def test_ntt_sixstep_matches_naive_dft(k):
    n = 1 << k
    omega = pow(FR.root_of_unity, 1 << (FR.s - k), P)
    vals = _ints(100 + k, n)
    tw = ntt_ops.power_table(FR, omega, n // 2)
    out = limb.to_ints(
        FR, ntt_ops.ntt_sixstep(FR, limb.from_ints(FR, vals), tw, ntt_ops.cross_twiddles(FR, omega, k), k)
    )
    # every output up to k=10; at k=13, n^2 host products is too many: sampled
    # outputs, and the roundtrip below covers the rest
    rows = range(n) if k <= 10 else (0, 1, 2, n // 2, n - 1, 12345 % n)
    assert [out[i] for i in rows] == _naive_dft_at(vals, omega, rows)
    omega_inv = pow(omega, -1, P)
    back = ntt_ops.intt_sixstep(
        FR,
        limb.from_ints(FR, out),
        ntt_ops.power_table(FR, omega_inv, n // 2),
        ntt_ops.cross_twiddles(FR, omega_inv, k),
        k,
        limb.from_int(FR, pow(n, -1, P)),
    )
    assert limb.to_ints(FR, back) == vals


# ---------------------------------------------------------------------------
# polynomial arithmetic
# ---------------------------------------------------------------------------


def test_kate_division_matches_jax():
    coeffs = _ints(7, 16)
    b = _ints(8, 1)[0]
    ja, ta = _both(_mont_np(coeffs))
    _assert_same(jarith.kate_division(J_G1.scalar, ja, b), arith.kate_division(FR, ta, b))


def test_eval_polynomials_batched_matches_jax():
    m, n = 3, 16
    coeffs = np.stack([_mont_np(_ints(30 + i, n)) for i in range(m)], axis=1)  # (16, m, n)
    xs = _mont_np(_ints(40, m))
    jc, tc = _both(coeffs)
    jx, tx = _both(xs)
    out = arith.eval_polynomials_batched(FR, tc, tx)
    _assert_same(jarith.eval_polynomials_batched(J_G1.scalar, jc, jx), out)
    # and against Horner on host ints
    for i in range(m):
        cs = limb.to_ints(FR, torch.from_numpy(coeffs[:, i].astype(np.int32)))
        x = limb.to_ints(FR, torch.from_numpy(xs[:, i : i + 1].astype(np.int32)))[0]
        acc = 0
        for c_ in reversed(cs):
            acc = (acc * x + c_) % P
        assert limb.to_ints(FR, out[:, i : i + 1]) == [acc]


def test_reduce_add_and_lagrange_interpolate_match_jax():
    vals = _ints(50, 13)
    ja, ta = _both(_mont_np(vals))
    _assert_same(jarith.reduce_add(J_G1.scalar, ja), arith.reduce_add(FR, ta))
    pts, evs = _ints(51, 4), _ints(52, 4)
    assert arith.lagrange_interpolate(FR, pts, evs) == jarith.lagrange_interpolate(
        J_G1.scalar, pts, evs
    )
