"""The IPA SRS of halo2_tpu_torch and its pieces, against the JAX package.

- the pinned VK of the tests/plonk_api.rs circuit over
  ``ParamsIPA.setup(5, VESTA)`` (the reference's SSWU SRS): the sha256 of its
  ``{:#?}`` string and its ``transcript_repr``, as the JAX package's
  test_plonk_api.py pins them; keygen commits every fixed and sigma column
  with Blind::default() = 1;
- SSWU ``hash_to_curve`` on Pallas and Vesta, ``batch_scalar_mul`` (n = 4)
  and ``g_to_lagrange`` (k = 2) against the JAX package's, in affine form;
- the device ``ParamsKZG.setup(4)`` (``batch_scalar_mul``) equal to
  ``setup_host(4)``;
- ``params_from_numpy`` / ``params_to_numpy`` round-trip a JAX ParamsIPA.

Tolerance: exact (equal ints or limb arrays); all of it is exact arithmetic.
"""

import hashlib

import numpy as np
import pytest
import torch

from halo2_tpu.curves import ALL_CURVES as JAX_CURVES
from halo2_tpu.curves import point as jpoint
from halo2_tpu.curves import sswu as jsswu
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.ops import gntt as jgntt
from halo2_tpu.ops import scalar_mul as jscalar_mul
from halo2_tpu.poly import ipa as jipa

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves import host, point
from halo2_tpu_torch.curves import sswu
from halo2_tpu_torch.curves.spec import ALL_CURVES, PALLAS, VESTA
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.ops import gntt
from halo2_tpu_torch.ops.scalar_mul import batch_scalar_mul
from halo2_tpu_torch.plonk import keygen_vk
from halo2_tpu_torch.plonk.rust_debug import pinned_vk_debug
from halo2_tpu_torch.poly import ipa
from halo2_tpu_torch.poly.kzg import ParamsKZG

from torch_circuits import StandardPlonkCircuit, plonk_api_common

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers


def _jax_curve(curve):
    (j,) = [c for c in JAX_CURVES if c.name == curve.name]
    return j


def _points(curve, n: int, seed: int):
    rs = np.random.default_rng(seed)
    g = host.generator(curve)
    return [host.mul(curve, g, int(k)) for k in rs.integers(1, 1 << 62, size=n)]


@pytest.fixture(scope="module")
def vesta_vk():
    params = ipa.ParamsIPA.setup(5, VESTA)  # the reference's "Halo2-Parameters" SRS
    return params, keygen_vk(params, StandardPlonkCircuit(Value.unknown(),
                                                          plonk_api_common(VESTA.scalar)[2]))


def test_pinned_vk_matches_rust_reference(vesta_vk):
    _, vk = vesta_vk
    got = pinned_vk_debug(vk, VESTA.base.p, VESTA.scalar.p, alternate=True)
    assert hashlib.sha256(got.encode()).hexdigest() == (
        "093a7bc1f3ccba4efcac3d5f4212b6b3edae1e4b2791b52078029ad00ae5146b"
    )
    assert vk.transcript_repr == 0x1CDCAD9331146096EFAE2CAA7B690FFA5870C98E90A8B7509DDA04D118A2AD38


def test_ipa_keygen_commits_with_the_default_blind(vesta_vk):
    """keygen.rs:247-250 commits with Blind::default() = 1, which IPA adds as
    one w; a blind of 0 gave the wrong pinned VK (ROADMAP §3)."""
    params, vk = vesta_vk
    fixed = vk.synthesis[3]
    want = point.to_affine_ints(VESTA, params.commit_lagrange_many(fixed, [1] * len(fixed)))
    assert vk.fixed_commitments == want
    unblinded = point.to_affine_ints(VESTA, params.commit_lagrange_many(fixed, [0] * len(fixed)))
    assert all(host.add(VESTA, a, params.w) == b for a, b in zip(unblinded, want))


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=lambda c: c.name)
def test_hash_to_curve_matches_jax(curve):
    msgs = [b"", b"\x00" + (7).to_bytes(4, "little"), b"\x01", b"\x02",
            np.random.default_rng(14).bytes(45)]
    for domain in ("Halo2-Parameters", "z.cash:test"):
        ours = sswu.hash_to_curve(curve, domain)
        theirs = jsswu.hash_to_curve(_jax_curve(curve), domain)
        for msg in msgs:
            pt = ours(msg)
            assert pt == theirs(msg) and host.on_curve(curve, pt)


def test_batch_scalar_mul_matches_jax():
    fr = PALLAS.scalar
    pts = _points(PALLAS, 4, 15)
    pts[1] = None  # the identity
    scalars = [0, 1, fr.p - 1, int(np.random.default_rng(16).integers(1, 1 << 62)) ** 4 % fr.p]
    got = point.to_affine_ints(PALLAS, batch_scalar_mul(
        PALLAS, limb.from_ints(fr, scalars), point.from_affine_ints(PALLAS, pts)))
    jc = _jax_curve(PALLAS)
    want = jpoint.to_affine_ints(jc, jscalar_mul.batch_scalar_mul(
        jc, jlimb.from_ints(jc.scalar, scalars), jpoint.from_affine_ints(jc, pts)))
    assert got == want == [host.mul(PALLAS, pt, s) for pt, s in zip(pts, scalars)]


def test_g_to_lagrange_matches_jax():
    k = 2
    pts = _points(PALLAS, 1 << k, 17)
    got = point.to_affine_ints(PALLAS, gntt.g_to_lagrange(
        PALLAS, point.from_affine_ints(PALLAS, pts), k))
    jc = _jax_curve(PALLAS)
    want = jpoint.to_affine_ints(jc, jgntt.g_to_lagrange(jc, jpoint.from_affine_ints(jc, pts), k))
    assert got == want
    # the Lagrange basis: sum_i L_i(X) * g_i-weights give back g at X = omega^j
    fr = PALLAS.scalar
    omega = pow(fr.root_of_unity, 1 << (fr.s - k), fr.p)
    n_inv = pow(1 << k, -1, fr.p)
    for i, got_i in enumerate(got):
        want_i = host.msm(PALLAS, [pow(omega, -i * j % (1 << k), fr.p) * n_inv % fr.p
                                   for j in range(1 << k)], pts)
        assert got_i == want_i


def test_device_kzg_setup_matches_setup_host():
    dev, hst = ParamsKZG.setup(4, seed=b"setup-equiv"), ParamsKZG.setup_host(4, seed=b"setup-equiv")
    assert dev.s == hst.s and dev.s_g2 == hst.s_g2
    for name in ("g", "g_lagrange"):
        a, b = getattr(dev, name), getattr(hst, name)
        assert point.to_affine_ints(dev.curve, a) == point.to_affine_ints(hst.curve, b)
        for ca, cb in zip(a, b):  # normalized: the limbs agree too
            assert torch.equal(ca, cb)


def test_params_from_numpy_roundtrips_a_jax_params():
    curve = PALLAS
    jc = _jax_curve(curve)
    g, gl = _points(curve, 8, 18), _points(curve, 8, 19)
    jparams = jipa.ParamsIPA(3, jc, jpoint.from_affine_ints(jc, g),
                             jpoint.from_affine_ints(jc, gl), g[0], gl[0])
    state = {
        "k": jparams.k, "curve": jc.name, "w": jparams.w, "u": jparams.u,
        **{name: tuple(np.asarray(c) for c in getattr(jparams, name))
           for name in ("g", "g_lagrange")},
    }
    params = ipa.params_from_numpy(state)
    assert params.curve in ALL_CURVES and params.curve.name == jc.name
    assert point.to_affine_ints(curve, params.g) == g
    assert point.to_affine_ints(curve, params.g_lagrange) == gl
    back = ipa.params_to_numpy(params)
    assert (back["k"], back["curve"], back["w"], back["u"]) == (3, jc.name, g[0], gl[0])
    for name in ("g", "g_lagrange"):
        for ours, theirs in zip(back[name], state[name]):
            assert ours.dtype == np.uint32
            np.testing.assert_array_equal(ours, theirs)
