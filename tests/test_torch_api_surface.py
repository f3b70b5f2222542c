"""The last public functions and methods of the port against the JAX package.

``limb.to_int`` / ``fdbl``, ``arith.eval_lagrange``, the polynomial algebra
of ``Poly``, the poly constructors and ``pinned()`` of ``EvaluationDomain``,
the permutation assembly's ``build_vk`` / ``build_pk``, ``VerifyingKey.pinned``
and the curve-less ``transcript_repr``, and ``ProvingKey.get_vk``.  Inputs
come from a numpy seed with 0, 1 and p-1 among them, at n = 16; the JAX side
runs on the CPU as its own tests run it.  Tolerance: exact limb equality,
and points in affine form.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.fields.spec import BN254_FR as J_BN254_FR
from halo2_tpu.fields.spec import PASTA_FP as J_PASTA_FP
from halo2_tpu.ops import arith as jarith
from halo2_tpu.plonk.circuit import ConstraintSystem as JConstraintSystem
from halo2_tpu.plonk.keygen import VerifyingKey as JVerifyingKey
from halo2_tpu.poly import domain as jdomain
from halo2_tpu.poly import polynomial as jpoly

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves import point
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.fields.spec import BN254_FR, PASTA_FP
from halo2_tpu_torch.ops import arith
from halo2_tpu_torch.plonk import keygen_pk, keygen_vk
from halo2_tpu_torch.plonk.keygen import VerifyingKey
from halo2_tpu_torch.plonk.permutation import PermutationVK
from halo2_tpu_torch.poly import polynomial
from halo2_tpu_torch.poly.domain import EvaluationDomain
from halo2_tpu_torch.poly.kzg import ParamsKZG

from circuits import StandardPlonkCircuit as JStandardPlonkCircuit
from torch_circuits import StandardPlonkCircuit, plonk_api_common

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

N = 16
FIELDS = {"bn254_fr": (BN254_FR, J_BN254_FR), "pasta_fp": (PASTA_FP, J_PASTA_FP)}
BASES = (polynomial.LAGRANGE, polynomial.COEFF, polynomial.EXTENDED)


def _ints(p: int, seed: int, n: int = N) -> list:
    """n canonical elements from a numpy seed, 0, 1 and p-1 in front."""
    rs = np.random.default_rng(seed)
    vals = [0, 1, p - 1]
    for row in rs.integers(0, 1 << 62, size=(n - 3, 5), dtype=np.int64):
        v = 0
        for w in row:
            v = (v << 62) | int(w)
        vals.append(v % p)
    return vals


def _both(spec, vals):
    """The same Montgomery limbs as a JAX array and a CPU tensor."""
    arr = limb.ints_to_limbs_np([spec.to_mont(v) for v in vals])
    return jnp.asarray(arr.astype(np.uint32)), torch.from_numpy(arr)


def _same(jax_out, torch_out) -> None:
    np.testing.assert_array_equal(np.asarray(jax_out).astype(np.int64),
                                  torch_out.numpy().astype(np.int64))


@pytest.mark.parametrize("name", FIELDS)
def test_to_int_fdbl_and_eval_lagrange_match_jax(name):
    spec, jspec = FIELDS[name]
    vals = _ints(spec.p, 1)
    ja, ta = _both(spec, vals)
    jl, tl = _both(spec, _ints(spec.p, 2)[::-1])
    for i in (0, 1, 2, 7):
        assert limb.to_int(spec, ta[:, i]) == jlimb.to_int(jspec, ja[:, i]) == vals[i]
        assert limb.to_int(spec, ta[:, i : i + 1]) == vals[i]
    dbl = limb.fdbl(spec, ta)
    _same(jlimb.fdbl(jspec, ja), dbl)
    assert limb.to_ints(spec, dbl) == [2 * v % spec.p for v in vals]
    ev = arith.eval_lagrange(spec, ta, tl)
    _same(jarith.eval_lagrange(jspec, ja, jl), ev)
    want = sum(a * b for a, b in zip(vals, limb.to_ints(spec, tl))) % spec.p
    assert limb.to_int(spec, ev) == want


@pytest.mark.parametrize("basis", BASES)
def test_poly_algebra_matches_jax(basis):
    spec, jspec = FIELDS["bn254_fr"]
    (ja, ta), (jb, tb) = (_both(spec, _ints(spec.p, s)) for s in (3, 4))
    jx, jy = jpoly.Poly(ja, basis), jpoly.Poly(jb, basis)
    x, y = polynomial.Poly(ta, basis), polynomial.Poly(tb, basis)
    assert len(x) == len(jx) == N
    for op in ("add", "sub", "mul_pointwise"):
        got = getattr(x, op)(spec, y)
        assert got.basis == basis
        _same(getattr(jx, op)(jspec, jy).values, got.values)
    for s in (0, 1, spec.p - 1, 5 * spec.zeta % spec.p):
        js, ts = _both(spec, [s])
        for scalar in (ts[:, 0], ts):  # (16,) and (16, 1)
            got = x.scale(spec, scalar)
            assert got.basis == basis
            _same(jx.scale(jspec, js[:, 0]).values, got.values)
    assert limb.to_ints(spec, x.sub(spec, x).values) == [0] * N


@pytest.mark.parametrize("rotation", ["cur", "prev", "next"])
def test_poly_rotate_matches_jax(rotation):
    spec = BN254_FR
    vals = _ints(spec.p, 5)
    ja, ta = _both(spec, vals)
    rot = getattr(polynomial.Rotation, rotation)()
    got = polynomial.Poly(ta, polynomial.LAGRANGE).rotate(rot)
    _same(jpoly.Poly(ja, jpoly.LAGRANGE).rotate(getattr(jpoly.Rotation, rotation)()).values,
          got.values)
    # rotate(r)[i] = values[i + r]: the reference's left rotation
    assert limb.to_ints(spec, got.values) == [vals[(i + rot.i) % N] for i in range(N)]


@pytest.mark.parametrize("k", [3, 4])
def test_domain_constructors_and_pinned_match_jax(k):
    spec, jspec = FIELDS["bn254_fr"]
    dom, jdom = EvaluationDomain(spec, 3, k, device="cpu"), jdomain.EvaluationDomain(jspec, 3, k)
    assert dom.pinned() == jdom.pinned()
    assert repr(dom.pinned()) == repr(jdom.pinned())
    for name in ("empty_lagrange", "empty_coeff", "empty_extended"):
        got, want = getattr(dom, name)(), getattr(jdom, name)()
        assert got.basis == want.basis and got.values.device == dom.device
        _same(want.values, got.values)
    js, ts = _both(spec, [7])
    got, want = dom.constant_lagrange(ts[:, 0]), jdom.constant_lagrange(js[:, 0])
    assert got.basis == want.basis
    _same(want.values, got.values)
    assert got.values.stride(1) == 0  # a view of the one element, as JAX's broadcast_to
    ja, ta = _both(spec, _ints(spec.p, 6, dom.n))
    for name in ("lagrange_from_vec", "coeff_from_vec"):
        got, want = getattr(dom, name)(ta), getattr(jdom, name)(ja)
        assert got.basis == want.basis and got.values is ta
        _same(want.values, got.values)


def test_mismatched_bases_and_shapes_raise_as_in_jax():
    spec, jspec = FIELDS["bn254_fr"]
    ja, ta = _both(spec, _ints(spec.p, 7))
    jdom, dom = jdomain.EvaluationDomain(jspec, 3, 3), EvaluationDomain(spec, 3, 3, device="cpu")
    for mod, vals, d in ((jpoly, ja, jdom), (polynomial, ta, dom)):
        lag, coeff = mod.Poly(vals, mod.LAGRANGE), mod.Poly(vals, mod.COEFF)
        for op in ("add", "sub", "mul_pointwise"):
            with pytest.raises(AssertionError):
                getattr(lag, op)(spec if mod is polynomial else jspec, coeff)
        with pytest.raises(AssertionError):
            coeff.rotate(mod.Rotation.next())
        for name in ("lagrange_from_vec", "coeff_from_vec"):
            with pytest.raises(AssertionError):  # n = 16 against the domain's 8
                getattr(d, name)(vals)


# ---------------------------------------------------------------------------
# keys: the tests/plonk_api.rs circuit at k=5, as the pins use it
# ---------------------------------------------------------------------------

K = 5


@pytest.fixture(scope="module")
def kzg():
    params = ParamsKZG.setup_host(K, seed=b"plonk-api", device="cpu")
    empty = StandardPlonkCircuit(Value.unknown(), plonk_api_common(BN254_FR)[2])
    vk = keygen_vk(params, empty)
    return params, vk, keygen_pk(params, vk, empty)


def test_get_vk_is_the_keys_vk(kzg):
    _, vk, pk = kzg
    assert pk.get_vk() is pk.vk is vk


def test_curveless_vk_pinned_and_transcript_repr_match_jax(kzg):
    """A VK without a curve hashes repr(pinned()): the JAX one, built from
    the JAX twin's ConstraintSystem and a JAX domain over the port's
    commitments, must give the same string and the same scalar."""
    _, vk, _ = kzg
    args = (vk.fixed_commitments, vk.permutation_commitments, vk.selectors)
    ours = VerifyingKey(vk.domain, vk.cs, *args)
    jcs = JConstraintSystem()
    JStandardPlonkCircuit.configure(jcs)
    theirs = JVerifyingKey(jdomain.EvaluationDomain(J_BN254_FR, jcs.degree(), K), jcs, *args)
    assert ours.curve is None
    assert repr(ours.pinned()) == repr(theirs.pinned())
    assert ours.transcript_repr == theirs.transcript_repr
    assert ours.transcript_repr != vk.transcript_repr  # the keyed one hashes Rust's Debug form


def test_permutation_build_vk_and_build_pk_match_keygen(kzg):
    """build_vk commits each sigma on its own; keygen batches them in one
    MSM: the same group elements.  build_pk gives the pk's polys and cosets."""
    params, vk, pk = kzg
    domain, cs, assembly = vk.synthesis[:3]
    pvk = assembly.permutation.build_vk(params, domain, cs.permutation)
    assert isinstance(pvk, PermutationVK)
    got = [point.to_affine_ints(BN254_G1, c)[0] for c in pvk.commitments]
    assert got == vk.permutation_commitments
    ppk = assembly.permutation.build_pk(params, domain, cs.permutation)
    for name in ("permutations", "polys", "cosets"):
        ours, theirs = getattr(ppk, name), getattr(pk.permutation, name)
        assert len(ours) == len(theirs) == len(cs.permutation.columns)
        for a, b in zip(ours, theirs):
            assert a.basis == b.basis and torch.equal(a.values, b.values)
