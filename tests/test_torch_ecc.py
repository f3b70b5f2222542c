"""The ECC gadget in halo2_tpu_torch against the JAX package.

The fixed-base constants (window tables, Lagrange coefficients, z/u values)
equal the JAX package's; the add, witness, fixed-base and variable-base mul
circuits of tests/test_ecc_gadget.py and tests/test_ecc_mul_fixed.py give the
JAX package's per-row MockProver failure lists, Display strings included, on
both of the port's paths.  The port reads its z/u values from its own copy of
``fixed_base_zs_us.json`` and never writes it: a base missing there is
searched once and kept in memory.  The last test checks that the JAX
package's file is unchanged after this module ran, and that the copy equals it.
"""

import hashlib
import os

import pytest
import torch

import test_ecc_gadget as jecc
import test_ecc_mul_fixed as jmf
import torch_circuits as tc
from torch_circuits import failure_summary as summary
import halo2_tpu.gadgets.ecc.mul_fixed as jax_mul_fixed
from halo2_tpu.circuit import Value as JV
from halo2_tpu.dev import MockProver as JaxMockProver
from halo2_tpu.fields.spec import PASTA_FP as JAX_FP
import halo2_tpu_torch.gadgets.ecc.mul_fixed as mul_fixed
from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves import PALLAS, host
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.fields.spec import PASTA_FP

torch.set_num_threads(1)  # host-bound synthesis and small limb tensors; xdist runs several workers

P = PASTA_FP.p
BASE = tc.FIXED_BASE
JAX_ZS_US = jax_mul_fixed._ZS_US_CACHE_PATH
ZS_US_SHA256 = "dc7f3011864b05d101789c90da8c74aeb4af307148dbdbfebe57001488fbafbb"  # as committed


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


JAX_ZS_US_AT_IMPORT = _sha256(JAX_ZS_US)


def test_fixed_base_constants_equal_jax():
    assert BASE == jmf.BASE and tc.G == jecc.G
    params = mul_fixed.FixedPointParams(BASE, mul_fixed.NUM_WINDOWS)
    table = params.window_table
    assert table == jmf.BASE_PARAMS.window_table
    assert params.lagrange_coeffs == jmf.BASE_PARAMS.lagrange_coeffs
    # one entry per window with the +2 offsets cancels to [k]B
    acc = None
    for w, k in enumerate([1] + [0] * (mul_fixed.NUM_WINDOWS - 1)):
        acc = host.add(PALLAS, acc, table[w][k])
    assert acc == BASE
    for w in (0, 7, mul_fixed.NUM_WINDOWS - 1):
        for k in range(mul_fixed.H):
            x = sum(c * pow(k, d, P) for d, c in enumerate(params.lagrange_coeffs[w])) % P
            assert x == table[w][k][0]
    assert mul_fixed.lagrange_interpolate([0, 1, 2], [5, 7, 11], P) == \
        jax_mul_fixed.lagrange_interpolate([0, 1, 2], [5, 7, 11], P)


@pytest.mark.parametrize("windows", [3, mul_fixed.NUM_WINDOWS_SHORT, mul_fixed.NUM_WINDOWS])
def test_zs_and_us_equal_jax(windows):
    """The values the copy carries equal the JAX file's, and have the z/u
    property: u^2 = z + y, and z - y is a non-square, for every y."""
    zs_us = mul_fixed.FixedPointParams(BASE, windows).zs_and_us
    assert zs_us == jax_mul_fixed.FixedPointParams(BASE, windows).zs_and_us
    if windows == 3:
        for (z, us), window in zip(zs_us, mul_fixed.compute_window_table(BASE, 3)):
            for u, (_, y) in zip(us, window):
                assert u * u % P == (z + y) % P
                assert PASTA_FP.sqrt((z - y) % P) is None


def test_zs_and_us_miss_is_searched_in_memory(monkeypatch):
    """A base missing from the file is searched once and kept in memory; the
    package's tree is not written."""
    here = os.path.dirname(mul_fixed.__file__)
    before = {name: os.stat(os.path.join(here, name)).st_mtime_ns for name in os.listdir(here)}
    calls = []

    def search(base, num_windows):  # stands in for the ~13 s a window of the real search
        calls.append((base, num_windows))
        return [(num_windows, [0] * mul_fixed.H)]

    monkeypatch.setattr(mul_fixed, "find_zs_and_us", search)
    monkeypatch.setattr(mul_fixed, "_ZS_US_FOUND", {})  # the stub's values leave with the test
    found = mul_fixed.FixedPointParams(tc.G3, 2).zs_and_us
    assert found == [(2, [0] * mul_fixed.H)] and calls == [(tc.G3, 2)]
    assert mul_fixed.FixedPointParams(tc.G3, 2).zs_and_us is found
    assert mul_fixed.FixedPointParams(BASE, 3).zs_and_us != found and len(calls) == 1
    after = {name: os.stat(os.path.join(here, name)).st_mtime_ns for name in os.listdir(here)}
    assert before == after


def _jax_add(name):
    p, q, expected, complete = {
        "incomplete": (jecc.G, jecc.G2, jecc.G3, False),
        "distinct": (jecc.G, jecc.G2, jecc.G3, True),
        "doubling": (jecc.G, jecc.G, jecc.G2, True),
        "identity_left": (None, jecc.G, jecc.G, True),
        "identity_right": (jecc.G, None, jecc.G, True),
        "inverse": (jecc.G, host.neg(PALLAS, jecc.G), None, True),
        "off_curve": ((jecc.G[0], (jecc.G[1] + 1) % P), jecc.G2, None, True),
    }[name]
    return jecc.AddCircuit(JV.known((0, 0) if p is None else p),
                           JV.known((0, 0) if q is None else q), expected, complete)


def _compare(k, port, jax, tamper=None):
    prover = MockProver.run(PASTA_FP, k, port, [], device="cpu")
    jprover = JaxMockProver.run(JAX_FP, k, jax, [])
    if tamper is not None:
        tamper(prover)
        tamper(jprover)
    want = summary(jprover.verify(vectorized=False))
    assert summary(prover.verify(vectorized=False)) == want
    assert summary(prover.verify(vectorized=True)) == want
    return want


@pytest.mark.parametrize("name", list(tc.add_cases()))
def test_add_equals_jax(name):
    """k = 5: every add case is satisfied; an off-curve point is rejected."""
    want = _compare(5, tc.add_cases()[name], _jax_add(name))
    assert bool(want) == (name == "off_curve")


FIXED = {  # name -> (port circuit, JAX circuit, k, rejected)
    "full_small": (lambda: tc.fixed_mul_full(0xABCDEF0123456789),
                   lambda: jmf.FixedMulCircuit(JV.known(0xABCDEF0123456789), host.mul(
                       PALLAS, BASE, 0xABCDEF0123456789)), 9, False),
    "full_q_minus_1": (lambda: tc.fixed_mul_full(mul_fixed.FQ - 1),
                       lambda: jmf.FixedMulCircuit(JV.known(mul_fixed.FQ - 1), host.mul(
                           PALLAS, BASE, mul_fixed.FQ - 1)), 9, False),
    "full_over_2_254": (lambda: tc.fixed_mul_full((1 << 254) + 12345),
                        lambda: jmf.FixedMulCircuit(JV.known((1 << 254) + 12345), host.mul(
                            PALLAS, BASE, ((1 << 254) + 12345) % mul_fixed.FQ)), 9, False),
    "short_max_positive": (lambda: tc.fixed_mul_short(0xFFFFFFFFFFFFFFFF, 1),
                           lambda: jmf.FixedMulCircuit(JV.known((0xFFFFFFFFFFFFFFFF, 1)), host.mul(
                               PALLAS, BASE, 0xFFFFFFFFFFFFFFFF), short=True), 9, False),
    "short_negative": (lambda: tc.fixed_mul_short(12345678, -1),
                       lambda: jmf.FixedMulCircuit(JV.known((12345678, -1)), host.mul(
                           PALLAS, BASE, -12345678 % mul_fixed.FQ), short=True), 9, False),
    "short_oversized": (lambda: tc.FixedMulCircuit(Value.known(((1 << 64) + 3, 1)), None,
                                                   short=True),
                        lambda: jmf.FixedMulCircuit(JV.known(((1 << 64) + 3, 1)), None,
                                                    short=True), 9, True),
    "base_field_small": (lambda: tc.BaseFieldMulCircuit.of(0x123456789ABCDEF),
                         lambda: jmf.BaseFieldMulCircuit(JV.known(0x123456789ABCDEF), host.mul(
                             PALLAS, BASE, 0x123456789ABCDEF)), 11, False),
}


@pytest.mark.parametrize("name", list(FIXED))
def test_mul_fixed_equals_jax(name):
    make, make_jax, k, rejected = FIXED[name]
    want = _compare(k, make(), make_jax())
    assert bool(want) == rejected


def test_base_field_rejects_wrong_point():
    """The canonicity test's check: a wrong expected point fails synthesis,
    in both packages."""
    with pytest.raises(AssertionError):
        MockProver.run(PASTA_FP, 11, tc.BaseFieldMulCircuit.of(67890, host.mul(
            PALLAS, BASE, 12345)), [], device="cpu")
    with pytest.raises(AssertionError):
        JaxMockProver.run(JAX_FP, 11, jmf.BaseFieldMulCircuit(JV.known(67890), host.mul(
            PALLAS, BASE, 12345)), [])


@pytest.mark.slow
def test_base_field_msb_set_equals_jax():
    want = _compare(11, tc.BaseFieldMulCircuit.of(P - 1),
                    jmf.BaseFieldMulCircuit(JV.known(P - 1), host.mul(PALLAS, BASE, (P - 1)
                                                                      % mul_fixed.FQ)))
    assert want == []


@pytest.mark.parametrize("flip", [False, True])
def test_variable_base_mul_equals_jax(flip):
    """k = 11: [k]G for a 253-bit k; a 2 in the bit column fails "bit boolean"."""
    scalar = tc.VAR_MUL_SCALAR
    expected = host.mul(PALLAS, tc.G, scalar)
    want = _compare(11, tc.MulCircuit(Value.known(scalar), Value.known(tc.G), expected),
                    jecc.MulCircuit(JV.known(scalar), JV.known(jecc.G), expected),
                    tc.flip_mul_bit if flip else None)
    if flip:
        assert ("ConstraintNotSatisfied", "bit boolean") in {(f[0], f[2]) for f in want}
    else:
        assert want == []


def test_zs_us_files_unchanged():
    """After this module: the JAX package's file is as it was at import and as
    committed, and the port's copy is byte-equal to it."""
    port = mul_fixed._ZS_US_CACHE_PATH
    assert _sha256(JAX_ZS_US) == JAX_ZS_US_AT_IMPORT == ZS_US_SHA256
    with open(JAX_ZS_US, "rb") as f, open(port, "rb") as g:
        assert f.read() == g.read()
