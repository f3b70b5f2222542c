"""The lookup's permuted columns on limbs against the JAX package's host matching.

``prover.permute_expression_pair_dev`` (on the CPU: ``ops/lookup.py``'s
plain version, the same steps as the kernels on the card) must give, limb for
limb, the JAX package's ``_permute_expression_pair`` ints in Montgomery form,
draw the same values from the rng and leave it at the same counter, and
raise ``ConstraintSystemFailure`` where the JAX function does.  The columns
are numpy-seeded; exact comparison, since all of it is exact arithmetic.
The key and sort steps are held to Python's ``sorted`` of the canonical ints.
"""

import numpy as np
import pytest
import torch

from halo2_tpu.curves.spec import BN254_G1 as JAX_BN254_G1
from halo2_tpu.plonk import prover as jprover
from halo2_tpu.plonk.error import ConstraintSystemFailure as JaxConstraintSystemFailure
from halo2_tpu.utils.rng import FieldRng as JaxFieldRng

from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.ops import lookup as lookup_ops
from halo2_tpu_torch.plonk import prover
from halo2_tpu_torch.plonk.error import ConstraintSystemFailure
from halo2_tpu_torch.utils import profiling
from halo2_tpu_torch.utils.rng import FieldRng

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

SPEC = BN254_G1.scalar
P = SPEC.p
N, BF = 128, 10
USABLE = N - BF - 1


def _wide(rs, size):
    """Values spread over the whole 256-bit key: each 64-bit word drawn from
    {0, 1, 2^63, 2^64 - 1} or at random, so that equal top words send the
    order down to the lower ones, and some values near p."""
    specials = [0, 1, 1 << 63, (1 << 64) - 1]
    out = []
    for _ in range(size):
        v = 0
        for _ in range(4):
            w = specials[int(rs.integers(0, 4))] if rs.random() < 0.6 else int(
                rs.integers(0, 1 << 63)) * 2 + int(rs.integers(0, 2))
            v = (v << 64) | w
        out.append(v % P)
    out[: 3] = [P - 1, P - 2, P - (1 << 200)]
    return out


def _case(name: str):
    """(input column, table column) of N values each; the rows past USABLE
    are noise that the matching must not read."""
    rs = np.random.default_rng(sum(map(ord, name)))
    noise = [int(v) for v in rs.integers(0, 1 << 62, size=N - USABLE)]
    if name == "sha_like":  # distinct values, then padding rows repeating row 0's
        distinct = sorted({int(v) for v in rs.integers(0, 1 << 48, size=USABLE // 2)})
        table = distinct + [distinct[0]] * (USABLE - len(distinct))
        inputs = [table[int(i)] for i in rs.integers(0, USABLE, size=USABLE)]
    elif name == "all_equal":
        table = [int(v) for v in rs.integers(0, 1 << 40, size=USABLE)]
        inputs = [table[17]] * USABLE
    elif name == "descending":
        table = [int(v) for v in rs.integers(0, 1 << 40, size=USABLE)]
        table[3] = table[7] = table[9]
        inputs = sorted((table[int(i)] for i in rs.integers(0, USABLE, size=USABLE)), reverse=True)
    elif name == "near_p":
        table = _wide(rs, USABLE)
        table[20:26] = [table[2]] * 6
        inputs = [table[int(i)] for i in rs.integers(0, USABLE, size=USABLE)]
    else:
        raise ValueError(name)
    return inputs + noise, table + noise[::-1]


def _limbs(vals):
    return limb.from_ints(SPEC, vals, "cpu")


@pytest.mark.parametrize("name", ["sha_like", "all_equal", "descending", "near_p"])
def test_permuted_columns_equal_the_jax_host_matching(name):
    inputs, table = _case(name)
    jrng = JaxFieldRng(JAX_BN254_G1.scalar, b"perm")
    want_in, want_tab = jprover._permute_expression_pair(None, jrng, inputs, table, N, BF)
    rng = FieldRng(SPEC, b"perm")
    got_in, got_tab = prover.permute_expression_pair_dev(
        SPEC, rng, _limbs(inputs), _limbs(table), N, BF)
    assert torch.equal(got_in, _limbs(want_in))
    assert torch.equal(got_tab, _limbs(want_tab))
    assert rng.counter == jrng.counter == 2 * (BF + 1)
    # the host function of the port, which the device function replaced, agrees too
    assert prover._permute_expression_pair(FieldRng(SPEC, b"perm"), inputs, table, N, BF) == (
        want_in, want_tab)


@pytest.mark.parametrize("name", ["sha_like", "near_p"])
def test_a_missing_input_value_raises_before_any_draw(name):
    inputs, table = _case(name)
    present = set(table[:USABLE])
    missing = (table[0] + 1) % P
    while missing in present:
        missing = (missing + 1) % P
    inputs[USABLE // 2] = missing
    jrng = JaxFieldRng(JAX_BN254_G1.scalar, b"perm")
    with pytest.raises(JaxConstraintSystemFailure):
        jprover._permute_expression_pair(None, jrng, inputs, table, N, BF)
    rng = FieldRng(SPEC, b"perm")
    with pytest.raises(ConstraintSystemFailure, match="lookup input not in table"):
        prover.permute_expression_pair_dev(SPEC, rng, _limbs(inputs), _limbs(table), N, BF)
    assert rng.counter == jrng.counter == 0


@pytest.mark.parametrize("name", ["sha_like", "near_p"])
def test_sort_keys_order_is_the_canonical_ints_order(name):
    inputs, table = _case(name)
    vals = inputs + table
    canon = limb.ints_to_limbs_np(vals)
    keys = lookup_ops.sort_keys(torch.from_numpy(canon))
    idx = lookup_ops.sort_order(keys.unsqueeze(0))[0].tolist()
    assert [vals[i] for i in idx] == sorted(vals)
    # stable: equal values keep their column order
    assert all(idx[j] < idx[j + 1] for j in range(len(idx) - 1) if vals[idx[j]] == vals[idx[j + 1]])


def test_the_matching_pulls_one_flag(monkeypatch):
    """One ``limb: device to host`` span a matching: the missing-value flag,
    where the port pulled both columns before."""
    inputs, table = _case("sha_like")
    monkeypatch.setenv("HALO2_TPU_PROFILE", "1")
    profiling.report(reset=True)
    prover.permute_expression_pair_dev(SPEC, FieldRng(SPEC, b"perm"), _limbs(inputs),
                                       _limbs(table), N, BF)
    report = {name: calls for name, calls, _ in profiling.report(reset=True)}
    assert report == {"limb: device to host": 1}


def test_an_expanded_column_is_matched_like_a_full_one():
    """A constant expression's values reach the matching as an expanded
    (16, n) view."""
    _, table = _case("sha_like")
    value = table[5]
    col = limb.from_int(SPEC, value, "cpu").reshape(16, 1).expand(16, N)
    got_in, got_tab = prover.permute_expression_pair_dev(
        SPEC, FieldRng(SPEC, b"perm"), col, _limbs(table), N, BF)
    want_in, want_tab = jprover._permute_expression_pair(
        None, JaxFieldRng(JAX_BN254_G1.scalar, b"perm"), [value] * N, table, N, BF)
    assert torch.equal(got_in, _limbs(want_in)) and torch.equal(got_tab, _limbs(want_tab))


def test_the_kernel_wrapper_takes_only_card_tensors():
    """The device is chosen once, in ``lookup_permute``: ``lookup_match``
    launches the kernels and refuses CPU tensors instead of taking the plain
    version itself."""
    inputs, table = _case("sha_like")
    ci, ct = _limbs(inputs), _limbs(table)
    skeys, idx = lookup_ops._sorted(SPEC, ci, ct, USABLE, lookup_ops.mont_mul_plain)
    with pytest.raises(ValueError, match="CUDA"):
        lookup_ops.lookup_match(skeys, idx, ci, ct)
