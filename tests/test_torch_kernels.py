"""The CUDA kernels K1-K4, B1 and B2 and the chain entries of K1 and K3
against their plain torch versions, on a card.

Every test here needs a CUDA device and skips without one: the kernels have
no CPU mode.  The plain versions are held to the JAX package by the CPU
tests (test_torch_fields.py, test_torch_curves.py); here the kernels are held
to the plain versions, exactly, on all four fields and all three curves, K1
on the Pasta fields at n = 2^16 and K2/K3 on Pallas and Vesta at n = 2^14;
``mont_pow``, ``ec_scalar_mul`` and ``ec_horner`` on every field or curve;
``batch_scalar_mul`` and the device KZG setup, which run on the chains,
against the host; the MSM entries ``msm_digits``, ``ec_window_table`` and
``ec_window_fold`` (``csrc/msm.cu``) against theirs, and ``msm_many`` on the
card through them alone; K1's field entries ``field_add`` / ``field_sub`` /
``field_neg`` (``csrc/field_ops.cu``) and transform entry ``stockham_axis``
(``csrc/ntt.cu``) against theirs, with the six-step on it against the plain
stage loop, and K1 reading a broadcast operand in place; the last public
functions of the port (``limb.fdbl`` / ``to_int``, ``arith.eval_lagrange``,
``Poly``'s algebra, the domain's constructors) on the card against the same
calls on the CPU, with their launches, and the domain's default device; the
lookup's matching (``ops/lookup.py``, ``csrc/lookup.cu``) against its plain
version and the host matching up to 2^17 rows, and its one pull a lookup in a
pinned proof.
On a host with two or more cards, the sharded NTT,
iNTT and MSM (``parallel/``) over meshes of distinct cards against one card,
each shard's tables on its own card, and the k=6 proof over a mesh of
distinct cards against its pin.
This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

from halo2_tpu_torch import _cuda
from halo2_tpu_torch.bench import int_chains as ic
from halo2_tpu_torch.bench import roofline
from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves import ALL_CURVES, host, point
from halo2_tpu_torch.curves import ec_kernels as ec
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.fields import ALL_FIELDS, field_ops, limb
from halo2_tpu_torch.fields.mont_mul import (
    mont_mul, mont_mul_plain, mont_mul_tiled, mont_pow, mont_pow_plain,
)
from halo2_tpu_torch.ops import msm as msm_ops
from halo2_tpu_torch.ops import ntt as ntt_ops

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _values(p: int, seed: int, n: int) -> list:
    rs = np.random.default_rng(seed)
    raw = rs.integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
    vals = []
    for row in raw:
        v = 0
        for w in row:
            v = (v << 62) | int(w)
        vals.append(v % p)
    return ([0, 1, p - 1] + vals)[:n]


@pytest.mark.parametrize("name", [f.name for f in ALL_FIELDS])
@pytest.mark.parametrize("n", [1, 255, 4099])
def test_mont_mul_kernel_matches_plain(dev, name, n):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    a = limb.from_ints(f, _values(f.p, 1, n), dev)
    b = limb.from_ints(f, _values(f.p, 2, n)[::-1], dev)
    assert torch.equal(mont_mul(f, a, b), mont_mul_plain(f, a, b))


@pytest.mark.parametrize("name", [f.name for f in ALL_FIELDS])
@pytest.mark.parametrize("n", [1, 511, 513, 4099])
def test_mont_mul_tiled_kernel_matches_plain_and_k1(dev, name, n):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    a = limb.from_ints(f, _values(f.p, 1, n), dev)
    b = limb.from_ints(f, _values(f.p, 2, n)[::-1], dev)
    got = mont_mul_tiled(f, a, b)
    assert torch.equal(got, mont_mul_plain(f, a, b))
    assert torch.equal(got, mont_mul(f, a, b))


def _chain_input(dev, shape=(33, 128)):
    x = np.random.default_rng(8).integers(0, 1 << 32, size=shape, dtype=np.uint64)
    x = x.astype(np.uint32)
    x.reshape(-1)[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return torch.from_numpy(x.view(np.int32)).to(dev)


@pytest.mark.parametrize("iters", [0, 1, 17, 300])
@pytest.mark.parametrize("form", ["lo", "wide", "hi", "addmask"])
def test_chain_kernels_match_plain(dev, form, iters):
    x = _chain_input(dev)
    if form == "addmask":
        got, want = ic.int_addmask_chain(x, iters), ic.int_addmask_plain(x, iters)
    else:
        got, want = ic.int_muladd_chain(x, iters, form), ic.int_muladd_plain(x, iters, form)
    assert torch.equal(got, want)


def test_chain_wrappers_check_operands_and_count_launches(dev):
    x = _chain_input(dev)
    for fn in (ic.int_muladd_chain, ic.int_addmask_chain):
        with pytest.raises(ValueError, match="int32"):
            fn(x.long(), 4)
        with pytest.raises(ValueError, match="contiguous"):
            fn(x[:, ::2], 4)
        with pytest.raises(ValueError, match="iters"):
            fn(x, -1)
        with pytest.raises(ValueError, match="CUDA"):
            fn(x.to("meta"), 4)
        before = fn.launches
        fn(x, 4)
        assert fn.launches == before + 1
        assert fn(x[:0], 4).shape == (0, 128)
        assert fn.launches == before + 1  # nothing to launch for an empty operand
    with pytest.raises(ValueError, match="form"):
        ic.int_muladd_chain(x, 4, "wider")


def test_graph_chain_counts_the_replayed_launches(dev):
    f = ALL_FIELDS[0]
    a = limb.from_ints(f, _values(f.p, 9, 4096), dev)
    before = mont_mul.launches
    _, out = roofline.graph_chain(lambda acc: mont_mul(f, acc, a), a, 5, 2, counted=(mont_mul,))
    # two warm-up calls, then (1 warm-up + 2 timed replays) x 5 kernels
    assert mont_mul.launches == before + 2 + 3 * 5
    want = a
    for _ in range(5):
        want = mont_mul_plain(f, want, a)
    assert torch.equal(out, want)


def test_roofline_sass_checks_pass_on_the_built_library(dev):
    report = roofline.sass_report(_cuda.sass())
    assert (report["mont_mul"]["imad"], report["mont_mul"]["other"]) == (
        roofline.K1_IMAD, roofline.K1_OTHER)


def _points(curve, seed: int, n: int = 40):
    rs = np.random.default_rng(seed)
    g = host.generator(curve)
    pts = [host.mul(curve, g, int(k)) for k in rs.integers(1, 1 << 62, size=2 * n)]
    ps, qs = pts[:n], pts[n:]
    ps[0] = None
    qs[1] = None
    qs[2] = ps[2]
    qs[3] = host.neg(curve, ps[3])
    ps[4] = qs[4] = None
    return ps, qs


def _projective(curve, affine, dev):
    pt = ec.ec_double_plain(curve, tuple(point.from_affine_ints(curve, affine, dev)))
    return tuple(c.contiguous() for c in pt)


@pytest.mark.parametrize("name", [c.name for c in ALL_CURVES])
def test_ec_kernels_match_plain(dev, name):
    (curve,) = [c for c in ALL_CURVES if c.name == name]
    ps, qs = _points(curve, 3)
    p, q = _projective(curve, ps, dev), _projective(curve, qs, dev)
    for got, want in zip(ec.ec_add(curve, p, q), ec.ec_add_plain(curve, p, q)):
        assert torch.equal(got, want)
    for got, want in zip(ec.ec_double(curve, p), ec.ec_double_plain(curve, p)):
        assert torch.equal(got, want)
    summed = point.to_affine_ints(curve, point.Point(*ec.ec_add(curve, p, q)))
    assert summed == [host.double(curve, host.add(curve, a, b)) for a, b in zip(ps, qs)]


@pytest.mark.parametrize("name", ["pasta_fp", "pasta_fq"])
def test_mont_mul_kernel_matches_plain_on_pasta_at_full_width(dev, name):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    n = 1 << 16
    a = limb.from_ints(f, _values(f.p, 21, n), dev)
    b = limb.from_ints(f, _values(f.p, 22, n)[::-1], dev)
    assert torch.equal(mont_mul(f, a, b), mont_mul_plain(f, a, b))


def _chained(curve, n: int, seed: int):
    """n distinct points R + i*S (one host add each), with the special cases."""
    g = host.generator(curve)
    r, s = (host.mul(curve, g, int(v))
            for v in np.random.default_rng(seed).integers(1, 1 << 62, size=2))
    pts = [r]
    for _ in range(2 * n - 1):
        pts.append(host.add(curve, pts[-1], s))
    ps, qs = pts[:n], pts[n:]
    ps[0] = None
    qs[1] = None
    qs[2] = ps[2]
    qs[3] = host.neg(curve, ps[3])
    ps[4] = qs[4] = None
    return ps, qs


@pytest.mark.parametrize("name", ["pallas", "vesta"])
def test_ec_kernels_match_plain_on_pasta_at_full_width(dev, name):
    (curve,) = [c for c in ALL_CURVES if c.name == name]
    ps, qs = _chained(curve, 1 << 14, 23)
    p, q = _projective(curve, ps, dev), _projective(curve, qs, dev)
    for got, want in zip(ec.ec_add(curve, p, q), ec.ec_add_plain(curve, p, q)):
        assert torch.equal(got, want)
    for got, want in zip(ec.ec_double(curve, p), ec.ec_double_plain(curve, p)):
        assert torch.equal(got, want)
    summed = point.to_affine_ints(curve, point.Point(*ec.ec_add(curve, p, q)))
    assert summed[:8] == [host.double(curve, host.add(curve, a, b)) for a, b in zip(ps[:8], qs[:8])]


@pytest.mark.parametrize("name", [c.name for c in ALL_CURVES])
def test_batch_scalar_mul_on_the_card_matches_host(dev, name):
    from halo2_tpu_torch.ops.scalar_mul import batch_scalar_mul

    (curve,) = [c for c in ALL_CURVES if c.name == name]
    ps, _ = _points(curve, 24, n=64)
    scalars = _values(curve.scalar.p, 25, 64)
    before = ec.ec_add.launches, ec.ec_double.launches, ec.ec_scalar_mul.launches
    got = batch_scalar_mul(curve, limb.from_ints(curve.scalar, scalars, dev),
                           point.from_affine_ints(curve, ps, dev))
    after = ec.ec_add.launches, ec.ec_double.launches, ec.ec_scalar_mul.launches
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 1)  # one chain launch
    assert point.to_affine_ints(curve, got) == [host.mul(curve, p, s) for p, s in zip(ps, scalars)]


def test_device_kzg_setup_on_the_card_matches_setup_host(dev):
    from halo2_tpu_torch.poly.kzg import ParamsKZG

    ours = ParamsKZG.setup(8, seed=b"card-setup", device=dev)
    want = ParamsKZG.setup_host(8, seed=b"card-setup", device="cpu")
    for name in ("g", "g_lagrange"):
        for a, b in zip(getattr(ours, name), getattr(want, name)):
            assert torch.equal(a.cpu(), b)


def test_wrappers_check_operands_and_count_launches(dev):
    f = ALL_FIELDS[0]
    a = limb.from_ints(f, _values(f.p, 4, 64), dev)
    with pytest.raises(ValueError, match="int32"):
        mont_mul(f, a.long(), a.long())
    with pytest.raises(ValueError, match="contiguous"):
        mont_mul(f, a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        mont_mul(f, a, a[:, :32])
    with pytest.raises(ValueError, match="CUDA"):
        mont_mul(f, a, a.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        mont_mul_tiled(f, a[:, ::2], a[:, ::2])
    before = mont_mul.launches, mont_mul_tiled.launches
    mont_mul(f, a, a)
    mont_mul_tiled(f, a, a)
    assert (mont_mul.launches, mont_mul_tiled.launches) == (before[0] + 1, before[1] + 1)
    assert mont_mul(f, a[:, :0].contiguous(), a[:, :0].contiguous()).shape == (16, 0)
    assert mont_mul.launches == before[0] + 1  # nothing to launch for n = 0
    coords = tuple(limb.from_ints(BN254_G1.base, [1] * 8, dev) for _ in range(3))
    before = ec.ec_add.launches, ec.ec_double.launches
    ec.ec_add(BN254_G1, coords, coords)
    ec.ec_double(BN254_G1, coords)
    assert (ec.ec_add.launches, ec.ec_double.launches) == (before[0] + 1, before[1] + 1)


def test_msm_and_ntt_on_the_card_match_cpu(dev):
    f = BN254_G1.scalar
    ps, _ = _points(BN254_G1, 5, n=64)
    ps = [p for p in ps if p is not None]
    scalars = _values(f.p, 6, len(ps))
    got = {}
    for d in ("cpu", dev):
        r = msm_ops.msm(
            BN254_G1, limb.from_ints(f, scalars, d), point.from_affine_ints(BN254_G1, ps, d)
        )
        got[str(d)] = point.to_affine_ints(BN254_G1, r)
    assert got["cpu"] == got[str(dev)] == [host.msm(BN254_G1, scalars, ps)]
    k = 10
    omega = pow(f.root_of_unity, 1 << (f.s - k), f.p)
    vals = _values(f.p, 7, 1 << k)
    outs = []
    for d in ("cpu", dev):
        tw = ntt_ops.power_table(f, omega, 1 << (k - 1), d)
        wc = ntt_ops.cross_twiddles(f, omega, k, d)
        outs.append(ntt_ops.ntt_sixstep(f, limb.from_ints(f, vals, d), tw, wc, k).cpu())
    assert torch.equal(outs[0], outs[1])


def test_entry_proof_on_the_card_matches_pin(dev):
    import sys

    sys.path.insert(0, HERE)
    from torch_circuits import EntryCircuit

    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof, gwc_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng

    spec = BN254_G1.scalar
    params = ParamsKZG.setup_host(6, seed=b"dryrun", device=dev)
    circuit = EntryCircuit(1, Value.known(5))
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    inst = pow(5, 4, spec.p)
    proof = create_proof(
        params, pk, [circuit], [[[inst]]], FieldRng(spec, b"dryrun-proof"),
        Blake2bTranscript(BN254_G1), gwc_create_proof,
    )
    with open(os.path.join(HERE, "data", "dryrun_proof_k6.hex")) as fh:
        assert proof == bytes.fromhex(fh.read().strip())
    assert verify_proof(params, vk, [[[inst]]], Blake2bTranscript(BN254_G1, proof), gwc_verify_proof)


@pytest.mark.parametrize("name", [f.name for f in ALL_FIELDS])
@pytest.mark.parametrize("n", [1, 7, 4099])
def test_mont_pow_kernel_matches_plain(dev, name, n):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    a = limb.from_ints(f, _values(f.p, 30, n), dev)
    for e in (1, 2, 13, f.p - 2):
        assert torch.equal(mont_pow(f, a, e), mont_pow_plain(f, a, e))


def _canonical(vals, dev):
    return torch.from_numpy(limb.ints_to_limbs_np(vals)).to(dev)


@pytest.mark.parametrize("name", [c.name for c in ALL_CURVES])
def test_ec_scalar_mul_kernel_matches_plain(dev, name):
    (curve,) = [c for c in ALL_CURVES if c.name == name]
    ps, _ = _points(curve, 31)  # the identity first
    scalars = _values(curve.scalar.p, 32, len(ps))  # 0, 1 and r-1 first
    k, p = _canonical(scalars, dev), _projective(curve, ps, dev)
    got, want = ec.ec_scalar_mul(curve, k, p), ec.ec_scalar_mul_plain(curve, k, p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert point.to_affine_ints(curve, point.Point(*got)) == [
        host.mul(curve, host.double(curve, q), s) for q, s in zip(ps, scalars)]


@pytest.mark.parametrize("name", [c.name for c in ALL_CURVES])
@pytest.mark.parametrize("c,m,w", [(4, 1, 65), (5, 3, 52), (5, 1, 1)])
def test_ec_horner_kernel_matches_plain(dev, name, c, m, w):
    (curve,) = [cv for cv in ALL_CURVES if cv.name == name]
    ps, qs = _points(curve, 33, n=max(m * w, 5))
    sums = tuple(t[:, : m * w].reshape(16, m, w).contiguous()
                 for t in _projective(curve, (ps + qs)[: max(m * w, 5)], dev))
    got, want = ec.ec_horner(curve, sums, c), ec.ec_horner_plain(curve, sums, c)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_chain_wrappers_check_operands_and_count_launches(dev):
    f, curve = BN254_G1.base, BN254_G1
    a = limb.from_ints(f, _values(f.p, 34, 64), dev)
    with pytest.raises(ValueError, match="int32"):
        mont_pow(f, a.long(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        mont_pow(f, a[:, ::2], 5)
    with pytest.raises(ValueError, match="exponent"):
        mont_pow(f, a, 0)
    coords = tuple(limb.from_ints(f, [1] * 8, dev) for _ in range(3))
    k = _canonical([3] * 8, dev)
    with pytest.raises(ValueError, match="shape"):
        ec.ec_scalar_mul(curve, k[:, :4].contiguous(), coords)
    with pytest.raises(ValueError, match="CUDA"):
        ec.ec_scalar_mul(curve, k.cpu(), coords)
    sums = tuple(c.reshape(16, 2, 4) for c in coords)
    with pytest.raises(ValueError, match="window width"):
        ec.ec_horner(curve, sums, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ec.ec_horner(curve, (sums[0].cpu(),) + sums[1:], 4)
    before = mont_pow.launches, ec.ec_scalar_mul.launches, ec.ec_horner.launches
    mont_pow(f, a, 5)
    ec.ec_scalar_mul(curve, k, coords)
    ec.ec_horner(curve, sums, 4)
    after = mont_pow.launches, ec.ec_scalar_mul.launches, ec.ec_horner.launches
    assert tuple(x - y for x, y in zip(after, before)) == (1, 1, 1)
    assert mont_pow(f, a[:, :0].contiguous(), 5).shape == (16, 0)
    assert mont_pow.launches == after[0]  # nothing to launch for n = 0


def _msm_operands(curve, n: int, m: int, seed: int, dev):
    """(affine points with the identity first, scalar columns with 0, 1 and
    r-1 first, (m, 16, n) Montgomery scalars, the points on the card)."""
    g = host.generator(curve)
    r, step = (host.mul(curve, g, int(v))
               for v in np.random.default_rng(seed).integers(1, 1 << 62, size=2))
    aff = [r]
    for _ in range(n - 1):
        aff.append(host.add(curve, aff[-1], step))
    if n > 1:
        aff[0] = None
    cols = [_values(curve.scalar.p, seed + 1 + i, n) for i in range(m)]
    cols = [col[i % n:] + col[:i % n] for i, col in enumerate(cols)]
    scal = torch.stack([limb.from_ints(curve.scalar, col, dev) for col in cols])
    return aff, cols, scal, point.from_affine_ints(curve, aff, dev)


@pytest.mark.parametrize("name", [c.name for c in ALL_CURVES])
@pytest.mark.parametrize("c", [1, 4, 5, 8])
@pytest.mark.parametrize("n", [1, 3, 1000])
def test_msm_digits_kernel_matches_plain(dev, name, c, n):
    (curve,) = [cv for cv in ALL_CURVES if cv.name == name]
    _, _, scal, _ = _msm_operands(curve, n, 2, 40, dev)
    want = msm_ops.msm_digits_plain(curve, scal, c)
    assert torch.equal(msm_ops.msm_digits(curve, scal, c), want)
    wide = torch.cat([scal, scal], dim=2)  # column slices, as the IPA rounds pass them
    assert torch.equal(msm_ops.msm_digits(curve, wide[:, :, n:], c), want)


@pytest.mark.parametrize("name", [c.name for c in ALL_CURVES])
@pytest.mark.parametrize("c", [1, 2, 4, 5, 8])
def test_ec_window_table_kernel_matches_plain(dev, name, c):
    (curve,) = [cv for cv in ALL_CURVES if cv.name == name]
    ps, _ = _points(curve, 41)
    p = _projective(curve, ps, dev)
    want = msm_ops.ec_window_table_plain(curve, p, c)
    got = msm_ops.ec_window_table(curve, p, c)
    assert got.shape == (40, (1 << (c - 1)) + 1, msm_ops.RECORD)
    for a, b in zip(msm_ops.table_unpack(got), want):
        assert torch.equal(a, b)
    wide = tuple(torch.cat([t, t], dim=1) for t in p)
    assert torch.equal(msm_ops.ec_window_table(curve, tuple(t[:, 40:] for t in wide), c), got)


@pytest.mark.parametrize("name", [c.name for c in ALL_CURVES])
@pytest.mark.parametrize("n,m,c", [(1, 1, 4), (1, 3, 5), (5, 2, 4), (300, 3, 5), (2048, 2, 5),
                                   (20000, 1, 5)])
def test_ec_window_fold_kernel_matches_plain(dev, name, n, m, c):
    (curve,) = [cv for cv in ALL_CURVES if cv.name == name]
    _, _, scal, pts = _msm_operands(curve, n, m, 42, dev)
    digits = msm_ops.msm_digits_plain(curve, scal, c)
    table = msm_ops.ec_window_table(curve, pts, c)
    before = msm_ops.ec_window_fold.launches
    got = msm_ops.ec_window_fold(curve, table, digits)
    npad, passes = msm_ops.padded(n), 0
    while npad > 1:
        npad //= min(msm_ops.FOLD_BLOCK, npad)
        passes += 1
    assert msm_ops.ec_window_fold.launches - before == max(passes, 1)
    plain = msm_ops.ec_window_fold_plain(curve, msm_ops.ec_window_table_plain(curve, pts, c),
                                         digits)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_msm_many_on_the_card_runs_the_msm_entries_only(dev):
    curve = BN254_G1
    aff, cols, scal, pts = _msm_operands(curve, 37, 3, 43, dev)
    counted = (msm_ops.msm_digits, msm_ops.ec_window_table, msm_ops.ec_window_fold,
               ec.ec_horner, ec.ec_add, ec.ec_double, mont_mul)
    before = [fn.launches for fn in counted]
    got = msm_ops.msm_many(curve, scal, pts)
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 1, 1, 0, 0, 0]
    want = msm_ops.msm_many(curve, scal.cpu(), point.Point(*(t.cpu() for t in pts)))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert point.to_affine_ints(curve, got) == [host.msm(curve, col, aff) for col in cols]


def test_msm_entries_check_operands_and_raise_on_a_refused_launch(dev):
    curve = BN254_G1
    _, _, scal, pts = _msm_operands(curve, 8, 1, 44, dev)
    with pytest.raises(ValueError, match="1 <= c <= 8"):
        msm_ops.msm_digits(curve, scal, 9)
    with pytest.raises(ValueError, match="int32"):
        msm_ops.msm_digits(curve, scal.long(), 4)
    with pytest.raises(ValueError, match="1 <= c <= 8"):
        msm_ops.ec_window_table(curve, pts, 0)
    digits = msm_ops.msm_digits(curve, scal, 4)
    table = msm_ops.ec_window_table(curve, pts, 4)
    with pytest.raises(ValueError, match="CUDA"):
        msm_ops.ec_window_fold(curve, table.cpu(), digits)
    with pytest.raises(ValueError, match="records"):  # the plain table is for CPU digits
        msm_ops.ec_window_fold(curve, msm_ops.ec_window_table_plain(curve, pts, 4), digits)
    with pytest.raises(ValueError, match="fit"):
        msm_ops.ec_window_fold(curve, table[:3].contiguous(), digits)
    with pytest.raises(ValueError, match="fit"):  # a c = 5 table for c = 4 digits
        msm_ops.ec_window_fold(curve, msm_ops.ec_window_table(curve, pts, 5), digits)
    # the C entry refuses a launch it cannot run (more threads than its 128)
    # and the wrapper's check raises on its error code
    lib = _cuda.library()
    words, n0, b3, one = ec.launch_args(curve)
    out = [torch.empty((16, 52), dtype=torch.int32, device=dev) for _ in range(3)]
    rc = lib.h2_ec_window_fold(digits.data_ptr(), table.data_ptr(), None,
                               *[o.data_ptr() for o in out], 65, 256, 8, 9, 256,
                               words, n0, b3, one, _cuda.stream_ptr(table))
    with pytest.raises(RuntimeError, match="cudaError"):
        _cuda.check(rc, "ec_window_fold")


# ---------------------------------------------------------------------------
# K1's field entries (csrc/field_ops.cu) and transform entry (csrc/ntt.cu)
# ---------------------------------------------------------------------------


FIELD_OPS = [("add", field_ops.field_add, field_ops.field_add_plain),
             ("sub", field_ops.field_sub, field_ops.field_sub_plain)]


@pytest.mark.parametrize("name", [f.name for f in ALL_FIELDS])
@pytest.mark.parametrize("n", [1, 255, 4099, 1 << 15])
def test_field_entries_match_plain(dev, name, n):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    a = limb.from_ints(f, _values(f.p, 11, n), dev)
    b = limb.from_ints(f, _values(f.p, 12, n)[::-1], dev)
    one = b[:, 5 % n : 5 % n + 1]  # a (16, 1) view of a wider array: limb stride n
    for _, kern, plain in FIELD_OPS:
        assert torch.equal(kern(f, a, b), plain(f, a, b))
        assert torch.equal(kern(f, a, one), plain(f, a, one))
        assert torch.equal(kern(f, one, a), plain(f, one, a))
    assert torch.equal(field_ops.field_neg(f, a), field_ops.field_neg_plain(f, a))
    assert torch.equal(field_ops.field_neg(f, one), field_ops.field_neg_plain(f, one))


@pytest.mark.parametrize("name", [f.name for f in ALL_FIELDS])
def test_limb_ops_at_the_provers_broadcast_shapes_match_plain(dev, name):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    x = limb.from_ints(f, _values(f.p, 13, 3 * 4 * 5), dev).reshape(16, 3, 4, 5)
    y = limb.from_ints(f, _values(f.p, 14, 3 * 5), dev).reshape(16, 3, 1, 5)
    c = limb.from_ints(f, _values(f.p, 15, 1), dev).reshape(16, 1, 1, 1)
    for op, _, plain in FIELD_OPS:
        fn = getattr(limb, "f" + op)
        for u, v in ((x, y), (y, x), (x, c), (c, y), (x[:, :, ::2], y)):
            assert torch.equal(fn(f, u, v), plain(f, *torch.broadcast_tensors(u, v)))
    assert torch.equal(limb.fneg(f, x[:, :, 1:3]), field_ops.field_neg_plain(f, x[:, :, 1:3]))
    for u, v in ((x, y), (x, c), (c, x)):
        want = mont_mul_plain(f, *(t.expand(x.shape).reshape(16, -1) for t in (u, v)))
        assert torch.equal(limb.fmul(f, u, v), want.reshape(x.shape))


@pytest.mark.parametrize("name", [f.name for f in ALL_FIELDS])
def test_mont_mul_reads_a_broadcast_operand_in_place(dev, name):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    a = limb.from_ints(f, _values(f.p, 16, 4099), dev)
    wide = limb.from_ints(f, _values(f.p, 17, 10), dev)
    one = wide[:, 3:4]  # limb stride 10
    want = mont_mul_plain(f, a, one.expand(a.shape))
    before = mont_mul.launches
    assert torch.equal(mont_mul(f, a, one), want)
    assert torch.equal(mont_mul(f, one, a), want)
    assert mont_mul.launches == before + 2
    # two single elements, both views of wider arrays (the IPA's last round)
    assert torch.equal(mont_mul(f, wide[:, 5:6], one), mont_mul_plain(f, wide[:, 5:6], one))


def _stockham_operands(f, k: int, b: int, seed: int, dev):
    m = 1 << k
    omega = pow(f.root_of_unity, 1 << (f.s - k), f.p)
    x = limb.from_ints(f, _values(f.p, seed, m * b), dev).reshape(16, m, b)
    return x, ntt_ops.power_table(f, omega, m // 2, dev)


@pytest.mark.parametrize("name", ["bn254_fr", "pasta_fp"])
@pytest.mark.parametrize("k, b", [(0, 5), (1, 3), (2, 1), (3, 16), (7, 256), (8, 128),
                                  (8, 256), (11, 8), (12, 3), (13, 1)])
def test_stockham_axis_matches_plain(dev, name, k, b):
    (f,) = [f for f in ALL_FIELDS if f.name == name]
    x, tw = _stockham_operands(f, k, b, 20 + k, dev)
    before = ntt_ops.stockham_axis.launches
    got = ntt_ops.stockham_axis(f, x, tw, k)
    assert ntt_ops.stockham_axis.launches == before + max(1, -(-k // ntt_ops.MAX_STAGES))
    assert torch.equal(got, ntt_ops.stockham_axis_plain(f, x, tw, k))


@pytest.mark.parametrize("k", [0, 1, 2, 6, 15, 16])
def test_sixstep_on_the_stockham_entry_matches_the_plain_stage_loop(dev, monkeypatch, k):
    f, n = BN254_G1.scalar, 1 << k
    omega = pow(f.root_of_unity, 1 << (f.s - k), f.p)
    inv = pow(omega, -1, f.p)
    a = limb.from_ints(f, _values(f.p, 30 + k, n), dev)
    tw, tw_inv = (ntt_ops.power_table(f, w, n // 2, dev) for w in (omega, inv))
    wc, wc_inv = (ntt_ops.cross_twiddles(f, w, k, dev) for w in (omega, inv))
    n_inv = limb.from_int(f, pow(n, -1, f.p), dev)
    before = ntt_ops.stockham_axis.launches
    got = ntt_ops.ntt_sixstep(f, a, tw, wc, k)
    back = ntt_ops.intt_sixstep(f, got, tw_inv, wc_inv, k, n_inv)
    assert ntt_ops.stockham_axis.launches == before + 4
    assert torch.equal(back, a)
    monkeypatch.setattr(ntt_ops, "stockham_axis", ntt_ops.stockham_axis_plain)
    assert torch.equal(got, ntt_ops.ntt_sixstep(f, a, tw, wc, k))


def test_field_and_transform_entries_check_operands_and_count_launches(dev):
    f = ALL_FIELDS[0]
    a = limb.from_ints(f, _values(f.p, 40, 64), dev)
    for name, fn, _ in FIELD_OPS + [("neg", lambda f, x, y: field_ops.field_neg(f, x), None)]:
        with pytest.raises(ValueError, match="int32"):
            fn(f, a.long(), a)
        with pytest.raises(ValueError, match="contiguous"):
            fn(f, a[:, ::2], a[:, ::2])
        if name != "neg":
            for x, y in ((a.cpu(), a), (a, a.cpu())):
                with pytest.raises(ValueError, match="CUDA"):
                    fn(f, x, y)
            with pytest.raises(ValueError, match="differ"):
                fn(f, a, a[:, :32])
        wrapper = getattr(field_ops, "field_" + name)
        before = wrapper.launches
        fn(f, a, a)
        assert wrapper.launches == before + 1
        assert fn(f, a[:, :0], a[:, :0]).shape == (16, 0)
        assert wrapper.launches == before + 1  # nothing to launch for n = 0
    x, tw = _stockham_operands(f, 4, 8, 41, dev)
    with pytest.raises(ValueError, match="int32"):
        ntt_ops.stockham_axis(f, x.long(), tw.long(), 4)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_ops.stockham_axis(f, x, tw.cpu(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_ops.stockham_axis(f, x[:, :, ::2], tw, 4)
    with pytest.raises(ValueError, match="B"):
        ntt_ops.stockham_axis(f, x, tw, 3)
    # the C entry refuses a pass of more stages than its shared memory holds,
    # and the wrapper's check raises on its error code
    lib = _cuda.library()
    words, n0 = _cuda.modulus_args(f)
    big = torch.empty((16, 1 << 12, 1), dtype=torch.int32, device=dev)
    rc = lib.h2_stockham(big.data_ptr(), big.data_ptr(), tw.data_ptr(), 1 << 12, 1, 0, 12,
                         words, n0, _cuda.stream_ptr(big))
    with pytest.raises(RuntimeError, match="cudaError"):
        _cuda.check(rc, "stockham_axis")


# ---------------------------------------------------------------------------
# the last of the public surface: limb.fdbl / to_int, arith.eval_lagrange,
# Poly's algebra and the domain's constructors, on the card's kernels
# ---------------------------------------------------------------------------


class _LibSpy:
    """The kernel library, recording each C entry called and its arguments."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, args))
            return fn(*args)

        return call


def test_surface_on_the_card_equals_the_cpu_and_counts_launches(dev, monkeypatch):
    from halo2_tpu_torch.ops import arith
    from halo2_tpu_torch.poly.polynomial import LAGRANGE, Poly, Rotation

    f, n = BN254_G1.scalar, 1 << 12
    a = limb.from_ints(f, _values(f.p, 50, n), dev)
    b = limb.from_ints(f, _values(f.p, 51, n)[::-1], dev)
    wide = limb.from_ints(f, _values(f.p, 52, 8), dev)
    s = wide[:, 5]  # one element of a wider array: limb stride 8
    x, y = Poly(a, LAGRANGE), Poly(b, LAGRANGE)
    xc, yc = Poly(a.cpu(), LAGRANGE), Poly(b.cpu(), LAGRANGE)
    counted = (field_ops.field_add, field_ops.field_sub, mont_mul)

    def launches(fn):
        before = [k.launches for k in counted]
        out = fn()
        return out, [k.launches - c for k, c in zip(counted, before)]

    for fn, fn_cpu, want in (
        (lambda: limb.fdbl(f, a), lambda: limb.fdbl(f, a.cpu()), [1, 0, 0]),
        (lambda: x.add(f, y).values, lambda: xc.add(f, yc).values, [1, 0, 0]),
        (lambda: x.sub(f, y).values, lambda: xc.sub(f, yc).values, [0, 1, 0]),
        (lambda: x.mul_pointwise(f, y).values, lambda: xc.mul_pointwise(f, yc).values,
         [0, 0, 1]),
        (lambda: x.scale(f, s).values, lambda: xc.scale(f, s.cpu()).values, [0, 0, 1]),
    ):
        got, counts = launches(fn)
        assert got.is_cuda and counts == want
        assert torch.equal(got.cpu(), fn_cpu())
    # scale reads the scalar in place: K1's broadcast entry on its own storage
    spy = _LibSpy(_cuda.library())
    monkeypatch.setattr(_cuda, "library", lambda: spy)
    x.scale(f, s)
    assert [(name, args[1]) for name, args in spy.calls] == [("h2_mont_mul_bcast", s.data_ptr())]
    monkeypatch.undo()
    for rot in (Rotation.cur(), Rotation.prev(), Rotation.next()):
        assert torch.equal(x.rotate(rot).values.cpu(), xc.rotate(rot).values)
    assert len(x) == n
    assert limb.to_int(f, s) == limb.to_int(f, s.cpu())
    ev = arith.eval_lagrange(f, a, b)
    assert ev.is_cuda and torch.equal(ev.cpu(), arith.eval_lagrange(f, a.cpu(), b.cpu()))


def test_domain_defaults_to_the_card_and_its_constructors_equal_the_cpu(dev):
    from halo2_tpu_torch.plonk.keygen import batch_invert_assigned
    from halo2_tpu_torch.poly.domain import EvaluationDomain

    f, k = BN254_G1.scalar, 10
    dom, cpu = EvaluationDomain(f, 3, k), EvaluationDomain(f, 3, k, device="cpu")
    assert dom.device.type == "cuda" and dom._tw.is_cuda
    assert dom.pinned() == cpu.pinned()
    for name in ("empty_lagrange", "empty_coeff", "empty_extended"):
        got, want = getattr(dom, name)(), getattr(cpu, name)()
        assert got.values.is_cuda and torch.equal(got.values.cpu(), want.values)
    v = limb.from_ints(f, [7], dev)[:, 0]
    got = dom.constant_lagrange(v)
    assert got.values.is_cuda and got.values.stride(1) == 0
    assert torch.equal(got.values.cpu(), cpu.constant_lagrange(v.cpu()).values)
    a = limb.from_ints(f, _values(f.p, 53, 1 << k), dev)
    assert dom.lagrange_from_vec(a).values is a and dom.coeff_from_vec(a).values is a
    (col,) = batch_invert_assigned(f, [{}], 8)
    assert col.values.is_cuda


# ---------------------------------------------------------------------------
# the lookup's matching (csrc/lookup.cu)
# ---------------------------------------------------------------------------


def _sha_like_columns(spec, n: int, usable: int, seed: int, dev):
    """A SHA-like lookup's compressed columns: the table's distinct values,
    then padding rows that repeat row 0's value; inputs drawn from it."""
    rs = np.random.default_rng(seed)
    distinct = _values(spec.p, seed, usable // 2)
    table = distinct + [distinct[0]] * (n - len(distinct))
    inputs = [table[int(i)] for i in rs.integers(0, usable, size=n)]
    return inputs, table, limb.from_ints(spec, inputs, dev), limb.from_ints(spec, table, dev)


@pytest.mark.parametrize("k", [5, 12, 17])
def test_lookup_match_kernel_matches_plain_and_the_host(dev, k):
    from halo2_tpu_torch.ops import lookup as lookup_ops
    from halo2_tpu_torch.plonk import prover
    from halo2_tpu_torch.plonk.error import ConstraintSystemFailure
    from halo2_tpu_torch.utils.rng import FieldRng

    spec, n, bf = BN254_G1.scalar, 1 << k, 10
    usable = n - bf - 1
    inputs, table, ci, ct = _sha_like_columns(spec, n, usable, 70 + k, dev)
    before = lookup_ops.lookup_match.launches
    got = lookup_ops.lookup_permute(spec, ci, ct, usable)
    assert lookup_ops.lookup_match.launches - before == 3
    want = lookup_ops.lookup_permute_plain(spec, ci, ct, usable)
    for g, w in zip(got[:2], want[:2]):
        assert g.is_cuda and torch.equal(g[:, :usable], w[:, :usable])
    assert got[2].item() == want[2].item() == 0
    pi, pt = prover.permute_expression_pair_dev(spec, FieldRng(spec, b"m"), ci, ct, n, bf)
    hi, ht = prover._permute_expression_pair(FieldRng(spec, b"m"), inputs, table, n, bf)
    assert torch.equal(pi, limb.from_ints(spec, hi, dev))
    assert torch.equal(pt, limb.from_ints(spec, ht, dev))
    # a value the table lacks sets the flag on both sides, and the prover raises
    present = set(table[:usable])
    missing = 2
    while missing in present:
        missing += 1
    absent = limb.from_ints(spec, [missing], dev)
    ci[:, usable // 3] = absent[:, 0]
    assert lookup_ops.lookup_permute(spec, ci, ct, usable)[2].item() == 1
    assert lookup_ops.lookup_permute_plain(spec, ci, ct, usable)[2].item() == 1
    with pytest.raises(ConstraintSystemFailure):
        prover.permute_expression_pair_dev(spec, FieldRng(spec, b"m"), ci, ct, n, bf)


def test_lookup_match_checks_operands(dev):
    from halo2_tpu_torch.ops import lookup as lookup_ops

    keys = torch.zeros((2, 4, 8), dtype=torch.int64, device=dev)
    idx = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    col = torch.zeros((16, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        lookup_ops.lookup_match(keys.to(torch.int32), idx, col, col)
    with pytest.raises(ValueError):
        lookup_ops.lookup_match(keys, idx, col[:, :4], col[:, :4])  # u > n
    with pytest.raises(ValueError):
        lookup_ops.lookup_match(keys, idx, col.t().contiguous().t(), col)


def test_lookup_permute_on_the_card_pulls_once_and_proves_the_pin(dev, monkeypatch):
    """tests/plonk_api.rs at k=5 over GWC on the card: each ``_lookup_permute``
    makes exactly one ``limb: device to host`` pull (the missing-value flag)
    and launches the matching's kernels; the proof equals the JAX pin."""
    import sys

    sys.path.insert(0, HERE)
    from torch_circuits import StandardPlonkCircuit, plonk_api_common

    from halo2_tpu_torch.ops import lookup as lookup_ops
    from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk, prover
    from halo2_tpu_torch.poly.kzg import ParamsKZG
    from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils import profiling
    from halo2_tpu_torch.utils.rng import FieldRng

    spec = BN254_G1.scalar
    a, instance, table = plonk_api_common(spec)
    params = ParamsKZG.setup_host(5, seed=b"plonk-api", device=dev)
    blank = StandardPlonkCircuit(Value.unknown(), table)
    vk = keygen_vk(params, blank)
    pk = keygen_pk(params, vk, blank)
    circuit = StandardPlonkCircuit(Value.known(a), table)
    pulls = []
    inner = prover._lookup_permute

    def counted(*args, **kwargs):
        profiling.report(reset=True)
        out = inner(*args, **kwargs)
        report = {name: calls for name, calls, _ in profiling.report(reset=True)}
        pulls.append(report.get("limb: device to host", 0))
        return out

    monkeypatch.setenv("HALO2_TPU_PROFILE", "1")
    monkeypatch.setattr(prover, "_lookup_permute", counted)
    before = lookup_ops.lookup_match.launches
    proof = create_proof(params, pk, [circuit, circuit], [[[instance]], [[instance]]],
                         FieldRng(spec, b"gwc-rng"), Blake2bTranscript(BN254_G1), gwc_create_proof)
    assert pulls == [1, 1]
    assert lookup_ops.lookup_match.launches - before == 3 * len(pulls)
    with open(os.path.join(HERE, "data", "plonk_api_gwc_k5.hex")) as fh:
        assert proof == bytes.fromhex(fh.read().strip())


# ---------------------------------------------------------------------------
# multi-device proving on distinct cards (parallel/)
# ---------------------------------------------------------------------------


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices: a mesh of distinct cards")
    return torch.cuda.device_count()


def _card_mesh(cards: int, d: int):
    from halo2_tpu_torch.parallel import default_mesh

    mesh = default_mesh(d, [torch.device("cuda", i % cards) for i in range(d)])
    assert len(mesh.distinct) == min(cards, d)
    return mesh


@pytest.mark.parametrize("k, d", [(12, 2), (12, 4), (12, 8), (5, 8)])
def test_sharded_ntt_equals_one_device_on_distinct_cards(cards, k, d):
    from halo2_tpu_torch.parallel import ntt as pntt

    f, n = BN254_G1.scalar, 1 << k
    dev = torch.device("cuda", 0)
    omega = pow(f.root_of_unity, 1 << (f.s - k), f.p)
    a = limb.from_ints(f, _values(f.p, 60 + k, n), dev)
    want = ntt_ops.ntt_sixstep(f, a, ntt_ops.power_table(f, omega, n // 2, dev),
                               ntt_ops.cross_twiddles(f, omega, k, dev), k)
    mesh = _card_mesh(cards, d)
    got = pntt.sharded_ntt(f, a, k, omega, mesh)
    assert got.device == dev and torch.equal(got, want)
    assert torch.equal(pntt.sharded_intt(f, got, k, omega, mesh), a)
    if n >= d * d:  # each shard's tables on its own card
        for i, card in enumerate(mesh.devices):
            assert all(t.device == card for t in pntt._tables(f, omega, n, d, i, card))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_msm_equals_one_device_on_distinct_cards(cards, d):
    from halo2_tpu_torch.parallel import sharded_msm, sharded_msm_many

    curve = BN254_G1
    dev = torch.device("cuda", 0)
    _, _, scal, pts = _msm_operands(curve, 1 << 10, 3, 61, dev)
    mesh = _card_mesh(cards, d)
    want = point.to_affine_ints(curve, msm_ops.msm_many(curve, scal, pts))
    got = sharded_msm_many(curve, scal, pts, mesh)
    assert got.x.device == dev and point.to_affine_ints(curve, got) == want
    assert point.to_affine_ints(curve, sharded_msm(curve, scal[0], pts, mesh)) == want[:1]


def test_sharded_proof_equals_the_pin_on_distinct_cards(cards):
    from halo2_tpu_torch import entry

    d = 1 << (min(cards, 8).bit_length() - 1)  # default_mesh(d): d distinct cards
    with open(os.path.join(HERE, "data", "dryrun_proof_k6.hex")) as f:
        expected = bytes.fromhex(f.read().strip())
    assert entry.dryrun_multichip(d, log=lambda msg: None) == expected
