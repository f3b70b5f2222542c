"""The CUDA kernels K1-K4, B1 and B2 against their plain torch versions, on a card.

Every test here needs a CUDA device and skips without one: the kernels have
no CPU mode.  The plain versions are held to the JAX package by the CPU
tests (test_torch_fields.py, test_torch_curves.py); here the kernels are held
to the plain versions, exactly, on all four fields and all three curves, K1
on the Pasta fields at n = 2^16 and K2/K3 on Pallas and Vesta at n = 2^14;
``batch_scalar_mul`` and the device KZG setup, which run on K2/K3, against
the host.
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
from halo2_tpu_torch.fields import ALL_FIELDS, limb
from halo2_tpu_torch.fields.mont_mul import mont_mul, mont_mul_plain, mont_mul_tiled
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
    before = ec.ec_add.launches, ec.ec_double.launches
    got = batch_scalar_mul(curve, limb.from_ints(curve.scalar, scalars, dev),
                           point.from_affine_ints(curve, ps, dev))
    assert (ec.ec_add.launches - before[0], ec.ec_double.launches - before[1]) == (256, 256)
    assert point.to_affine_ints(curve, got) == [host.mul(curve, p, s) for p, s in zip(ps, scalars)]


def test_device_kzg_setup_on_the_card_matches_setup_host(dev):
    from halo2_tpu_torch.poly.kzg import ParamsKZG

    ours = ParamsKZG.setup(8, seed=b"card-setup", device=dev)
    want = ParamsKZG.setup_host(8, seed=b"card-setup")
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
