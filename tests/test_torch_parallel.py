"""The port's multi-device proving (``halo2_tpu_torch/parallel/``) on CPU meshes.

A mesh here is ``("cpu",) * D``, the counterpart of the JAX package's 8
virtual CPU devices (tests/conftest.py); the same code runs on distinct cards
or on a mesh that repeats one card.

- ``ops.ntt.ntt_batched`` equals the JAX package's at k = 3, B = 4;
- ``sharded_ntt`` / ``sharded_intt`` equal the one-device butterfly ``ntt``
  for D = 2, 4, 8 on the four-step path (k = 7) and on the gather path
  (k = 5, D = 8), and the round trip gives the input back;
- each exchange of ``parallel/mesh.py`` equals a reshape and transpose of the
  gathered array, and counts the bytes that change shard;
- the sharded tables lie on their shard's device and hold its slice;
- ``sharded_msm`` (n = 128, D = 8) and ``sharded_msm_many`` (m = 3) equal
  ``msm`` / ``msm_many`` in affine form;
- ``default_mesh`` rounds the visible cards down to a power of two and
  raises, never substitutes, when there are too few cards or none;
- ``keygen_vk``, ``keygen_pk`` and ``create_proof`` set ``mesh=`` on the
  params and the domain unconditionally, so a mesh never sticks.

- ``entry.dryrun_multichip(2, devices=["cpu"] * 2)``: the k=6 proof sharded
  over two devices equals the JAX package's pin ``tests/data/dryrun_proof_k6.hex``.

D = 4 and ``bench_scaling`` are in ``test_torch_parallel_dryrun.py``, D = 8 in
``test_torch_parallel_dryrun8.py``: on the CPU every shard runs its own plain
``ec_horner`` (~3.7 s a call), so a proof over D shards costs about D times
one device's, and files of their own let xdist run them beside this one.
Tolerance: exact.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.fields.spec import BN254_FR as J_FR
from halo2_tpu.ops import ntt as jntt

from halo2_tpu_torch import entry
from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves import host
from halo2_tpu_torch.curves.point import from_affine_ints, to_affine_ints
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.fields.spec import BN254_FR
from halo2_tpu_torch.ops import msm as msm_ops
from halo2_tpu_torch.ops import ntt as ntt_ops
from halo2_tpu_torch.parallel import (
    default_mesh, mesh as mesh_mod, sharded_intt, sharded_msm, sharded_msm_many, sharded_ntt,
)
from halo2_tpu_torch.parallel import ntt as pntt
from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk
from halo2_tpu_torch.plonk.error import InstanceTooLarge
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof
from halo2_tpu_torch.transcript import Blake2bTranscript
from halo2_tpu_torch.utils.rng import FieldRng

from torch_circuits import EntryCircuit

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

FR = BN254_FR
HERE = os.path.dirname(os.path.abspath(__file__))


def dryrun_equals_the_pin(d: int) -> None:
    """``entry.dryrun_multichip`` over ``("cpu",) * d``: the pinned bytes."""
    with open(os.path.join(HERE, "data", "dryrun_proof_k6.hex")) as f:
        expected = bytes.fromhex(f.read().strip())
    logged = []
    assert entry.dryrun_multichip(d, devices=["cpu"] * d, log=logged.append) == expected
    assert f"sharded over {d} devices (1 distinct: cpu)" in logged[0]


def _cpu_mesh(d: int):
    return default_mesh(d, ["cpu"] * d)


def _field(n: int, seed: int) -> list:
    rs = np.random.default_rng(seed)
    return [int.from_bytes(rs.bytes(32), "little") % FR.p for _ in range(n)]


def _omega(k: int) -> int:
    return pow(FR.root_of_unity, 1 << (FR.s - k), FR.p)


def test_ntt_batched_equals_jax():
    k, b = 3, 4
    n = 1 << k
    vals = _field(b * n, 7)
    tw = ntt_ops.power_table(FR, _omega(k), n // 2, "cpu")
    a = limb.from_ints(FR, vals, "cpu").reshape(16, b, n)
    got = ntt_ops.ntt_batched(FR, a, tw, k)
    ja = jnp.asarray(jlimb.from_ints(J_FR, vals)).reshape(16, b, n)
    want = jntt.ntt_batched(J_FR, ja, jntt.power_table(J_FR, _omega(k), n // 2), k)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
    for row in range(b):  # each row is the one-row transform
        assert torch.equal(got[:, row], ntt_ops.ntt(FR, a[:, row].contiguous(), tw, k))


@pytest.mark.parametrize("k, d", [(7, 2), (7, 4), (7, 8), (5, 8)],
                         ids=["fourstep-D2", "fourstep-D4", "fourstep-D8", "gather-D8"])
def test_sharded_ntt_and_intt_equal_one_device(k, d):
    n = 1 << k
    a = limb.from_ints(FR, _field(n, 10 + k + d), "cpu")
    want = ntt_ops.ntt(FR, a, ntt_ops.power_table(FR, _omega(k), n // 2, "cpu"), k)
    mesh = _cpu_mesh(d)
    got = sharded_ntt(FR, a, k, _omega(k), mesh)
    assert torch.equal(got, want)
    assert torch.equal(sharded_intt(FR, got, k, _omega(k), mesh), a)


def _exchange_cases(d: int, m: int):
    """(name, run, expected) for each exchange, on shards X[s] of (16, d, m)
    int32 with distinct entries; ``g`` is the stacked (d, 16, d, m) array."""
    g = torch.arange(d * 16 * d * m, dtype=torch.int32).reshape(d, 16, d, m)
    shards = list(g)
    mesh = _cpu_mesh(d)
    return mesh, shards, {
        # device e gets X[s][:, e, :] from every s, along axis 1: (16, d, m)
        "all_to_all(1, 1)": (lambda: mesh_mod.all_to_all(mesh, shards, 1, 1),
                             list(g.permute(2, 1, 0, 3))),
        # device e gets X[s][:, e, :] along axis 2: (16, 1, d * m)
        "all_to_all(1, 2)": (lambda: mesh_mod.all_to_all(mesh, shards, 1, 2),
                             list(g.permute(2, 1, 0, 3).reshape(d, 16, 1, d * m))),
        # every device gets the shards joined along the last axis
        "all_gather": (lambda: mesh_mod.all_gather(mesh, shards),
                       [g.permute(1, 2, 0, 3).reshape(16, d, d * m)] * d),
    }


@pytest.mark.parametrize("name", ["all_to_all(1, 1)", "all_to_all(1, 2)", "all_gather"])
def test_exchange_equals_reshape_and_transpose(name):
    d, m = 4, 3
    mesh, shards, cases = _exchange_cases(d, m)
    run, want = cases[name]
    mesh_mod.traffic.update(bytes=0, copies=0)
    got = run()
    assert len(got) == d and all(torch.equal(x, y) for x, y in zip(got, want))
    shard_bytes = shards[0].numel() * 4
    moved = {"all_gather": (d - 1) * d * shard_bytes}.get(name, (d - 1) * shard_bytes)
    assert mesh_mod.traffic["bytes"] == moved


def test_scatter_and_gather_are_contiguous_slices():
    d = 4
    mesh = _cpu_mesh(d)
    a = torch.arange(16 * 24, dtype=torch.int32).reshape(16, 24)
    mesh_mod.traffic.update(bytes=0, copies=0)
    shards = mesh_mod.scatter(mesh, a)
    assert [tuple(s.shape) for s in shards] == [(16, 6)] * d
    assert all(torch.equal(s, a[:, 6 * i : 6 * (i + 1)]) for i, s in enumerate(shards))
    assert torch.equal(mesh_mod.gather(mesh, shards), a)
    assert mesh_mod.traffic == {"bytes": 2 * 3 * 16 * 6 * 4, "copies": 6}
    with pytest.raises(ValueError):
        mesh_mod.scatter(mesh, a[:, :10])


def test_sharded_tables_lie_on_their_shard_device():
    k, d = 7, 4
    n, n2 = 1 << k, (1 << k) // d
    mesh = _cpu_mesh(d)
    sharded_ntt(FR, limb.from_ints(FR, _field(n, 3), "cpu"), k, _omega(k), mesh)
    slices = []
    for i, dev in enumerate(mesh.devices):
        tables = pntt._tables(FR, _omega(k), n, d, i, dev)
        assert all(t.device == dev for t in tables)
        slices.append(tables[0])
        assert torch.equal(tables[2], ntt_ops.power_table(FR, pow(_omega(k), d, FR.p), n2 // 2))
    # shard i holds w^j2 for j2 in its tile of n2 / d columns
    assert torch.equal(torch.cat(slices, dim=1), ntt_ops.power_table(FR, _omega(k), n2))


def test_sharded_msm_and_msm_many_equal_one_device():
    curve, n, d, m = BN254_G1, 128, 8, 3
    pts, acc = [], None
    for _ in range(n):  # i * G for i = 1 .. n
        acc = host.add(curve, acc, (curve.gx, curve.gy))
        pts.append(acc)
    points = from_affine_ints(curve, pts)
    scalars = torch.stack([limb.from_ints(FR, _field(n, 40 + j)) for j in range(m)])
    mesh = _cpu_mesh(d)
    want = to_affine_ints(curve, msm_ops.msm_many(curve, scalars, points))
    assert to_affine_ints(curve, sharded_msm_many(curve, scalars, points, mesh)) == want
    got = sharded_msm(curve, scalars[0], points, mesh)
    assert got.x.shape == (16,)
    want = to_affine_ints(curve, msm_ops.msm(curve, scalars[0], points))
    assert to_affine_ints(curve, got) == want


def test_default_mesh_takes_distinct_cards_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    mesh = default_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert mesh.shape == {"shard": 4} and len(mesh.distinct) == 4
    assert default_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="distinct"):
        default_mesh(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh(1)
    # a repeated-device mesh only from an explicit list
    mesh = default_mesh(None, ["cpu"] * 8)
    assert mesh.size == 8 and mesh.distinct == (torch.device("cpu"),)
    assert default_mesh(4, ["cpu"] * 8).size == 4
    with pytest.raises(ValueError, match="power-of-two"):
        default_mesh(3, ["cpu"] * 3)


def test_mesh_never_sticks_to_a_later_call():
    k, a = 6, 5
    spec = BN254_G1.scalar
    mesh = _cpu_mesh(2)
    params = ParamsKZG.setup_host(k, seed=b"dryrun", device="cpu")
    circuit = EntryCircuit(1, Value.known(a))
    vk = keygen_vk(params, circuit.without_witnesses(), mesh=mesh)
    assert params.mesh is mesh and vk.domain.mesh is mesh
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    assert params.mesh is None and vk.domain.mesh is None

    def prove(m):
        # an instance column longer than the usable rows: create_proof sets
        # the mesh, then raises before its first commitment
        with pytest.raises(InstanceTooLarge):
            create_proof(params, pk, [circuit], [[[pow(a, 4, spec.p)] * (1 << k)]],
                         FieldRng(spec, b"dryrun-proof"), Blake2bTranscript(BN254_G1),
                         gwc_create_proof, mesh=m)

    prove(mesh)
    assert params.mesh is mesh and pk.vk.domain.mesh is mesh
    prove(None)
    assert params.mesh is None and pk.vk.domain.mesh is None


@pytest.mark.parametrize("d", [2])
def test_sharded_proof_equals_the_pin(d):
    dryrun_equals_the_pin(d)
