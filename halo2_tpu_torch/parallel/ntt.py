"""Distributed NTT: four-step Cooley–Tukey with all_to_all stage exchanges.

Port of the JAX package's ``parallel/ntt.py`` (the replacement for the
reference's thread-split recursive FFT, arithmetic.rs:202-274).  The length-n
transform over a D-device mesh is factored n = D * n2 (decimation
j = j1*n2 + j2, i = i1 + D*i2):

    out[i1 + D*i2] = DFT_n2 over j2 of [ w^(i1*j2) * (DFT_D over j1 of M)[i1, j2] ]

so the device axis carries the size-D inner transform and each device runs
the butterfly network of ``ops/ntt.py`` on its rows.  Three ``all_to_all``
exchanges (``parallel/mesh.py``): (1) rows -> column tiles, so the size-D
transform is local; (2) tiles -> rows, so the size-n2 transform is local;
(3) the reorder back to contiguous sharding.  The twiddles w^(i1*j2) are
built on each device from its slice of the w^j2 table by D-1 products; no
O(n*D) table exists.  Every field product is ``limb.fmul``: K1 on the shard's
card.

The four-step path needs n >= D^2 (nonempty exchange tiles); a smaller
transform takes the gather path (every device gathers the whole, tiny,
array, runs the full transform and keeps its slice), so a sharded prove works
at any k >= log2(D).

The power tables are built with host integers once per (field, omega, n, D)
and kept per device (and per shard for the sharded w^j2 table).  Each call
scatters its input from its device in contiguous slices and gathers the
output back there, so the callers' tensors never change device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import NLIMBS, FieldSpec
from ..ops import ntt as ntt_ops
from .mesh import DeviceMesh, all_gather, all_to_all, gather, scatter


def _log2(x: int) -> int:
    k = x.bit_length() - 1
    assert 1 << k == x
    return k


def _host_power_table(spec: FieldSpec, base: int, n: int) -> np.ndarray:
    """(16, n) Montgomery table [1, base, ..., base^(n-1)] from host integers."""
    vals = []
    cur = 1
    for _ in range(n):
        vals.append(spec.to_mont(cur))
        cur = cur * base % spec.p
    return limb.ints_to_limbs_np(vals).reshape(NLIMBS, n)


@functools.lru_cache(maxsize=None)
def _host_tables(spec: FieldSpec, omega: int, n: int, ndev: int):
    """w^j2 for j2 < n2 (sharded), the powers of w^n2 (the inner size-D
    transform's root) and of w^D (the outer size-n2 transform's)."""
    n2 = n // ndev
    return (
        _host_power_table(spec, omega, n2),
        _host_power_table(spec, pow(omega, n2, spec.p), max(ndev // 2, 1)),
        _host_power_table(spec, pow(omega, ndev, spec.p), n2 // 2),
    )


@functools.lru_cache(maxsize=None)
def _tables(spec: FieldSpec, omega: int, n: int, ndev: int, d: int, device: torch.device):
    """Shard d's tables on its device: its (16, n2/D) slice of w^j2, and the
    inner and outer twiddles."""
    w_j2, tw_inner, tw_outer = _host_tables(spec, omega, n, ndev)
    m = n // ndev // ndev
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (w_j2[:, d * m : (d + 1) * m], tw_inner, tw_outer))


@functools.lru_cache(maxsize=None)
def _full_twiddles(spec: FieldSpec, omega: int, n: int, device: torch.device):
    return torch.from_numpy(_host_power_table(spec, omega, n // 2)).to(device)


def _fourstep(spec: FieldSpec, shards: list, k: int, omega: int, mesh: DeviceMesh) -> list:
    """The four-step transform of contiguously sharded (16, n2) rows; returns
    the output, contiguously sharded."""
    ndev = mesh.size
    n2 = shards[0].shape[1]
    m = n2 // ndev
    tables = [_tables(spec, omega, 1 << k, ndev, d, dev) for d, dev in enumerate(mesh.devices)]

    # (1) rows -> column tiles: device d gets M[j1 = *, j2 in tile d] as (16, D, m)
    cols = all_to_all(mesh, [a.reshape(NLIMBS, ndev, m) for a in shards], 1, 1)
    twiddled = []
    for x, (w_j2, tw_inner, _) in zip(cols, tables):
        # (2) the inner DFT over j1 (size D), batched over the m local columns j2
        x = ntt_ops.ntt_batched(spec, x.transpose(1, 2), tw_inner, _log2(ndev))  # A[:, j2, i1]
        # (3) twiddle by w^(i1 * j2): pw[:, j2, i1] = w_j2^i1, D - 1 products
        pw = [limb.one_like(spec, w_j2)]
        for _ in range(ndev - 1):
            pw.append(limb.fmul(spec, pw[-1], w_j2))
        twiddled.append(limb.fmul(spec, x, torch.stack(pw, dim=2)).transpose(1, 2))  # (16, D, m)

    # (4) tiles -> rows: device e gets A'[i1 = e, every j2] as (16, 1, n2)
    rows = all_to_all(mesh, twiddled, 1, 2)
    # (5) the outer DFT over j2 (size n2): C[i1 = e, i2], split by destination tile
    outer = [ntt_ops.ntt(spec, x.reshape(NLIMBS, n2), tw_outer, _log2(n2)).reshape(NLIMBS, ndev, m)
             for x, (_, _, tw_outer) in zip(rows, tables)]
    # (6) back to contiguous sharding: device d's chunk is out[i1 + D*i2] = C[i1, d*m + i2]
    return [x.transpose(1, 2).reshape(NLIMBS, n2) for x in all_to_all(mesh, outer, 1, 1)]


def _gathered(spec: FieldSpec, shards: list, k: int, omega: int, mesh: DeviceMesh) -> list:
    """The small-size path: every device gathers the (tiny) array, runs the
    whole transform and keeps its contiguous slice."""
    n = 1 << k
    chunk = n // mesh.size
    out = []
    for d, (full, dev) in enumerate(zip(all_gather(mesh, shards), mesh.devices)):
        whole = ntt_ops.ntt(spec, full, _full_twiddles(spec, omega, n, dev), k)
        out.append(whole[:, d * chunk : (d + 1) * chunk])
    return out


def _sharded(spec: FieldSpec, a, k: int, omega: int, mesh: DeviceMesh) -> list:
    n = 1 << k
    assert a.shape == (NLIMBS, n) and n >= mesh.size
    path = _gathered if n < mesh.size * mesh.size else _fourstep
    return path(spec, scatter(mesh, a), k, omega, mesh)


def sharded_ntt(spec: FieldSpec, a, k: int, omega: int, mesh: DeviceMesh):
    """DFT of a (16, 2^k) limb tensor over the mesh.

    ``omega`` is the canonical-int primitive 2^k-th root of unity.  The input
    is split into contiguous slices along axis 1, one per shard; the output
    is gathered back onto ``a``'s device.
    """
    return gather(mesh, _sharded(spec, a, k, omega, mesh), a.device)


def sharded_intt(spec: FieldSpec, a, k: int, omega: int, mesh: DeviceMesh):
    """Inverse DFT over the mesh: the forward transform with omega^-1, each
    shard scaled by 1/n on its device."""
    p = spec.p
    n_inv = pow(1 << k, -1, p)
    out = [limb.fmul(spec, s, limb.from_int(spec, n_inv, s.device).reshape(NLIMBS, 1))
           for s in _sharded(spec, a, k, pow(omega, -1, p), mesh)]
    return gather(mesh, out, a.device)
