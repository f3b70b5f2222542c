"""Device meshes and the exchanges between their shards.

Port of the JAX package's ``parallel/mesh.py``.  The proving system's scaling
dimensions are one-dimensional streams (MSM points, NTT butterflies), so a
mesh is one ``"shard"`` axis over a tuple of devices.  Where the JAX package
holds a ``jax.sharding.Mesh`` and runs its collectives inside ``shard_map``,
this port stays in one process: a mesh is a tuple of ``torch.device``, a
sharded array is a list of per-device tensors (shard d on ``devices[d]``),
and the collectives of ``jax.lax`` that the sharded kernels use are plain
functions here, copies between the shards' devices (peer copies between
distinct cards).  Every exchange has ``tiled=True`` semantics and splits or
joins along the last axis unless it says otherwise.

A mesh may repeat a device: ``("cpu",) * 8`` in the CPU tests (the JAX
package's 8 virtual CPU devices), ``("cuda:0",) * 4`` as the proxy of four
cards on one.  Only an explicit ``devices=`` list builds one;
``default_mesh`` without it takes distinct cards and raises when there are
not enough.
"""

from __future__ import annotations

import dataclasses

import torch

SHARD_AXIS = "shard"

# bytes that left their shard's index in an exchange, and the copies that
# moved them (a repeated-device mesh copies nothing, but counts what distinct
# cards would move); zeroed by the caller that reads them
traffic = {"bytes": 0, "copies": 0}


def shard_axis() -> str:
    return SHARD_AXIS


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh: shard d lives on ``devices[d]``; the size is a power of two."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(_indexed(torch.device(d)) for d in self.devices)
        if not devs or len(devs) & (len(devs) - 1):
            raise ValueError(f"a mesh needs a power-of-two device count, got {len(devs)}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: self.size}

    @property
    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so it compares equal to a tensor's device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _split(mesh: DeviceMesh, t: torch.Tensor, axis: int) -> tuple:
    if t.shape[axis] % mesh.size:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split over {mesh.size} shards")
    return t.chunk(mesh.size, dim=axis)


def default_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A mesh over ``devices[:n_devices]``, or, without ``devices``, over the
    first ``n_devices`` visible CUDA cards (all of them by default, rounded
    down to a power of two, as the JAX package does).  Never substitutes the
    CPU or a repeated card: it raises when no card is visible or when
    ``n_devices`` exceeds the distinct cards."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("default_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * 8) for another mesh")
        if n_devices is None:
            n_devices = 1 << (count.bit_length() - 1)
        if n_devices > count:
            raise RuntimeError(f"default_mesh: {n_devices} devices asked for, {count} distinct "
                               f"CUDA devices visible; pass devices= for a repeated-card mesh")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"default_mesh: {n_devices} devices asked for, {len(devices)} given")
    return DeviceMesh(tuple(devices[:n_devices]))


def _move(t: torch.Tensor, device: torch.device, moved: bool) -> torch.Tensor:
    if moved:
        traffic["bytes"] += t.numel() * t.element_size()
        traffic["copies"] += 1
    return t.to(device, non_blocking=True)


def scatter(mesh: DeviceMesh, a: torch.Tensor) -> list:
    """Shard d: the d-th of ``mesh.size`` contiguous slices of ``a``'s last
    axis, on ``devices[d]`` (the JAX package's ``P(..., "shard")`` placement)."""
    return [_move(c, dev, dev != a.device or d > 0)
            for d, (c, dev) in enumerate(zip(_split(mesh, a, -1), mesh.devices))]


def gather(mesh: DeviceMesh, shards: list, device=None) -> torch.Tensor:
    """The shards joined along the last axis on ``device`` (``devices[0]`` by
    default): the inverse of :func:`scatter`."""
    device = mesh.devices[0] if device is None else _indexed(torch.device(device))
    return torch.cat([_move(s, device, d > 0 or s.device != device)
                      for d, s in enumerate(shards)], dim=-1)


def all_gather(mesh: DeviceMesh, shards: list) -> list:
    """``jax.lax.all_gather(..., axis=-1, tiled=True)``: every device gets the
    shards joined along the last axis."""
    return [torch.cat([_move(s, dev, src != dst) for src, s in enumerate(shards)], dim=-1)
            for dst, dev in enumerate(mesh.devices)]


def all_to_all(mesh: DeviceMesh, shards: list, split_axis: int, concat_axis: int) -> list:
    """``jax.lax.all_to_all(..., split_axis, concat_axis, tiled=True)``: shard
    d splits into ``mesh.size`` equal chunks along ``split_axis`` and sends
    chunk e to device e, which joins the chunks from d = 0, 1, ... along
    ``concat_axis``."""
    chunks = [_split(mesh, s, split_axis) for s in shards]
    return [torch.cat([_move(chunks[src][dst], dev, src != dst) for src in range(mesh.size)],
                      dim=concat_axis)
            for dst, dev in enumerate(mesh.devices)]
