"""Multi-device proving: device meshes, sharded MSM and NTT, exchanges.

Port of the JAX package's ``parallel/`` (the replacement for the reference's
rayon thread pool, multicore.rs:1-5).  The JAX package shards over a
``jax.sharding.Mesh`` inside ``shard_map``; this port keeps one process and
a mesh of explicit ``torch.device``s (``mesh.py``): each sharded call splits
its operands over the devices, runs the kernels on each, exchanges by copies
between them and gathers the result back.  ``keygen_vk``, ``keygen_pk`` and
``create_proof`` take ``mesh=`` and route the domain's transforms and the
KZG commitments through it.
"""

from .mesh import default_mesh, shard_axis
from .msm import sharded_msm, sharded_msm_many
from .ntt import sharded_intt, sharded_ntt

__all__ = [
    "default_mesh",
    "shard_axis",
    "sharded_msm",
    "sharded_msm_many",
    "sharded_ntt",
    "sharded_intt",
]
