"""K4 (the lane-tiled Montgomery multiply) against the JAX package, exactly.

The port's ``mont_mul_tiled`` on CPU tensors (its plain version) against
``halo2_tpu.fields.pallas_kernels.mont_mul_pallas`` run in Pallas interpret
mode, on the same seeded limbs: one tile with padding (n = 8) and a ragged
second tile (n = TILE + 32), BN254 Fr and Pasta Fp, with 0, 1 and p-1 among
the operands.  Tolerance: exact (equal limb arrays).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from halo2_tpu.fields import ALL_FIELDS as JAX_FIELDS
from halo2_tpu.fields import limb as jlimb
from halo2_tpu.fields.pallas_kernels import TILE, mont_mul_pallas

from halo2_tpu_torch.fields import ALL_FIELDS, limb
from halo2_tpu_torch.fields.mont_mul import mont_mul_tiled

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers


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


@pytest.mark.parametrize("name", ["bn254_fr", "pasta_fp"])
@pytest.mark.parametrize("n", [8, TILE + 32])
def test_mont_mul_tiled_matches_pallas_interpret(name, n):
    (t,) = [f for f in ALL_FIELDS if f.name == name]
    (j,) = [f for f in JAX_FIELDS if f.name == name]
    xs, ys = _values(j.p, 11, n), _values(j.p, 12, n)[::-1]
    a = jlimb.ints_to_limbs_np([j.to_mont(v) for v in xs])
    b = jlimb.ints_to_limbs_np([j.to_mont(v) for v in ys])
    want = np.asarray(mont_mul_pallas(j, jnp.asarray(a), jnp.asarray(b), True))
    got = mont_mul_tiled(t, torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert limb.to_ints(t, got) == [x * y % j.p for x, y in zip(xs, ys)]


def test_mont_mul_tiled_refuses_a_tensor_off_the_cpu_without_cuda():
    (t,) = [f for f in ALL_FIELDS if f.name == "bn254_fr"]
    a = limb.from_ints(t, [1, 2, 3]).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        mont_mul_tiled(t, a, a)
