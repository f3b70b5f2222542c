"""The slower runs of multi-device proving on a CPU mesh, in a file of their
own so that xdist runs them beside ``test_torch_parallel.py``:

- the k=6 ``EntryCircuit`` proof sharded over four devices
  (``entry.dryrun_multichip(4, devices=["cpu"] * 4)``: keygen and
  ``create_proof`` with ``mesh=``) equals the JAX package's one-device pin
  ``tests/data/dryrun_proof_k6.hex``, as ``__graft_entry__.dryrun_multichip``
  holds the JAX package's sharded proof to it; at k = 6 the base domain takes
  the four-step path (n >= D^2) and every commitment the sharded MSM;
- ``bench.full.bench_scaling`` at a tiny k: the three
  ``scaling_efficiency_{2,4,8}dev`` lines, each with its mesh's devices and
  ``distinct_devices``, a repeated-device mesh labelled a proxy, every time
  positive.

Tolerance: exact.
"""

import pytest
import torch

from halo2_tpu_torch.bench import full

from test_torch_parallel import dryrun_equals_the_pin

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers


@pytest.mark.parametrize("d", [4])
def test_sharded_proof_equals_the_pin(d):
    dryrun_equals_the_pin(d)


def test_bench_scaling_lines_on_the_cpu(capsys):
    lines = full.bench_scaling(k=3, reps=1, devices=["cpu"] * 8)
    assert [r["metric"] for r in lines] == [f"scaling_efficiency_{d}dev" for d in (2, 4, 8)]
    for d, r in zip((2, 4, 8), lines):
        assert r["distinct_devices"] == 1 and r["devices"] == ["cpu"] * d
        assert "proxy" in r["unit"] and r["k"] == 3
        assert r["value"] > 0 and r["t1_s"] > 0 and r["td_s"] > 0
        assert r["value"] == r["t1_s"] / (d * r["td_s"])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 3 and all('"scaling_efficiency_' in s for s in printed)
