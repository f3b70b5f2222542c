"""The k=6 ``EntryCircuit`` proof sharded over a CPU mesh of eight devices
equals the pin ``tests/data/dryrun_proof_k6.hex`` (D = 2 and 4 are in
``test_torch_parallel.py`` and ``test_torch_parallel_dryrun.py``; at D = 8
every commitment runs eight per-device MSMs, so this proof has a file of its
own for xdist).  Tolerance: exact.
"""

import torch

from test_torch_parallel import dryrun_equals_the_pin

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers


def test_sharded_proof_equals_the_pin_d8():
    dryrun_equals_the_pin(8)
