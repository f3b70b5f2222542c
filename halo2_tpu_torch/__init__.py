"""halo2 proving in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``halo2_tpu`` (kept beside it as the reference):
the same module paths and function names, field elements in the same
``(16, ...)`` limb-major Montgomery layout, and bit-identical proofs.  Field
multiplication (K1, ``fields/mont_mul.py``) and complete EC add / double
(K2 / K3, ``curves/ec_kernels.py``) run as CUDA kernels (``csrc/``) on tensors
on the card and as their plain torch versions on tensors on the CPU, as do
K4 (``fields/mont_mul.py``, the TPU's 16-bit Montgomery algorithm) and the
issue-rate chains B1 / B2 of the roofline (``bench/``).
"""
