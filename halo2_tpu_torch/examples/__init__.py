"""The JAX package's ``examples/`` on the port: ``simple_example``,
``serialization`` and ``cost_model``, each ``python -m
halo2_tpu_torch.examples.<name>`` from the repository root, on the card."""
