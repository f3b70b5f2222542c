"""The JAX package's ``examples/`` on the port: ``simple_example``,
``serialization``, ``cost_model``, ``two_chip``, ``shuffle`` and
``circuit_layout``, each ``python -m halo2_tpu_torch.examples.<name>`` from
the repository root, on the card."""
