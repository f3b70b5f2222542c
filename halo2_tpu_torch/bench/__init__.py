"""Measurements of the port on the card: ``roofline`` (the integer and
tensor-core ceilings, and K1 / K4 against them) and its issue-rate kernels
B1 / B2 (``int_chains``)."""
