"""Sinsemilla hash gadget (halo2_gadgets/src/sinsemilla.rs rebuild)."""

from . import primitives
from .primitives import K, C, HashDomain, CommitDomain, sinsemilla_s
