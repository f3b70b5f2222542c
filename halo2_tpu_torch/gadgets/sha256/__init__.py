"""SHA-256 gadget (SURVEY.md §2.33).

Host primitives (FIPS 180-4 reference implementation), spread/interleave
utilities, the (tag, dense, spread) lookup table chip
(halo2_gadgets/src/sha256/table16/spread_table.rs), and the full circuit
chip + Sha256 gadget (table16.py) covering the message schedule and
compression (table16/{message_schedule.rs,compression.rs} rebuilt on a
uniform spread-row layout).
"""

from .primitives import pad_message, sha256_compress, sha256_digest
from .spread_table import SpreadTableChip, SpreadTableConfig, SpreadWord, get_tag
from .table16 import Sha256, Table16Chip, Table16Config, W32
from .util import even_bits, interleave_u16, odd_bits, spread_u16

__all__ = [
    "pad_message",
    "sha256_compress",
    "sha256_digest",
    "Sha256",
    "Table16Chip",
    "Table16Config",
    "W32",
    "SpreadTableChip",
    "SpreadTableConfig",
    "SpreadWord",
    "get_tag",
    "spread_u16",
    "interleave_u16",
    "even_bits",
    "odd_bits",
]
