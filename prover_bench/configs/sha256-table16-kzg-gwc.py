"""SHA-256 of halo2's ``halo2_gadgets/benches/sha256.rs`` on the port's own
Table16 chip, written against ``halo2_tpu_torch``'s frontend: the circuit
that the cells of the configuration ``sha256-table16-kzg-gwc`` prove.

``Table16Chip.configure``, then one instance column with equality enabled;
``Table16Chip.load`` fills the 2^16-row spread table, ``Sha256.process_block``
hashes each padded block, and each digest word's lo and hi dense cells are
copied to instance rows 2i and 2i + 1.  A proof's message is padded with
standard SHA-256 padding to exactly ``config["blocks"]`` blocks; its
instance is the digest's 16 half-words from ``hashlib``.
"""

import hashlib

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.gadgets.sha256 import Sha256, Table16Chip, pad_message


class Sha256Circuit(Circuit):
    def __init__(self, blocks):
        self.blocks = blocks  # one list of 16 Values (32-bit words) a block

    def without_witnesses(self):
        return Sha256Circuit([[Value.unknown() for _ in b] for b in self.blocks])

    @classmethod
    def configure(cls, meta):
        config = Table16Chip.configure(meta)
        instance = meta.instance_column()
        meta.enable_equality(instance)
        return config, instance

    def synthesize(self, config, layouter):
        table_config, instance = config
        chip = Table16Chip(table_config)
        Table16Chip.load(table_config, layouter)
        hasher = Sha256(chip, layouter)
        for block in self.blocks:
            hasher.process_block(block)
        for i, word in enumerate(hasher.digest()):
            layouter.constrain_instance(word.lo.dense.cell, instance, 2 * i)
            layouter.constrain_instance(word.hi.dense.cell, instance, 2 * i + 1)


def blank(config: dict) -> Circuit:
    """The circuit without its witness, for keygen: ``config["blocks"]``
    blocks of unknown words."""
    return Sha256Circuit([[Value.unknown()] * 16 for _ in range(config["blocks"])])


def digest_halves(message: bytes) -> list:
    """The 16 half-words (lo, hi of each big-endian digest word) of SHA-256."""
    digest = hashlib.sha256(message).digest()
    halves = []
    for i in range(8):
        word = int.from_bytes(digest[4 * i:4 * i + 4], "big")
        halves += [word & 0xFFFF, word >> 16]
    return halves


def prove_inputs(config: dict, message: bytes, tamper: bool = False):
    """(circuit, instance columns) of one proof of ``message``.  With
    ``tamper`` (the control) the witness's first message word is off by one
    while the instance stays the true message's digest, so the circuit's
    instance copies fail."""
    blocks = pad_message(message)
    if len(blocks) != config["blocks"]:
        raise ValueError(f"a {len(message)}-byte message pads to {len(blocks)} blocks, "
                         f"not {config['blocks']}")
    if tamper:
        blocks = [list(b) for b in blocks]
        blocks[0][0] = (blocks[0][0] + 1) & 0xFFFFFFFF
    circuit = Sha256Circuit([[Value.known(w) for w in b] for b in blocks])
    return circuit, [digest_halves(message)]
