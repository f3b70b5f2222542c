"""A Poseidon Merkle root over ``config["leaves"]`` leaves on halo2's
``Pow5Chip`` (``halo2_gadgets/benches/poseidon.rs``: P128Pow5T3, width 3,
rate 2, ``ConstantLength<2>``), written against ``halo2_tpu_torch``'s
frontend: the circuit that the cells of the configuration
``poseidon-merkle-kzg-shplonk`` prove.

The columns of the source bench's circuit: 3 state and 1 partial S-box
advice columns, 3 ``rc_a`` and 3 ``rc_b`` fixed columns, ``rc_b[0]`` the
constants column, and one instance column with equality.  The leaves are
assigned in one region, leaf i in state column i mod 3 at row i // 3; then
level by level, left to right, each node is one ``PoseidonHashGadget.hash``
of its two children's cells, copied.  The root is copied to instance row 0.
A proof's message is ``config["leaves"]`` 32-byte little-endian words, each
reduced mod r; its instance is the root from the port's host Poseidon
(``hash_message``).
"""

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.fields.spec import BN254_FR
from halo2_tpu_torch.gadgets.poseidon import (
    ConstantLength,
    PoseidonHashGadget,
    Pow5Chip,
    hash_message,
    p128_pow5_t3,
)

SPEC = p128_pow5_t3(BN254_FR)
LEAF_BYTES = 32


class MerkleCircuit(Circuit):
    def __init__(self, leaves):
        self.leaves = leaves  # one Value a leaf

    def without_witnesses(self):
        return MerkleCircuit([Value.unknown()] * len(self.leaves))

    @classmethod
    def configure(cls, meta):
        state = [meta.advice_column() for _ in range(SPEC.t)]
        partial_sbox = meta.advice_column()
        rc_a = [meta.fixed_column() for _ in range(SPEC.t)]
        rc_b = [meta.fixed_column() for _ in range(SPEC.t)]
        meta.enable_constant(rc_b[0])
        instance = meta.instance_column()
        meta.enable_equality(instance)
        return Pow5Chip.configure(meta, SPEC, state, partial_sbox, rc_a, rc_b), instance

    def synthesize(self, config, layouter):
        pow5, instance = config
        state = pow5.state

        def load(region):
            return [region.assign_advice(state[i % SPEC.t], i // SPEC.t, leaf)
                    for i, leaf in enumerate(self.leaves)]

        level = layouter.assign_region("leaves", load)
        gadget = PoseidonHashGadget(Pow5Chip(pow5), ConstantLength(2))
        while len(level) > 1:
            level = [gadget.hash(layouter, level[i:i + 2]) for i in range(0, len(level), 2)]
        layouter.constrain_instance(level[0].cell, instance, 0)


def blank(config: dict) -> Circuit:
    """The circuit without its witness, for keygen."""
    return MerkleCircuit([Value.unknown()] * config["leaves"])


def leaves_of(config: dict, message: bytes) -> list:
    """The leaves of ``message``: its 32-byte little-endian words mod r."""
    if len(message) != config["leaves"] * LEAF_BYTES:
        raise ValueError(f"a {len(message)}-byte message is not {config['leaves']} leaves of "
                         f"{LEAF_BYTES} bytes")
    return [int.from_bytes(message[i:i + LEAF_BYTES], "little") % BN254_FR.p
            for i in range(0, len(message), LEAF_BYTES)]


def merkle_root(leaves: list) -> int:
    """The root of the whole binary tree over ``leaves``, one Poseidon
    ``ConstantLength(2)`` hash a node."""
    domain = ConstantLength(2)
    level = list(leaves)
    while len(level) > 1:
        level = [hash_message(SPEC, domain, level[i:i + 2]) for i in range(0, len(level), 2)]
    return level[0]


def prove_inputs(config: dict, message: bytes, tamper: bool = False):
    """(circuit, instance columns) of one proof of ``message``.  With
    ``tamper`` (the control) leaf 0 of the witness is off by one while the
    instance stays the true leaves' root, so the root's instance copy
    fails."""
    leaves = leaves_of(config, message)
    root = merkle_root(leaves)
    if tamper:
        leaves[0] = (leaves[0] + 1) % BN254_FR.p
    return MerkleCircuit([Value.known(v) for v in leaves]), [[root]]
