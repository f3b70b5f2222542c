"""Merkle CRH chip + path gadget over Sinsemilla.

Rebuild of halo2_gadgets/src/sinsemilla/{merkle.rs, merkle/chip.rs}: the
MerkleCRH hash ``SinsemillaHash(Q, l* || left* || right*)`` with the piece
decomposition

    a = a_0 || a_1 = l || (bits 0..240 of left)          (250 bits)
    b = b_0 || b_1 || b_2
      = left[240..250) || left[250..255) || right[0..5)  (20 bits)
    c = right[5..255)                                    (250 bits)

and the two-row decomposition gate (merkle/chip.rs:100-185):

    |  A_0  |  A_1  |  A_2  |  A_3  |  A_4  | q_decompose |
    |   a   |   b   |   c   |  left | right |      1      |
    |  z1_a |  z1_b |  b_1  |  b_2  |   l   |      0      |

``left*``/``right*`` are allowed to be non-canonical 255-bit encodings, as in
the Orchard spec.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ...circuit.layouter import AssignedCell, Layouter, Region
from ...circuit.value import Value
from ...plonk.circuit import Column, ConstraintSystem, Selector
from ...poly.polynomial import Rotation
from ..utilities import CondSwapChip, CondSwapConfig, bitrange_subset
from . import primitives as prim
from .chip import P, MessagePiece, SinsemillaChip, SinsemillaConfig, _ev

MERKLE_CRH_PERSONALIZATION = "z.cash:Orchard-MerkleCRH"

NUM_BITS = 255  # pallas base field bit length


@dataclasses.dataclass
class MerkleConfig:
    advices: List[Column]
    q_decompose: Selector
    cond_swap_config: CondSwapConfig
    sinsemilla_config: SinsemillaConfig


class MerkleChip:
    """MerkleInstructions over the Sinsemilla chip (merkle/chip.rs:54-417)."""

    def __init__(self, config: MerkleConfig):
        self.config = config

    @classmethod
    def configure(cls, meta: ConstraintSystem, sinsemilla_config: SinsemillaConfig) -> MerkleConfig:
        advices = sinsemilla_config.advices()
        cond_swap_config = CondSwapChip.configure(meta, advices)
        q_decompose = meta.selector()

        def decomposition_gate(cells):
            q = cells.query_selector(q_decompose)
            two_pow_5 = 1 << 5
            two_pow_10 = 1 << 10
            two_pow_240 = 1 << 240

            a_whole = cells.query_advice(advices[0], Rotation.cur())
            b_whole = cells.query_advice(advices[1], Rotation.cur())
            c_whole = cells.query_advice(advices[2], Rotation.cur())
            left_node = cells.query_advice(advices[3], Rotation.cur())
            right_node = cells.query_advice(advices[4], Rotation.cur())

            z1_a = cells.query_advice(advices[0], Rotation.next())
            z1_b = cells.query_advice(advices[1], Rotation.next())
            b_1 = cells.query_advice(advices[2], Rotation.next())
            b_2 = cells.query_advice(advices[3], Rotation.next())
            l_whole = cells.query_advice(advices[4], Rotation.next())

            a_1 = z1_a
            a_0 = a_whole - a_1 * two_pow_10
            b1_b2_check = z1_b - (b_1 + b_2 * two_pow_5)
            b_0 = b_whole - z1_b * two_pow_10
            left_check = a_1 + (b_0 + b_1 * two_pow_10) * two_pow_240 - left_node
            right_check = b_2 + c_whole * two_pow_5 - right_node

            return [
                ("l_check", q * (a_0 - l_whole)),
                ("left_check", q * left_check),
                ("right_check", q * right_check),
                ("b1_b2_check", q * b1_b2_check),
            ]

        meta.create_gate("Decomposition check", decomposition_gate)
        return MerkleConfig(advices, q_decompose, cond_swap_config, sinsemilla_config)

    # -- CondSwapInstructions ------------------------------------------------

    def swap(self, layouter: Layouter, pair: Tuple[AssignedCell, Value], swap: Value):
        return CondSwapChip(self.config.cond_swap_config).swap(layouter, pair, swap)

    # -- MerkleInstructions --------------------------------------------------

    def hash_layer(
        self,
        layouter: Layouter,
        Q: Tuple[int, int],
        l: int,
        left: AssignedCell,
        right: AssignedCell,
    ) -> AssignedCell:
        """MerkleCRH of one layer (merkle/chip.rs:208-417)."""
        config = self.config
        sin_chip = SinsemillaChip(config.sinsemilla_config)
        lookup = config.sinsemilla_config.lookup_config

        left_v = left.value.map(_ev)
        right_v = right.value.map(_ev)

        # a = l || left[0..240)
        a_v = left_v.map(lambda v: (l + bitrange_subset(v, 0, 240) * (1 << 10)) % P)
        a = sin_chip.witness_message_piece(layouter, a_v, 25)

        # b_1 = left[250..255), b_2 = right[0..5) — short range-constrained
        b_1 = lookup.witness_short_check(
            layouter, left_v.map(lambda v: bitrange_subset(v, 250, NUM_BITS)), 5
        )
        b_2 = lookup.witness_short_check(
            layouter, right_v.map(lambda v: bitrange_subset(v, 0, 5)), 5
        )
        # b = b_0 || b_1 || b_2
        b_v = left_v.zip(right_v).map(
            lambda t: bitrange_subset(t[0], 240, 250)
            + (bitrange_subset(t[0], 250, NUM_BITS) << 10)
            + (bitrange_subset(t[1], 0, 5) << 15)
        )
        b = sin_chip.witness_message_piece(layouter, b_v, 2)

        # c = right[5..255)
        c_v = right_v.map(lambda v: bitrange_subset(v, 5, NUM_BITS))
        c = sin_chip.witness_message_piece(layouter, c_v, 25)

        (point, zs) = sin_chip.hash_to_point(layouter, Q, [a, b, c])
        hash_cell = SinsemillaChip.extract(point)

        z1_a = zs[0][1]
        z1_b = zs[1][1]

        def do(region: Region):
            config.q_decompose.enable(region, 0)
            region.assign_advice_from_constant(config.advices[4], 1, l)
            a.cell_value.copy_advice(region, config.advices[0], 0)
            b.cell_value.copy_advice(region, config.advices[1], 0)
            c.cell_value.copy_advice(region, config.advices[2], 0)
            left.copy_advice(region, config.advices[3], 0)
            right.copy_advice(region, config.advices[4], 0)
            z1_a.copy_advice(region, config.advices[0], 1)
            z1_b.copy_advice(region, config.advices[1], 1)
            b_1.copy_advice(region, config.advices[2], 1)
            b_2.copy_advice(region, config.advices[3], 1)

        layouter.namespace("decompose").assign_region("Check piece decomposition", do)

        # Cross-check the in-circuit hash against the host primitive when the
        # witnesses are known (merkle/chip.rs:379-414 does this under cfg(test))
        lv, rv, hv = left_v.value(), right_v.value(), hash_cell.value.map(_ev).value()
        if lv is not None and hv is not None:
            domain = prim.HashDomain("", _Q=Q)
            msg = (
                prim.i2lebsp(l, 10)
                + prim.i2lebsp(lv, NUM_BITS)
                + prim.i2lebsp(rv, NUM_BITS)
            )
            expected = domain.hash(msg)
            assert expected == hv, (expected, hv)

        return hash_cell


class MerklePath:
    """Merkle path validity gadget (merkle.rs:47-172).

    ``path`` is a Value of the sibling list ordered leaves -> root; ``leaf_pos``
    a Value of the leaf position.  Hashing can be distributed over several
    chips (the PAR dimension of the reference) by passing more than one chip.
    """

    def __init__(self, chips: List[MerkleChip], Q: Tuple[int, int], leaf_pos: Value, path: Value, path_length: int):
        assert chips
        self.chips = chips
        self.Q = Q
        self.leaf_pos = leaf_pos
        self.path = path
        self.path_length = path_length

    def calculate_root(self, layouter: Layouter, leaf: AssignedCell) -> AssignedCell:
        layers_per_chip = -(-self.path_length // len(self.chips))
        node = leaf
        for l in range(self.path_length):
            chip = self.chips[l // layers_per_chip]
            sibling = self.path.map(lambda pth, i=l: pth[i])
            pos = self.leaf_pos.map(lambda pv, i=l: (pv >> i) & 1)
            pair = chip.swap(layouter.namespace(f"node position {l}"), (node, sibling), pos)
            node = chip.hash_layer(
                layouter.namespace(f"MerkleCRH({l}, left, right)"),
                self.Q,
                l,
                pair[0],
                pair[1],
            )
        return node
