"""Sinsemilla hash chip: 10-bit lookup + merged double-and-add.

Rebuild of halo2_gadgets/src/sinsemilla/{chip.rs, chip/generator_table.rs,
chip/hash_to_point.rs, message.rs} for this package's circuit API.  The
constraint system is identical to the reference (it is consensus logic):

- ``q_sinsemilla1`` (complex selector) gates the per-word double-and-add rows
  and the (idx, x_p, y_p) generator lookup.
- ``q_sinsemilla2`` is a non-binary fixed column: 1 on all but the last row
  of a piece, 0 on a piece boundary, 2 on the final row of the message; the
  synthetic ``q_s3 = q_s2 * (q_s2 - 1)`` distinguishes the final row.
- ``q_sinsemilla4`` pins the initial accumulator to the domain's Q.
- The accumulator y-coordinate is never witnessed until the end: the gates
  express ``Y_A = (lambda_1 + lambda_2) * (x_a - x_r)`` (chip.rs:193-265).

Witness values are canonical Python ints mod the Pallas base field.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ...circuit.layouter import AssignedCell, Layouter, Region
from ...circuit.value import Assigned, Value
from ...curves.spec import PALLAS
from ...plonk.circuit import (
    Column,
    Constant,
    ConstraintSystem,
    Selector,
    TableColumn,
)
from ...plonk.error import SynthesisError
from ...poly.polynomial import Rotation
from ..utilities import LookupRangeCheckConfig, i2lebsp, lebs2ip
from .primitives import K, C, sinsemilla_s

P = PALLAS.base.p
INV_TWO_POW_K = pow(1 << K, -1, P)


def _ev(v) -> int:
    """Canonical int from an int or deferred-division Assigned value."""
    if isinstance(v, Assigned):
        if v.denominator == 1:
            return v.numerator % P
        return v.numerator * pow(v.denominator, -1, P) % P
    return v % P


@dataclasses.dataclass
class MessagePiece:
    """A message piece of ``num_words`` K-bit words in one cell (message.rs:37-68)."""

    cell_value: AssignedCell
    num_words: int

    def field_elem(self) -> Value:
        return self.cell_value.value


@dataclasses.dataclass
class SinsemillaConfig:
    q_sinsemilla1: Selector
    q_sinsemilla2: Column  # fixed, non-binary {0, 1, 2}
    q_sinsemilla4: Selector
    fixed_y_q: Column
    # double-and-add columns (ecc/chip/mul/incomplete.rs DoubleAndAdd)
    x_a: Column
    x_p: Column
    lambda_1: Column
    lambda_2: Column
    bits: Column
    witness_pieces: Column
    table_idx: TableColumn
    table_x: TableColumn
    table_y: TableColumn
    lookup_config: LookupRangeCheckConfig

    def advices(self) -> List[Column]:
        return [self.x_a, self.x_p, self.bits, self.lambda_1, self.lambda_2]


def _x_r(cells, cfg: SinsemillaConfig, rot: Rotation):
    x_a = cells.query_advice(cfg.x_a, rot)
    x_p = cells.query_advice(cfg.x_p, rot)
    lambda_1 = cells.query_advice(cfg.lambda_1, rot)
    return lambda_1.square() - x_a - x_p


def _Y_A(cells, cfg: SinsemillaConfig, rot: Rotation):
    x_a = cells.query_advice(cfg.x_a, rot)
    lambda_1 = cells.query_advice(cfg.lambda_1, rot)
    lambda_2 = cells.query_advice(cfg.lambda_2, rot)
    return (lambda_1 + lambda_2) * (x_a - _x_r(cells, cfg, rot))


class SinsemillaChip:
    """10-bit Sinsemilla chip over 5 advice columns (chip.rs:97-265)."""

    def __init__(self, config: SinsemillaConfig):
        self.config = config

    @classmethod
    def configure(
        cls,
        meta: ConstraintSystem,
        advices: List[Column],  # 5 columns: [x_a, x_p, bits, lambda_1, lambda_2]
        witness_pieces: Column,
        fixed_y_q: Column,
        lookup: Tuple[TableColumn, TableColumn, TableColumn],
        range_check: LookupRangeCheckConfig,
    ) -> SinsemillaConfig:
        assert len(advices) == 5
        for advice in advices:
            meta.enable_equality(advice)

        config = SinsemillaConfig(
            q_sinsemilla1=meta.complex_selector(),
            q_sinsemilla2=meta.fixed_column(),
            q_sinsemilla4=meta.selector(),
            fixed_y_q=fixed_y_q,
            x_a=advices[0],
            x_p=advices[1],
            bits=advices[2],
            lambda_1=advices[3],
            lambda_2=advices[4],
            witness_pieces=witness_pieces,
            table_idx=lookup[0],
            table_x=lookup[1],
            table_y=lookup[2],
            lookup_config=range_check,
        )

        def q_s3(cells):
            q_s2 = cells.query_fixed(config.q_sinsemilla2, Rotation.cur())
            return q_s2 * (q_s2 - Constant(1))

        # generator-table lookup (generator_table.rs:40-78)
        s0_x, s0_y = sinsemilla_s()[0]

        def table_map(cells):
            q_s1 = cells.query_selector(config.q_sinsemilla1)
            q_s2 = cells.query_fixed(config.q_sinsemilla2, Rotation.cur())
            q_run = q_s2 - q_s3(cells)

            z_cur = cells.query_advice(config.bits, Rotation.cur())
            z_next = cells.query_advice(config.bits, Rotation.next())
            # m_{i+1} = z_i - 2^K * q_run * z_{i+1}
            word = z_cur - q_run * z_next * (1 << K)

            x_p = cells.query_advice(config.x_p, Rotation.cur())
            # y_p = Y_A/2 - lambda_1 * (x_a - x_p)
            lambda_1 = cells.query_advice(config.lambda_1, Rotation.cur())
            x_a = cells.query_advice(config.x_a, Rotation.cur())
            y_p = _Y_A(cells, config, Rotation.cur()) * PALLAS.base.two_inv - lambda_1 * (
                x_a - x_p
            )

            not_q_s1 = Constant(1) - q_s1
            m = q_s1 * word
            x_p_l = q_s1 * x_p + not_q_s1 * s0_x
            y_p_l = q_s1 * y_p + not_q_s1 * s0_y
            return [
                (m, config.table_idx),
                (x_p_l, config.table_x),
                (y_p_l, config.table_y),
            ]

        meta.lookup("generator_table", table_map)

        # Initial accumulator consistency with y_Q (chip.rs:203-216)
        def init_y_q(cells):
            q_s4 = cells.query_selector(config.q_sinsemilla4)
            y_q = cells.query_fixed(config.fixed_y_q, Rotation.cur())
            y_a_cur = _Y_A(cells, config, Rotation.cur())
            return [("init_y_q_check", q_s4 * (y_q * 2 - y_a_cur))]

        meta.create_gate("Initial y_Q", init_y_q)

        # Main Sinsemilla gate (chip.rs:218-263)
        def sinsemilla_gate(cells):
            q_s1 = cells.query_selector(config.q_sinsemilla1)
            q_s3_e = q_s3(cells)
            lambda_1_next = cells.query_advice(config.lambda_1, Rotation.next())
            lambda_2_cur = cells.query_advice(config.lambda_2, Rotation.cur())
            x_a_cur = cells.query_advice(config.x_a, Rotation.cur())
            x_a_next = cells.query_advice(config.x_a, Rotation.next())
            x_r = _x_r(cells, config, Rotation.cur())
            y_a_cur = _Y_A(cells, config, Rotation.cur())
            y_a_next = _Y_A(cells, config, Rotation.next())

            secant_line = lambda_2_cur.square() - (x_a_next + x_r + x_a_cur)
            lhs = lambda_2_cur * 4 * (x_a_cur - x_a_next)
            # y_a_final is assigned to lambda_1 on the next offset
            rhs = y_a_cur * 2 + (Constant(2) - q_s3_e) * y_a_next + q_s3_e * 2 * lambda_1_next
            return [
                ("Secant line", q_s1 * secant_line),
                ("y check", q_s1 * (lhs - rhs)),
            ]

        meta.create_gate("Sinsemilla gate", sinsemilla_gate)
        return config

    @staticmethod
    def load(config: SinsemillaConfig, layouter: Layouter):
        """Load the 2^K generator table (generator_table.rs:80-97)."""

        def do(table):
            for index, (x, y) in enumerate(sinsemilla_s()):
                table.assign_cell(config.table_idx, index, lambda i=index: Value.known(i))
                table.assign_cell(config.table_x, index, lambda v=x: Value.known(v))
                table.assign_cell(config.table_y, index, lambda v=y: Value.known(v))

        layouter.get_root().assign_table("generator_table", do)

    # -- SinsemillaInstructions (chip.rs:268-327) ---------------------------

    def witness_message_piece(
        self, layouter: Layouter, field_elem: Value, num_words: int
    ) -> MessagePiece:
        assert num_words * K < P.bit_length()

        def do(region: Region):
            return region.assign_advice(self.config.witness_pieces, 0, lambda: field_elem)

        cell = layouter.namespace("witness message piece").assign_region(
            "witness message piece", do
        )
        return MessagePiece(cell, num_words)

    def hash_to_point(self, layouter: Layouter, Q: Tuple[int, int], message: List[MessagePiece]):
        """Hash a message; returns ((x_cell, y_cell), zs per piece).

        ``Q`` is a host affine point.  Mirrors hash_to_point.rs:25-170.
        """
        assert sum(m.num_words for m in message) <= C

        def do(region: Region):
            return self._hash_message(region, Q, message)

        return layouter.namespace("hash_to_point").assign_region("hash_to_point", do)

    @staticmethod
    def extract(point) -> AssignedCell:
        return point[0]

    # -- internals ----------------------------------------------------------

    def _hash_message(self, region: Region, Q, message: List[MessagePiece]):
        config = self.config
        x_q, y_q = Q
        offset = 0

        config.q_sinsemilla4.enable(region, offset)
        region.assign_fixed(config.fixed_y_q, offset, lambda: Value.known(y_q))
        y_a = Value.known(y_q)
        x_a = region.assign_advice_from_constant(config.x_a, offset, x_q)

        zs_sum = []
        for idx, piece in enumerate(message):
            final_piece = idx == len(message) - 1
            x_a, y_a, zs = self._hash_piece(region, offset, piece, x_a, y_a, final_piece)
            offset += piece.num_words
            zs_sum.append(zs)

        # Assign the final y_a; lambda_2/x_p on this row are queried by the
        # gate but multiplied by zero, so assign zeros (hash_to_point.rs:97-120)
        y_a_cell = region.assign_advice(config.lambda_1, offset, lambda: y_a)
        region.assign_advice(config.lambda_2, offset, lambda: Value.known(0))
        region.assign_advice(config.x_p, offset, lambda: Value.known(0))

        # NonIdentity check (hash_to_point.rs:162-166)
        xv, yv = x_a.value.map(_ev).value(), y_a_cell.value.map(_ev).value()
        if xv is not None and yv is not None and (xv == 0 or yv == 0):
            raise SynthesisError("Sinsemilla hash produced the identity (⊥)")
        return (x_a, y_a_cell), zs_sum

    def _hash_piece(
        self,
        region: Region,
        offset: int,
        piece: MessagePiece,
        x_a: AssignedCell,
        y_a: Value,
        final_piece: bool,
    ):
        """One message piece: selectors, z running sum, double-and-add rows
        (hash_to_point.rs:172-372)."""
        config = self.config
        n = piece.num_words

        for row in range(n):
            config.q_sinsemilla1.enable(region, offset + row)
        for row in range(n - 1):
            region.assign_fixed(config.q_sinsemilla2, offset + row, lambda: Value.known(1))
        last = Value.known(2 if final_piece else 0)
        region.assign_fixed(config.q_sinsemilla2, offset + n - 1, lambda: last)

        # words + generators from the piece value (unknown-safe)
        words_v = piece.field_elem().map(
            lambda v: [lebs2ip(i2lebsp(v, K * n)[i * K : (i + 1) * K]) for i in range(n)]
        )
        s_table = sinsemilla_s()
        gens_v = words_v.map(lambda ws: [s_table[w] for w in ws])

        # z running sum: z_0 = piece; z_{i+1} = (z_i - m_{i+1}) / 2^K
        zs = [piece.cell_value.copy_advice(region, config.bits, offset)]
        z = piece.field_elem()
        for idx in range(n - 1):
            word_i = words_v.map(lambda ws, i=idx: ws[i])
            z = z.zip(word_i).map(lambda t: (t[0] - t[1]) * INV_TWO_POW_K % P)
            zs.append(region.assign_advice(config.bits, offset + idx + 1, lambda v=z: v))

        # double-and-add rows
        for row in range(n):
            gen = gens_v.map(lambda g, r=row: g[r])
            x_p_v = gen.map(lambda g: g[0])
            y_p_v = gen.map(lambda g: g[1])
            region.assign_advice(config.x_p, offset + row, lambda v=x_p_v: v)

            x_a_v = x_a.value.map(_ev)
            lambda_1 = (
                y_a.zip(y_p_v)
                .zip(x_a_v.zip(x_p_v))
                .map(lambda t: (t[0][0] - t[0][1]) * pow((t[1][0] - t[1][1]) % P, -1, P) % P)
            )
            region.assign_advice(config.lambda_1, offset + row, lambda v=lambda_1: v)

            x_r = (
                lambda_1.zip(x_a_v.zip(x_p_v)).map(lambda t: (t[0] * t[0] - t[1][0] - t[1][1]) % P)
            )
            lambda_2 = (
                y_a.zip(x_a_v.zip(x_r))
                .zip(lambda_1)
                .map(lambda t: (2 * t[0][0] * pow((t[0][1][0] - t[0][1][1]) % P, -1, P) - t[1]) % P)
            )
            region.assign_advice(config.lambda_2, offset + row, lambda v=lambda_2: v)

            x_a_new_v = lambda_2.zip(x_a_v.zip(x_r)).map(
                lambda t: (t[0] * t[0] - t[1][0] - t[1][1]) % P
            )
            x_a_new = region.assign_advice(config.x_a, offset + row + 1, lambda v=x_a_new_v: v)
            y_a = (
                lambda_2.zip(x_a_v.zip(x_a_new_v))
                .zip(y_a)
                .map(lambda t: (t[0][0] * (t[0][1][0] - t[0][1][1]) - t[1]) % P)
            )
            x_a = x_a_new

        return x_a, y_a, zs


def message_from_bitstring(
    chip: SinsemillaChip, layouter: Layouter, bitstring: List[Value]
) -> List[MessagePiece]:
    """Split a bitstring (list of Value[bool]) into max-width message pieces
    (sinsemilla.rs:113-162)."""
    assert len(bitstring) % K == 0
    assert len(bitstring) // K <= C
    piece_num_words = (P.bit_length() - 1) // K  # floor(CAPACITY / K) = 25
    pieces = []
    for i in range(0, len(bitstring), piece_num_words * K):
        chunk = bitstring[i : i + piece_num_words * K]
        num_words = len(chunk) // K
        # collapse Vec<Value<bool>> -> Value<int>
        elem = Value.known(0)
        for j, b in enumerate(reversed(chunk)):
            elem = elem.zip(b).map(lambda t: t[0] * 2 + (1 if t[1] else 0))
        pieces.append(chip.witness_message_piece(layouter, elem, num_words))
    return pieces


class HashDomainGadget:
    """Circuit-side HashDomain (sinsemilla.rs:510-610)."""

    def __init__(self, chip: SinsemillaChip, Q: Tuple[int, int]):
        self.chip = chip
        self.Q = Q

    def hash_to_point(self, layouter: Layouter, message: List[MessagePiece]):
        return self.chip.hash_to_point(layouter, self.Q, message)

    def hash(self, layouter: Layouter, message: List[MessagePiece]):
        point, zs = self.hash_to_point(layouter, message)
        return SinsemillaChip.extract(point), zs


class CommitDomainGadget:
    """Circuit-side CommitDomain (sinsemilla.rs:612-755): commit(msg, r) =
    hash_to_point(msg) + [r]R with R a fixed base (windowed full-width mul)."""

    def __init__(self, sin_chip: SinsemillaChip, mul_fixed_chip, Q, R):
        self.M = HashDomainGadget(sin_chip, Q)
        self.mul_fixed_chip = mul_fixed_chip
        self.R = R

    def commit(self, layouter: Layouter, message: List[MessagePiece], r: Value):
        """Returns ((x_cell, y_cell) EccPoint, zs)."""
        from ..ecc.chip import EccPoint

        (blind,) = (self.mul_fixed_chip.mul_full_width(layouter, r, self.R),)
        (hash_pt, zs) = self.M.hash_to_point(layouter, message)
        hash_point = EccPoint(hash_pt[0], hash_pt[1])
        result = self.mul_fixed_chip.ecc.add(layouter, hash_point, blind)
        return result, zs

    def short_commit(self, layouter: Layouter, message: List[MessagePiece], r: Value):
        point, zs = self.commit(layouter, message, r)
        return point.x, zs
