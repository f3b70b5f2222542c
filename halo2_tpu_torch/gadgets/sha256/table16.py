"""SHA-256 circuit chip over the 16-bit spread lookup table.

Functional rebuild of the reference Table16 chip
(halo2_gadgets/src/sha256/table16/{message_schedule.rs,compression.rs,
gates.rs}) with this framework's own layout: instead of the reference's
hand-packed subregions, every 16-bit quantity lives in one (tag, dense,
spread) lookup row, and every SHA-256 primitive is ONE linear gate over the
spread/dense cells of a small contiguous block:

  * sigma_0/sigma_1/Sigma_0/Sigma_1 — decompose the word into the pieces cut
    at the rotation boundaries; one equation recomposes the dense pieces, a
    second equates the coefficient-weighted spread pieces with
    spread(even) + 2*spread(odd).  The XOR of the three rotations is the
    even-bits word (each output bit = parity of <=3 input bits).
  * Ch(E,F,G)  = odd(spread E + spread F) + odd(spread(~E) + spread G),
    with spread(~E) = SPREAD_ONES - spread(E)       (disjoint masks -> add).
  * Maj(A,B,C) = odd(spread A + spread B + spread C) (majority = carry bit).
  * mod-2^32 adds — operand halves copied into aux columns, result halves in
    lookup rows, small carry bounded by a range polynomial.

Piece range checks: widths {7,10,11,13} bound the looked-up tag with a
degree-<=4 product; other sub-16 widths add one extra lookup row holding
piece * 2^(16-w) (in-table <=> piece < 2^w).  Max gate degree 5 — the same
as the lookup argument's floor, so the extended domain stays at 4n.

Witness values are Python ints inside Value wrappers; the host oracle in
primitives.py supplies the expected digest for tests (NIST vectors).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ...circuit.layouter import AssignedCell, Layouter, Region
from ...circuit.value import Value
from ...plonk.circuit import Column, ConstraintSystem, Expression, Constant
from ...poly.polynomial import Rotation
from .primitives import IV, ROUND_CONSTANTS, M32
from .spread_table import SpreadTableChip, SpreadTableConfig, get_tag
from .util import even_bits, odd_bits, spread_u16

MASK16 = 0xFFFF
SPREAD_ONES_16 = spread_u16(MASK16)  # 0x55555555
# widths whose exact bound is a tag prefix (tag values 0..3 keep degree <= 5)
TAG_FOR_WIDTH = {7: 0, 10: 1, 11: 2, 13: 3}


@dataclasses.dataclass(frozen=True)
class SigmaPattern:
    """Piece widths (low->high) + the three rotation/shift amounts."""

    widths: tuple
    rotations: tuple  # right-rotations
    shift: Optional[int]  # right-shift (lowercase sigmas) or None

    @property
    def offsets(self):
        offs, acc = [], 0
        for w in self.widths:
            offs.append(acc)
            acc += w
        assert acc == 32
        return offs

    def spread_coeff(self, i: int) -> int:
        """Coefficient of spread(piece_i) in the three-term spread sum."""
        off = self.offsets[i]
        c = 0
        for r in self.rotations:
            c += 4 ** ((off - r) % 32)
        if self.shift is not None and off >= self.shift:
            c += 4 ** (off - self.shift)
        return c

    def apply(self, x: int) -> int:
        """Host evaluation (for witnesses): XOR of the rotations/shift."""
        out = 0
        for r in self.rotations:
            out ^= ((x >> r) | (x << (32 - r))) & M32
        if self.shift is not None:
            out ^= x >> self.shift
        return out


# cuts derived from the rotation amounts (same boundaries as the reference's
# table16 pieces, message_schedule.rs / compression.rs — dictated by the math)
SIGMA_0 = SigmaPattern((3, 4, 11, 14), (7, 18), 3)
SIGMA_1 = SigmaPattern((10, 7, 2, 13), (17, 19), 10)
BIG_SIGMA_0 = SigmaPattern((2, 11, 9, 10), (2, 13, 22), None)
BIG_SIGMA_1 = SigmaPattern((6, 5, 14, 7), (6, 11, 25), None)


@dataclasses.dataclass
class Half:
    """A 16-bit value witnessed in one lookup row."""

    dense: AssignedCell
    spread: AssignedCell


@dataclasses.dataclass
class W32:
    """A 32-bit word as two lookup-row halves (lo, hi)."""

    lo: Half
    hi: Half

    @property
    def value(self) -> Value:
        return self.lo.dense.value.zip(self.hi.dense.value).map(
            lambda t: t[0] + (t[1] << 16)
        )


@dataclasses.dataclass
class Table16Config:
    lookup: SpreadTableConfig
    tag: Column
    dense: Column
    spread: Column
    aux: List[Column]  # a0..a3 (copied operands)
    carry: Column  # add-gate carries (not looked up)
    add_const: Column  # fixed round-constant column
    selectors: dict  # name -> Selector


class Table16Chip:
    """SHA-256 chip. Requires k >= 17 (the 2^16-row spread table)."""

    def __init__(self, config: Table16Config):
        self.config = config

    # ------------------------------------------------------------------
    @classmethod
    def configure(cls, meta: ConstraintSystem) -> Table16Config:
        tag = meta.advice_column()
        dense = meta.advice_column()
        spread = meta.advice_column()
        aux = [meta.advice_column() for _ in range(4)]
        carry = meta.advice_column()
        add_const = meta.fixed_column()
        for col in [dense, spread] + aux:
            meta.enable_equality(col)

        lookup = SpreadTableChip.configure(meta, tag, dense, spread)

        selectors = {}

        def dense_at(cells, r):
            return cells.query_advice(dense, Rotation(r))

        def spread_at(cells, r):
            return cells.query_advice(spread, Rotation(r))

        def tag_at(cells, r):
            return cells.query_advice(tag, Rotation(r))

        def aux_at(cells, j, r):
            return cells.query_advice(aux[j], Rotation(r))

        const_col = meta.fixed_column()
        meta.enable_constant(const_col)

        # -- sigma decomposition gates ---------------------------------
        def make_sigma_gate(key: str, name: str, pat: SigmaPattern):
            sel = meta.selector()
            selectors[key] = sel
            npieces = len(pat.widths)
            shift_rows = [w for w in pat.widths if w < 16 and w not in TAG_FOR_WIDTH]

            def gate(cells):
                s = cells.query_selector(sel)
                constraints = []
                # (a) recompose: X_lo + 2^16 X_hi == sum 2^off_i piece_i
                recomp = None
                for i, off in enumerate(pat.offsets):
                    term = dense_at(cells, i) * (1 << off)
                    recomp = term if recomp is None else recomp + term
                x_in = aux_at(cells, 0, 0) + aux_at(cells, 0, 1) * (1 << 16)
                constraints.append(("recompose", s * (recomp - x_in)))
                # (b) spread sum == even + 2*odd  (rows n..n+3)
                ssum = None
                for i in range(npieces):
                    term = spread_at(cells, i) * pat.spread_coeff(i)
                    ssum = term if ssum is None else ssum + term
                e0, e1 = spread_at(cells, npieces), spread_at(cells, npieces + 1)
                o0, o1 = spread_at(cells, npieces + 2), spread_at(cells, npieces + 3)
                out = e0 + e1 * (4 ** 16) + o0 * 2 + o1 * (2 * 4 ** 16)
                constraints.append(("spread-sum", s * (ssum - out)))
                # (c) tag bounds
                for i, w in enumerate(pat.widths):
                    if w in TAG_FOR_WIDTH:
                        t = TAG_FOR_WIDTH[w]
                        poly = None
                        for j in range(t + 1):
                            f = tag_at(cells, i) - j
                            poly = f if poly is None else poly * f
                        constraints.append((f"tag-{i}", s * poly))
                # (d) shift-range rows (after the 4 output rows)
                row = npieces + 4
                for i, w in enumerate(pat.widths):
                    if w < 16 and w not in TAG_FOR_WIDTH:
                        constraints.append(
                            (
                                f"shift-{i}",
                                s
                                * (
                                    dense_at(cells, row)
                                    - dense_at(cells, i) * (1 << (16 - w))
                                ),
                            )
                        )
                        row += 1
                return constraints

            meta.create_gate(name, gate)

        make_sigma_gate("sigma_0", "sha256 sigma_0", SIGMA_0)
        make_sigma_gate("sigma_1", "sha256 sigma_1", SIGMA_1)
        make_sigma_gate("Sigma_0", "sha256 Sigma_0", BIG_SIGMA_0)
        make_sigma_gate("Sigma_1", "sha256 Sigma_1", BIG_SIGMA_1)

        # -- Ch / Maj spread-sum gates ----------------------------------
        def spread_out(cells):
            e0, e1 = spread_at(cells, 0), spread_at(cells, 1)
            o0, o1 = spread_at(cells, 2), spread_at(cells, 3)
            return e0 + e1 * (4 ** 16) + o0 * 2 + o1 * (2 * 4 ** 16)

        def word(cells, j):
            return aux_at(cells, j, 0) + aux_at(cells, j, 1) * (4 ** 16)

        sel = meta.selector()
        selectors["ch_p"] = sel

        def ch_p_gate(cells):
            s = cells.query_selector(selectors["ch_p"])
            return [("ch-p", s * (word(cells, 0) + word(cells, 1) - spread_out(cells)))]

        meta.create_gate("sha256 ch P", ch_p_gate)

        sel = meta.selector()
        selectors["ch_q"] = sel
        ones = SPREAD_ONES_16 * (1 + 4 ** 16)

        def ch_q_gate(cells):
            s = cells.query_selector(selectors["ch_q"])
            not_e = Constant(ones) - word(cells, 0)
            return [("ch-q", s * (not_e + word(cells, 1) - spread_out(cells)))]

        meta.create_gate("sha256 ch Q", ch_q_gate)

        sel = meta.selector()
        selectors["maj"] = sel

        def maj_gate(cells):
            s = cells.query_selector(selectors["maj"])
            lhs = word(cells, 0) + word(cells, 1) + word(cells, 2)
            return [("maj", s * (lhs - spread_out(cells)))]

        meta.create_gate("sha256 maj", maj_gate)

        # -- add gates ----------------------------------------------------
        def make_add_gate(key: str, name: str, nops: int, with_const: bool, max_carry: int):
            sel = meta.selector()
            selectors[key] = sel

            def gate(cells):
                s = cells.query_selector(sel)
                total = None
                for j in range(nops):
                    term = aux_at(cells, j, 0) + aux_at(cells, j, 1) * (1 << 16)
                    total = term if total is None else total + term
                if with_const:
                    total = total + cells.query_fixed(add_const, Rotation.cur())
                res = dense_at(cells, 0) + dense_at(cells, 1) * (1 << 16)
                cy = cells.query_advice(carry, Rotation.cur())
                rangep = None
                for j in range(max_carry + 1):
                    f = cy - j
                    rangep = f if rangep is None else rangep * f
                return [
                    ("add", s * (total - res - cy * (1 << 32))),
                    ("carry-range", s * rangep),
                ]

            meta.create_gate(name, gate)

        make_add_gate("add2", "sha256 add2", 2, False, 1)
        make_add_gate("add2c", "sha256 add2c", 2, True, 2)
        make_add_gate("add3", "sha256 add3", 3, False, 2)
        make_add_gate("add4", "sha256 add4", 4, False, 3)

        return Table16Config(lookup, tag, dense, spread, aux, carry, add_const, selectors)

    # ------------------------------------------------------------------
    @staticmethod
    def load(config: Table16Config, layouter: Layouter):
        """Fill the 2^16-row spread table (once per circuit)."""
        SpreadTableChip(config.lookup).load(layouter)

    # ------------------------------------------------------------------
    # assignment helpers
    # ------------------------------------------------------------------

    def _assign_lookup_row(self, region: Region, row: int, val16: Value) -> Half:
        cfg = self.config
        region.assign_advice(cfg.tag, row, lambda: val16.map(get_tag))
        d = region.assign_advice(cfg.dense, row, lambda: val16)
        s = region.assign_advice(cfg.spread, row, lambda: val16.map(spread_u16))
        return Half(d, s)

    def assign_word(
        self, layouter: Layouter, name: str, val32: Value,
        pin_constant: Optional[int] = None,
    ) -> W32:
        """Witness a free 32-bit word as two lookup rows; optionally pin it
        to a circuit constant (IV loading)."""

        def do(region):
            lo = self._assign_lookup_row(region, 0, val32.map(lambda v: v & MASK16))
            hi = self._assign_lookup_row(region, 1, val32.map(lambda v: v >> 16))
            if pin_constant is not None:
                region.constrain_constant(lo.dense.cell, pin_constant & MASK16)
                region.constrain_constant(hi.dense.cell, pin_constant >> 16)
            return W32(lo, hi)

        return layouter.assign_region(name, do)

    def sigma(self, layouter: Layouter, name: str, pat: SigmaPattern, x: W32) -> W32:
        """One sigma/Sigma block; returns the even-bits (XOR) output word."""
        cfg = self.config
        npieces = len(pat.widths)

        def do(region):
            cfg.selectors[name.split("/")[0]].enable(region, 0)
            xv = x.value
            # pieces
            for i, (w, off) in enumerate(zip(pat.widths, pat.offsets)):
                piece = xv.map(lambda v, w=w, off=off: (v >> off) & ((1 << w) - 1))
                self._assign_lookup_row(region, i, piece)
            # spread-sum witness
            total = xv.map(
                lambda v: sum(
                    pat.spread_coeff(i)
                    * spread_u16((v >> off) & ((1 << w) - 1))
                    for i, (w, off) in enumerate(zip(pat.widths, pat.offsets))
                )
            )
            even = total.map(lambda t: even_bits(t, 32))
            odd = total.map(lambda t: odd_bits(t, 32))
            e_lo = self._assign_lookup_row(region, npieces, even.map(lambda v: v & MASK16))
            e_hi = self._assign_lookup_row(region, npieces + 1, even.map(lambda v: v >> 16))
            self._assign_lookup_row(region, npieces + 2, odd.map(lambda v: v & MASK16))
            self._assign_lookup_row(region, npieces + 3, odd.map(lambda v: v >> 16))
            # shift-range rows
            row = npieces + 4
            for i, (w, off) in enumerate(zip(pat.widths, pat.offsets)):
                if w < 16 and w not in TAG_FOR_WIDTH:
                    shifted = xv.map(
                        lambda v, w=w, off=off: ((v >> off) & ((1 << w) - 1))
                        << (16 - w)
                    )
                    self._assign_lookup_row(region, row, shifted)
                    row += 1
            # copy in the input halves
            x.lo.dense.copy_advice(region, cfg.aux[0], 0)
            x.hi.dense.copy_advice(region, cfg.aux[0], 1)
            return W32(e_lo, e_hi)

        return layouter.assign_region(name, do)

    def _spread_sum_block(
        self, layouter: Layouter, name: str, selector: str,
        operands: Sequence[W32], negate_first: bool = False,
    ):
        """Ch/Maj core: witness even/odd of the spread sum of operands.

        Returns (even W32, odd W32).  ``negate_first`` replaces operand 0's
        spread with SPREAD_ONES - spread (the ~E of Ch's second term).
        """
        cfg = self.config

        def spread_val(word: W32, flip: bool) -> Value:
            s = word.lo.spread.value.zip(word.hi.spread.value).map(
                lambda t: t[0] + (4 ** 16) * t[1]
            )
            if flip:
                ones = SPREAD_ONES_16 * (1 + 4 ** 16)
                return s.map(lambda v: ones - v)
            return s

        def do(region):
            cfg.selectors[selector].enable(region, 0)
            total = None
            for j, word in enumerate(operands):
                sv = spread_val(word, negate_first and j == 0)
                total = sv if total is None else total.zip(sv).map(lambda t: t[0] + t[1])
                word.lo.spread.copy_advice(region, cfg.aux[j], 0)
                word.hi.spread.copy_advice(region, cfg.aux[j], 1)
            even = total.map(lambda t: even_bits(t, 32))
            odd = total.map(lambda t: odd_bits(t, 32))
            e_lo = self._assign_lookup_row(region, 0, even.map(lambda v: v & MASK16))
            e_hi = self._assign_lookup_row(region, 1, even.map(lambda v: v >> 16))
            o_lo = self._assign_lookup_row(region, 2, odd.map(lambda v: v & MASK16))
            o_hi = self._assign_lookup_row(region, 3, odd.map(lambda v: v >> 16))
            return W32(e_lo, e_hi), W32(o_lo, o_hi)

        return layouter.assign_region(name, do)

    def ch(self, layouter: Layouter, e: W32, f: W32, g: W32):
        """Returns (P_odd, Q_odd); Ch(E,F,G) = P_odd + Q_odd (bit-disjoint)."""
        _, p_odd = self._spread_sum_block(layouter, "ch P", "ch_p", [e, f])
        _, q_odd = self._spread_sum_block(
            layouter, "ch Q", "ch_q", [e, g], negate_first=True
        )
        return p_odd, q_odd

    def maj(self, layouter: Layouter, a: W32, b: W32, c: W32) -> W32:
        _, m_odd = self._spread_sum_block(layouter, "maj", "maj", [a, b, c])
        return m_odd

    def add_words(
        self, layouter: Layouter, name: str, operands: Sequence[W32],
        const: int = 0,
    ) -> W32:
        """result = (sum operands + const) mod 2^32 via one add block."""
        cfg = self.config
        n = len(operands)
        if const:
            assert n == 2, (
                f"const-add only has a 2-operand selector (add2c); got {n} "
                "operands — add an add3c/add4c selector before using this"
            )
            sel = "add2c"
        else:
            sel = {2: "add2", 3: "add3", 4: "add4"}[n]

        def do(region):
            cfg.selectors[sel].enable(region, 0)
            total = None
            for j, word in enumerate(operands):
                v = word.value
                total = v if total is None else total.zip(v).map(lambda t: t[0] + t[1])
                word.lo.dense.copy_advice(region, cfg.aux[j], 0)
                word.hi.dense.copy_advice(region, cfg.aux[j], 1)
            total = total.map(lambda t: t + const)
            res = total.map(lambda t: t & M32)
            cy = total.map(lambda t: t >> 32)
            region.assign_advice(cfg.carry, 0, lambda: cy)
            if const:
                region.assign_fixed(cfg.add_const, 0, const)
            lo = self._assign_lookup_row(region, 0, res.map(lambda v: v & MASK16))
            hi = self._assign_lookup_row(region, 1, res.map(lambda v: v >> 16))
            return W32(lo, hi)

        return layouter.assign_region(name, do)


# ---------------------------------------------------------------------------
# Sha256 gadget (sha256.rs Sha256 struct analog, block-at-a-time)
# ---------------------------------------------------------------------------


class Sha256:
    """Block-oriented SHA-256 hasher over a Table16Chip.

    Mirrors the reference gadget surface (sha256.rs:71-135): construct with
    an initialized chip, feed 16-word blocks, read back the 8-word digest.
    Padding is the caller's job (primitives.pad_message).
    """

    def __init__(self, chip: Table16Chip, layouter: Layouter):
        self.chip = chip
        self.layouter = layouter
        self.state: List[W32] = [
            chip.assign_word(
                layouter, f"iv_{i}", Value.known(IV[i]), pin_constant=IV[i]
            )
            for i in range(8)
        ]

    def process_block(self, block_values: Sequence[Value]):
        chip, layouter = self.chip, self.layouter
        assert len(block_values) == 16

        # message schedule
        w: List[W32] = [
            chip.assign_word(layouter, f"w_{t}", block_values[t]) for t in range(16)
        ]
        for t in range(16, 64):
            s0 = chip.sigma(layouter, f"sigma_0/{t}", SIGMA_0, w[t - 15])
            s1 = chip.sigma(layouter, f"sigma_1/{t}", SIGMA_1, w[t - 2])
            w.append(
                chip.add_words(layouter, f"w_add_{t}", [s1, w[t - 7], s0, w[t - 16]])
            )

        # compression
        a, b, c, d, e, f, g, h = self.state
        for t in range(64):
            sig1 = chip.sigma(layouter, f"Sigma_1/{t}", BIG_SIGMA_1, e)
            p_odd, q_odd = chip.ch(layouter, e, f, g)
            t1a = chip.add_words(layouter, f"t1a_{t}", [h, sig1, p_odd, q_odd])
            t1 = chip.add_words(
                layouter, f"t1_{t}", [t1a, w[t]], const=ROUND_CONSTANTS[t]
            )
            sig0 = chip.sigma(layouter, f"Sigma_0/{t}", BIG_SIGMA_0, a)
            m_odd = chip.maj(layouter, a, b, c)
            e_new = chip.add_words(layouter, f"e_new_{t}", [d, t1])
            a_new = chip.add_words(layouter, f"a_new_{t}", [t1, sig0, m_odd])
            a, b, c, d, e, f, g, h = a_new, a, b, c, e_new, e, f, g

        # final feed-forward adds
        self.state = [
            chip.add_words(layouter, f"ff_{i}", [self.state[i], v])
            for i, v in enumerate([a, b, c, d, e, f, g, h])
        ]

    def digest(self) -> List[W32]:
        return list(self.state)


def sha256_digest_circuit_words(msg: bytes) -> List[int]:
    """Host helper: the padded blocks' words (for witness construction)."""
    from .primitives import pad_message

    return pad_message(msg)
