"""Utility gadgets: bool/range checks, running-sum decomposition, conditional
swap, K-bit lookup range checks.

Rebuild of halo2_gadgets/src/utilities{.rs,/cond_swap.rs,
/decompose_running_sum.rs,/lookup_range_check.rs} (SURVEY.md §2.31).  Witness
values are canonical Python ints.
"""

from __future__ import annotations

from typing import List

from ..circuit.layouter import AssignedCell, Layouter, Region
from ..circuit.value import Value
from ..plonk.circuit import Column, Constant, ConstraintSystem, Expression, Selector, TableColumn
from ..poly.polynomial import Rotation


# ---------------------------------------------------------------------------
# expression helpers (utilities.rs:133-175)
# ---------------------------------------------------------------------------


def bool_check(value: Expression) -> Expression:
    """value * (1 - value) ... via range_check(value, 2)."""
    return range_check(value, 2)


def ternary(a: Expression, b: Expression, c: Expression) -> Expression:
    """If a then b else c: a*b + (1-a)*c (a must be boolean-constrained)."""
    one_minus_a = Constant(1) - a
    return a * b + one_minus_a * c


def range_check(word: Expression, range_: int) -> Expression:
    """word * (1 - word) * (2 - word) * ... * (range-1 - word)."""
    expr = word
    for i in range(1, range_):
        expr = expr * (Constant(i) - word)
    return expr


def bitrange_subset(value: int, start: int, end: int) -> int:
    """Bits [start, end) of the canonical little-endian value."""
    return (value >> start) & ((1 << (end - start)) - 1)


def decompose_word(word: int, word_num_bits: int, window_num_bits: int) -> List[int]:
    """Little-endian window decomposition (utilities.rs decompose_word)."""
    assert window_num_bits <= 8
    num_windows = (word_num_bits + window_num_bits - 1) // window_num_bits
    return [
        (word >> (i * window_num_bits)) & ((1 << window_num_bits) - 1)
        for i in range(num_windows)
    ]


def lebs2ip(bits: List[bool]) -> int:
    assert len(bits) <= 64
    return sum(1 << i for i, b in enumerate(bits) if b)


def i2lebsp(value: int, length: int) -> List[bool]:
    assert value < (1 << length)
    return [bool((value >> i) & 1) for i in range(length)]


def load_private(layouter: Layouter, column: Column, value: Value) -> AssignedCell:
    """UtilitiesInstructions::load_private (utilities.rs:53-73)."""

    def do(region: Region):
        return region.assign_advice(column, 0, lambda: value)

    return layouter.namespace("load private").assign_region("load private", do)


# ---------------------------------------------------------------------------
# CondSwapChip (cond_swap.rs)
# ---------------------------------------------------------------------------


class CondSwapConfig:
    def __init__(self, q_swap, a, b, a_swapped, b_swapped, swap):
        self.q_swap = q_swap
        self.a = a
        self.b = b
        self.a_swapped = a_swapped
        self.b_swapped = b_swapped
        self.swap = swap


class CondSwapChip:
    def __init__(self, config: CondSwapConfig):
        self.config = config

    @staticmethod
    def configure(meta: ConstraintSystem, advices: List[Column]) -> CondSwapConfig:
        a = advices[0]
        meta.enable_equality(a)
        q_swap = meta.selector()
        config = CondSwapConfig(q_swap, a, advices[1], advices[2], advices[3], advices[4])

        def gate(cells):
            s = cells.query_selector(q_swap)
            a_e = cells.query_advice(config.a, Rotation.cur())
            b_e = cells.query_advice(config.b, Rotation.cur())
            a_sw = cells.query_advice(config.a_swapped, Rotation.cur())
            b_sw = cells.query_advice(config.b_swapped, Rotation.cur())
            swap = cells.query_advice(config.swap, Rotation.cur())
            return [
                ("a check", s * (a_sw - ternary(swap, b_e, a_e))),
                ("b check", s * (b_sw - ternary(swap, a_e, b_e))),
                ("swap is bool", s * bool_check(swap)),
            ]

        meta.create_gate("a' = b * swap + a * (1-swap)", gate)
        return config

    def swap(self, layouter: Layouter, pair, swap_value: Value):
        """pair: (AssignedCell a, Value b); swap_value: Value of bool."""
        config = self.config

        def do(region: Region):
            config.q_swap.enable(region, 0)
            a = pair[0].copy_advice(region, config.a, 0)
            b = region.assign_advice(config.b, 0, lambda: pair[1])
            swap_val = swap_value.map(lambda s: int(bool(s)))
            region.assign_advice(config.swap, 0, lambda: swap_val)

            ab_swap = a.value.zip(b.value).zip(swap_value)
            a_swapped = region.assign_advice(
                config.a_swapped,
                0,
                lambda: ab_swap.map(lambda t: t[0][1] if t[1] else t[0][0]),
            )
            b_swapped = region.assign_advice(
                config.b_swapped,
                0,
                lambda: ab_swap.map(lambda t: t[0][0] if t[1] else t[0][1]),
            )
            return a_swapped, b_swapped

        return layouter.namespace("swap").assign_region("swap", do)


# ---------------------------------------------------------------------------
# RunningSumConfig (decompose_running_sum.rs)
# ---------------------------------------------------------------------------


class RunningSumConfig:
    """K-bit windowed running-sum decomposition with a small range-check gate."""

    def __init__(self, q_range_check: Selector, z: Column, window_num_bits: int, field):
        self.q_range_check = q_range_check
        self.z = z
        self.window_num_bits = window_num_bits
        self.field = field

    @staticmethod
    def configure(meta: ConstraintSystem, q_range_check: Selector, z: Column,
                  window_num_bits: int, field) -> "RunningSumConfig":
        assert window_num_bits <= 3
        meta.enable_equality(z)
        config = RunningSumConfig(q_range_check, z, window_num_bits, field)

        def gate(cells):
            s = cells.query_selector(q_range_check)
            z_cur = cells.query_advice(z, Rotation.cur())
            z_next = cells.query_advice(z, Rotation.next())
            word = z_cur - z_next * (1 << window_num_bits)
            return [("range check", s * range_check(word, 1 << window_num_bits))]

        meta.create_gate("range check", gate)
        return config

    def witness_decompose(self, region: Region, offset: int, alpha: Value,
                          strict: bool, word_num_bits: int, num_windows: int):
        z_0 = region.assign_advice(self.z, offset, lambda: alpha)
        return self._decompose(region, offset, z_0, strict, word_num_bits, num_windows)

    def copy_decompose(self, region: Region, offset: int, alpha: AssignedCell,
                       strict: bool, word_num_bits: int, num_windows: int):
        z_0 = alpha.copy_advice(region, self.z, offset)
        return self._decompose(region, offset, z_0, strict, word_num_bits, num_windows)

    def _decompose(self, region: Region, offset: int, z_0: AssignedCell,
                   strict: bool, word_num_bits: int, num_windows: int):
        K = self.window_num_bits
        p = self.field.p
        assert K * num_windows < word_num_bits + K

        for idx in range(num_windows):
            self.q_range_check.enable(region, offset + idx)

        words = z_0.value.map(
            lambda w: decompose_word(int(w) % p, word_num_bits, K)
        )
        two_pow_k_inv = pow(1 << K, -1, p)

        zs = [z_0]
        z = z_0
        for i in range(num_windows):
            word_i = words.map(lambda ws, i=i: ws[i])
            z_next_val = z.value.zip(word_i).map(
                lambda t: (t[0] - t[1]) * two_pow_k_inv % p
            )
            z = region.assign_advice(self.z, offset + i + 1, lambda v=z_next_val: v)
            zs.append(z)

        if strict:
            region.constrain_constant(zs[-1].cell, 0)
        return zs


# ---------------------------------------------------------------------------
# LookupRangeCheckConfig (lookup_range_check.rs)
# ---------------------------------------------------------------------------


class LookupRangeCheckConfig:
    """Decompose into K-bit words via a 2^K lookup table."""

    def __init__(self, q_lookup, q_running, q_bitshift, running_sum, table_idx, k, field):
        self.q_lookup = q_lookup
        self.q_running = q_running
        self.q_bitshift = q_bitshift
        self.running_sum = running_sum
        self.table_idx = table_idx
        self.k = k
        self.field = field

    @staticmethod
    def configure(meta: ConstraintSystem, running_sum: Column,
                  table_idx: TableColumn, k: int, field) -> "LookupRangeCheckConfig":
        meta.enable_equality(running_sum)
        q_lookup = meta.complex_selector()
        q_running = meta.complex_selector()
        q_bitshift = meta.selector()
        config = LookupRangeCheckConfig(
            q_lookup, q_running, q_bitshift, running_sum, table_idx, k, field
        )

        def table_map(cells):
            ql = cells.query_selector(q_lookup)
            qr = cells.query_selector(q_running)
            z_cur = cells.query_advice(running_sum, Rotation.cur())
            z_next = cells.query_advice(running_sum, Rotation.next())
            running_word = qr * (z_cur - z_next * (1 << k))
            short_word = (Constant(1) - qr) * z_cur
            return [(ql * (running_word + short_word), table_idx)]

        meta.lookup("lookup", table_map)

        def bitshift_gate(cells):
            s = cells.query_selector(q_bitshift)
            word = cells.query_advice(running_sum, Rotation.prev())
            shifted = cells.query_advice(running_sum, Rotation.cur())
            inv_two_pow_s = cells.query_advice(running_sum, Rotation.next())
            return [("shifted_word", s * (word * (1 << k) * inv_two_pow_s - shifted))]

        meta.create_gate("Short lookup bitshift", bitshift_gate)
        return config

    def load(self, layouter: Layouter):
        """Load [0, 2^K) into the table column."""

        def do(table):
            for index in range(1 << self.k):
                table.assign_cell(self.table_idx, index, lambda i=index: Value.known(i))

        layouter.get_root().assign_table("table_idx", do)

    def copy_check(self, layouter: Layouter, element: AssignedCell,
                   num_words: int, strict: bool):
        def do(region: Region):
            z_0 = element.copy_advice(region, self.running_sum, 0)
            return self._range_check(region, z_0, num_words, strict)

        return layouter.namespace("copy check").assign_region(
            f"{num_words} words range check", do
        )

    def witness_check(self, layouter: Layouter, value: Value,
                      num_words: int, strict: bool):
        def do(region: Region):
            z_0 = region.assign_advice(self.running_sum, 0, lambda: value)
            return self._range_check(region, z_0, num_words, strict)

        return layouter.namespace("witness check").assign_region("Witness element", do)

    def _range_check(self, region: Region, element: AssignedCell,
                     num_words: int, strict: bool):
        K = self.k
        p = self.field.p
        num_bits = num_words * K
        assert num_bits < p.bit_length()

        words = element.value.map(
            lambda v: [
                bitrange_subset(int(v) % p, i * K, (i + 1) * K) for i in range(num_words)
            ]
        )
        inv_two_pow_k = pow(1 << K, -1, p)

        zs = [element]
        z = element
        for idx in range(num_words):
            self.q_lookup.enable(region, idx)
            self.q_running.enable(region, idx)
            word_i = words.map(lambda ws, idx=idx: ws[idx])
            z_val = z.value.zip(word_i).map(lambda t: (t[0] - t[1]) * inv_two_pow_k % p)
            z = region.assign_advice(self.running_sum, idx + 1, lambda v=z_val: v)
            zs.append(z)

        if strict:
            region.constrain_constant(zs[-1].cell, 0)
        return zs

    def witness_short_check(self, layouter: Layouter, value: Value, num_bits: int) -> AssignedCell:
        """Witness a fresh cell and range-check it to num_bits < K bits
        (lookup_range_check.rs witness_short_check)."""
        assert num_bits < self.k
        p = self.field.p

        def do(region: Region):
            el = region.assign_advice(self.running_sum, 0, lambda: value)
            self.q_lookup.enable(region, 0)
            shift = 1 << (self.k - num_bits)
            shifted_val = el.value.map(lambda v: int(v) * shift % p)
            region.assign_advice(self.running_sum, 1, lambda: shifted_val)
            self.q_lookup.enable(region, 1)
            self.q_bitshift.enable(region, 1)
            # 2^{-num_bits} must be FIXED, not free advice: the reference uses
            # assign_advice_from_constant (lookup_range_check.rs
            # short_range_check) so a malicious prover cannot witness an
            # arbitrary multiplier and defeat the num_bits bound.
            inv_two_pow_s = pow(1 << num_bits, -1, p)
            region.assign_advice_from_constant(self.running_sum, 2, inv_two_pow_s)
            return el

        return layouter.namespace("short range check").assign_region(
            f"Witness short check {num_bits} bits", do
        )

    def copy_short_check(self, layouter: Layouter, element: AssignedCell, num_bits: int):
        """Range-check an existing cell to num_bits < K bits via a shift."""
        assert num_bits < self.k
        p = self.field.p

        def do(region: Region):
            el = element.copy_advice(region, self.running_sum, 0)
            self.q_lookup.enable(region, 0)
            # shifted = element * 2^{K - num_bits}
            shift = 1 << (self.k - num_bits)
            shifted_val = el.value.map(lambda v: int(v) * shift % p)
            region.assign_advice(self.running_sum, 1, lambda: shifted_val)
            self.q_lookup.enable(region, 1)
            self.q_bitshift.enable(region, 1)
            # fixed constant, not free advice (see witness_short_check)
            inv_two_pow_s = pow(1 << num_bits, -1, p)
            region.assign_advice_from_constant(self.running_sum, 2, inv_two_pow_s)

        layouter.namespace("short range check").assign_region(
            f"Range check {num_bits} bits", do
        )
