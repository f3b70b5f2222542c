"""Pow5Chip: Poseidon permutation circuit with the x^5 S-box.

Rebuild of halo2_gadgets/src/poseidon/pow5.rs (SURVEY.md §2.32): one row per
full round, two rounds per row for partial rounds, a pad-and-add region per
sponge input.  Gate layout, selector usage and witness placement mirror the
reference so circuits have identical shape/degree.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ...circuit.layouter import AssignedCell, Layouter, Region
from ...circuit.value import Assigned, Value
from ...plonk.circuit import Column, ConstraintSystem, Selector
from ...poly.polynomial import Rotation
from .primitives import ConstantLength, PoseidonSpec, full_round, mds_mul, partial_round, pow5


@dataclasses.dataclass
class Pow5Config:
    state: List[Column]
    partial_sbox: Column
    rc_a: List[Column]
    rc_b: List[Column]
    s_full: Selector
    s_partial: Selector
    s_pad_and_add: Selector
    half_full_rounds: int
    half_partial_rounds: int
    spec: PoseidonSpec
    round_constants: List[List[int]]
    m_reg: list
    m_inv: list


class Pow5Chip:
    def __init__(self, config: Pow5Config):
        self.config = config

    @staticmethod
    def configure(
        meta: ConstraintSystem,
        spec: PoseidonSpec,
        state: List[Column],
        partial_sbox: Column,
        rc_a: List[Column],
        rc_b: List[Column],
    ) -> Pow5Config:
        width = spec.t
        rate = spec.rate
        assert rate == width - 1
        assert spec.full_rounds % 2 == 0 and spec.partial_rounds % 2 == 0
        half_full_rounds = spec.full_rounds // 2
        half_partial_rounds = spec.partial_rounds // 2
        round_constants, m_reg, m_inv = spec.constants()

        for column in list(state) + list(rc_b):
            meta.enable_equality(column)

        s_full = meta.selector()
        s_partial = meta.selector()
        s_pad_and_add = meta.selector()

        def pow_5(v):
            v2 = v * v
            return v2 * v2 * v

        def full_round_gate(cells):
            s = cells.query_selector(s_full)
            constraints = []
            cur = [cells.query_advice(state[i], Rotation.cur()) for i in range(width)]
            rca = [cells.query_fixed(rc_a[i], Rotation.cur()) for i in range(width)]
            nxt = [cells.query_advice(state[i], Rotation.next()) for i in range(width)]
            for next_idx in range(width):
                expr = None
                for idx in range(width):
                    term = pow_5(cur[idx] + rca[idx]) * m_reg[next_idx][idx]
                    expr = term if expr is None else expr + term
                constraints.append(("state", s * (expr - nxt[next_idx])))
            return constraints

        meta.create_gate("full round", full_round_gate)

        def partial_rounds(cells):
            s = cells.query_selector(s_partial)
            cur = [cells.query_advice(state[i], Rotation.cur()) for i in range(width)]
            nxt = [cells.query_advice(state[i], Rotation.next()) for i in range(width)]
            rca = [cells.query_fixed(rc_a[i], Rotation.cur()) for i in range(width)]
            rcb = [cells.query_fixed(rc_b[i], Rotation.cur()) for i in range(width)]
            mid_0 = cells.query_advice(partial_sbox, Rotation.cur())

            def mid(idx):
                acc = mid_0 * m_reg[idx][0]
                for cur_idx in range(1, width):
                    acc = acc + (cur[cur_idx] + rca[cur_idx]) * m_reg[idx][cur_idx]
                return acc

            def nxt_lin(idx):
                acc = None
                for next_idx in range(width):
                    term = nxt[next_idx] * m_inv[idx][next_idx]
                    acc = term if acc is None else acc + term
                return acc

            constraints = [
                ("a", s * (pow_5(cur[0] + rca[0]) - mid_0)),
                ("b", s * (pow_5(mid(0) + rcb[0]) - nxt_lin(0))),
            ]
            for idx in range(1, width):
                constraints.append(
                    ("lin", s * (mid(idx) + rcb[idx] - nxt_lin(idx)))
                )
            return constraints

        meta.create_gate("partial rounds", partial_rounds)

        def pad_and_add(cells):
            s = cells.query_selector(s_pad_and_add)
            constraints = []
            for idx in range(rate):
                initial = cells.query_advice(state[idx], Rotation.prev())
                inp = cells.query_advice(state[idx], Rotation.cur())
                output = cells.query_advice(state[idx], Rotation.next())
                constraints.append(("pad-and-add", s * (initial + inp - output)))
            initial_rate = cells.query_advice(state[rate], Rotation.prev())
            output_rate = cells.query_advice(state[rate], Rotation.next())
            constraints.append(("capacity", s * (initial_rate - output_rate)))
            return constraints

        meta.create_gate("pad-and-add", pad_and_add)

        return Pow5Config(
            state=list(state),
            partial_sbox=partial_sbox,
            rc_a=list(rc_a),
            rc_b=list(rc_b),
            s_full=s_full,
            s_partial=s_partial,
            s_pad_and_add=s_pad_and_add,
            half_full_rounds=half_full_rounds,
            half_partial_rounds=half_partial_rounds,
            spec=spec,
            round_constants=round_constants,
            m_reg=m_reg,
            m_inv=m_inv,
        )

    # -- PoseidonInstructions -------------------------------------------------

    def permute(self, layouter: Layouter, initial_state: List[AssignedCell]):
        config = self.config

        def do(region: Region):
            state = _load(region, config, initial_state)
            for r in range(config.half_full_rounds):
                state = _full_round(region, config, state, r, r)
            for r in range(config.half_partial_rounds):
                state = _partial_round(
                    region,
                    config,
                    state,
                    config.half_full_rounds + 2 * r,
                    config.half_full_rounds + r,
                )
            for r in range(config.half_full_rounds):
                state = _full_round(
                    region,
                    config,
                    state,
                    config.half_full_rounds + 2 * config.half_partial_rounds + r,
                    config.half_full_rounds + config.half_partial_rounds + r,
                )
            return state

        return layouter.namespace("permute state").assign_region("permute state", do)

    # -- PoseidonSpongeInstructions --------------------------------------------

    def initial_state(self, layouter: Layouter, domain: ConstantLength):
        config = self.config
        rate = config.spec.rate

        def do(region: Region):
            state = []
            for i in range(rate):
                state.append(region.assign_advice_from_constant(config.state[i], 0, 0))
            state.append(
                region.assign_advice_from_constant(
                    config.state[rate], 0, domain.initial_capacity_element()
                )
            )
            return state

        return layouter.namespace("initial state").assign_region(
            f"initial state for domain {domain.name()}", do
        )

    def add_input(self, layouter: Layouter, initial_state, input_words, domain):
        """input_words: list of RATE entries, each ('message', AssignedCell) or
        ('padding', int)."""
        config = self.config
        p = config.spec.field.p
        rate = config.spec.rate

        def do(region: Region):
            config.s_pad_and_add.enable(region, 1)

            loaded = [
                initial_state[i].copy_advice(region, config.state[i], 0)
                for i in range(config.spec.t)
            ]

            inputs = []
            for i in range(rate):
                kind, word = input_words[i]
                if kind == "message":
                    cell = word
                else:
                    cell = region.assign_fixed(config.rc_b[i], 1, lambda w=word: w)
                inputs.append(cell.copy_advice(region, config.state[i], 1))

            output = []
            for i in range(config.spec.t):
                if i < rate:
                    value = (loaded[i].value + inputs[i].value).map(lambda v: v % p if isinstance(v, int) else v)
                else:
                    value = loaded[i].value
                output.append(region.assign_advice(config.state[i], 2, lambda v=value: v))
            return output

        return layouter.namespace("add input").assign_region(
            f"add input for domain {domain.name()}", do
        )

    @staticmethod
    def get_output(state, rate: int):
        return list(state[:rate])


def _load(region: Region, config: Pow5Config, initial_state):
    return [
        initial_state[i].copy_advice(region, config.state[i], 0)
        for i in range(config.spec.t)
    ]


def _value_list(state, p):
    """The state's words as canonical ints, or None if any is unknown."""
    vals = []
    for w in state:
        v = w.value.value()
        if v is None:
            return None
        vals.append(v.evaluate(p) if v.__class__ is Assigned else v % p)
    return vals


def _round(region: Region, config: Pow5Config, round_idx, offset, selector, next_state):
    selector.enable(region, offset)
    for column, c in zip(config.rc_a, config.round_constants[round_idx]):
        region.assign_fixed(column, offset, c)
    if next_state is None:
        next_state = [None] * config.spec.t
    return [region.assign_advice(column, offset + 1, Value(v))
            for column, v in zip(config.state, next_state)]


def _full_round(region, config, state, round_idx, offset):
    p = config.spec.field.p
    vals = _value_list(state, p)
    nxt = None
    if vals is not None:
        nxt = full_round(p, config.m_reg, vals, config.round_constants[round_idx])
    return _round(region, config, round_idx, offset, config.s_full, nxt)


def _partial_round(region, config, state, round_idx, offset):
    """Two partial rounds in one row; the first round's S-box output is the
    ``partial_sbox`` cell."""
    p = config.spec.field.p
    vals = _value_list(state, p)
    mid = nxt = None
    if vals is not None:
        rcs = config.round_constants[round_idx]
        mid = pow5((vals[0] + rcs[0]) % p, p)
        p_mid = mds_mul(config.m_reg, [mid] + [v + c for v, c in zip(vals[1:], rcs[1:])], p)
        nxt = partial_round(p, config.m_reg, p_mid, config.round_constants[round_idx + 1])
    region.assign_advice(config.partial_sbox, offset, Value(mid))
    for column, c in zip(config.rc_b, config.round_constants[round_idx + 1]):
        region.assign_fixed(column, offset, c)
    return _round(region, config, round_idx, offset, config.s_partial, nxt)


# ---------------------------------------------------------------------------
# Sponge / Hash gadgets (poseidon.rs Sponge/Hash)
# ---------------------------------------------------------------------------


class PoseidonHashGadget:
    """Hash gadget over a Pow5Chip with a ConstantLength domain."""

    def __init__(self, chip: Pow5Chip, domain: ConstantLength):
        self.chip = chip
        self.domain = domain

    def hash(self, layouter: Layouter, message: List[AssignedCell]) -> AssignedCell:
        spec = self.chip.config.spec
        rate = spec.rate
        domain = self.domain
        assert len(message) == domain.length

        padded = [("message", w) for w in message] + [
            ("padding", v) for v in domain.padding(rate)
        ]
        state = self.chip.initial_state(layouter, domain)
        # absorb in rate-sized chunks
        for chunk_start in range(0, len(padded), rate):
            chunk = padded[chunk_start : chunk_start + rate]
            assert len(chunk) == rate, "padded input must be a multiple of rate"
            state = self.chip.add_input(layouter, state, chunk, domain)
            state = self.chip.permute(layouter, state)
        return self.chip.get_output(state, rate)[0]
