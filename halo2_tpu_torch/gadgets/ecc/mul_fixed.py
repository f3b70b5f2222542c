"""Windowed fixed-base scalar multiplication for the ECC chip.

Rebuild of halo2_gadgets/src/ecc/chip/{constants.rs, mul_fixed.rs,
mul_fixed/full_width.rs, mul_fixed/short.rs, mul_fixed/base_field_elem.rs}.

The scalar is split into 85 (full-width; 22 for short) 3-bit windows.  For a
fixed base B, the multiples ``[(k + 2) * 8^w]B`` for k in [0, 8) are
precomputed per window; in-circuit each window row checks

  - x_p equals the degree-7 Lagrange interpolation (in the witnessed window
    value k) of the window's precomputed x-coordinates (8 fixed columns of
    interpolation coefficients),
  - the witnessed ``u`` satisfies ``u^2 = y_p + z_w`` where the per-window
    fixed ``z_w`` is chosen so that ``z_w - y`` is a non-square for every y
    in the window — pinning the sign of y_p,
  - (x_p, y_p) is on the curve,

and the +2 offsets are cancelled in the final window (whose table is
``[k * 8^84 - sum_j 2^{3j+1}]B``).  Window points are folded with incomplete
adds and a final complete add, exactly as the reference does.

Host-side constants (window tables, Lagrange coefficients, z/u values) are
computed on demand per base and cached — the reference precomputes them as
Rust constants for the Orchard bases; generation here is the same algorithm
(constants.rs:40-173).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import List, Optional, Tuple

from ...circuit.layouter import Layouter, Region
from ...circuit.value import Value
from ...curves import host
from ...curves.spec import PALLAS
from ...plonk.circuit import Column, Constant, ConstraintSystem, Selector
from ...poly.polynomial import Rotation
from ..utilities import RunningSumConfig, decompose_word, range_check
from .chip import EccChip, EccConfig, EccPoint

FIXED_BASE_WINDOW_SIZE = 3
H = 1 << FIXED_BASE_WINDOW_SIZE  # 8
# ceil(255 / 3) windows for a full-width pallas scalar (constants.rs:18-20)
NUM_WINDOWS = (255 + FIXED_BASE_WINDOW_SIZE - 1) // FIXED_BASE_WINDOW_SIZE
# ceil(64 / 3) windows for a short signed 64-bit scalar (constants.rs:22-24)
NUM_WINDOWS_SHORT = (64 + FIXED_BASE_WINDOW_SIZE - 1) // FIXED_BASE_WINDOW_SIZE

FP = PALLAS.base.p
FQ = PALLAS.scalar.p
# t_p = p - 2^254 (base_field_elem.rs T_P; t_p < 2^130)
T_P = FP - (1 << 254)


# ---------------------------------------------------------------------------
# Host-side constants generation (constants.rs)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def compute_window_table(base: Tuple[int, int], num_windows: int):
    """[(k+2)*8^w]B tables; last window [k*8^w - sum]B (constants.rs:40-81).

    Kept per (base, num_windows) for the process: the Lagrange coefficients
    and the z/u search read the same table, and each of its 8 * num_windows
    points is a host scalar mul.  Callers do not modify it."""
    table = []
    for w in range(num_windows - 1):
        table.append(
            [host.mul(PALLAS, base, (k + 2) * pow(H, w, FQ) % FQ) for k in range(H)]
        )
    sum_ = sum(1 << (FIXED_BASE_WINDOW_SIZE * j + 1) for j in range(num_windows - 1))
    w = num_windows - 1
    table.append(
        [
            host.mul(PALLAS, base, (k * pow(H, w, FQ) - sum_) % FQ)
            for k in range(H)
        ]
    )
    return table


def lagrange_interpolate(xs: List[int], ys: List[int], p: int) -> List[int]:
    """Coefficients (low-to-high) of the interpolation polynomial over Fp."""
    n = len(xs)
    coeffs = [0] * n
    for i in range(n):
        # basis polynomial l_i(X) = prod_{j != i} (X - x_j) / (x_i - x_j)
        denom = 1
        basis = [1]  # poly coeffs
        for j in range(n):
            if j == i:
                continue
            denom = denom * (xs[i] - xs[j]) % p
            new = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                new[d] = (new[d] - c * xs[j]) % p
                new[d + 1] = (new[d + 1] + c) % p
            basis = new
        scale = ys[i] * pow(denom, -1, p) % p
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % p
    return coeffs


def compute_lagrange_coeffs(base: Tuple[int, int], num_windows: int):
    """Per-window interpolation of x-coords over k in [0, 8) (constants.rs:86-111)."""
    xs = list(range(H))
    return [
        lagrange_interpolate(xs, [pt[0] for pt in window], FP)
        for window in compute_window_table(base, num_windows)
    ]


def find_zs_and_us(base: Tuple[int, int], num_windows: int):
    """Per window: z with z+y square (u^2) and z-y non-square for all 8 y's
    (constants.rs:117-143)."""
    exp = (FP - 1) // 2  # Legendre exponent

    def is_square(v: int) -> bool:
        v %= FP
        return v == 0 or pow(v, exp, FP) == 1

    out = []
    for window in compute_window_table(base, num_windows):
        ys = [pt[1] for pt in window]
        found = None
        for z in range(1000 * (1 << (2 * H))):
            # cheap Legendre screen first; Tonelli sqrts only on full success
            if any(is_square(z - y) or not is_square(z + y) for y in ys):
                continue
            found = (z, [PALLAS.base.sqrt((z + y) % FP) for y in ys])
            break
        assert found is not None, "no z found (astronomically unlikely)"
        out.append(found)
    return out


_ZS_US_CACHE_PATH = os.path.join(os.path.dirname(__file__), "fixed_base_zs_us.json")
# z/u values found in this process for bases missing from the file above
_ZS_US_FOUND: dict = {}


@functools.lru_cache(maxsize=None)
def _load_zs_us_cache() -> dict:
    if os.path.exists(_ZS_US_CACHE_PATH):
        with open(_ZS_US_CACHE_PATH) as f:
            return json.load(f)
    return {}


class FixedPointParams:
    """Cached per-base constants for windowed fixed-base mul.

    The z/u search costs ~2^16 Legendre tests per window (the reference ran
    the same search offline and committed the results as Rust constants for
    the Orchard bases, constants.rs:113-117).  ``fixed_base_zs_us.json`` next
    to this module carries the values of the bases the repo uses; a base
    missing there is searched once per process and kept in memory only, so
    the package never writes into its own tree.
    """

    def __init__(self, base: Tuple[int, int], num_windows: int = NUM_WINDOWS):
        self.base = base
        self.num_windows = num_windows

    @functools.cached_property
    def window_table(self):
        return compute_window_table(self.base, self.num_windows)

    @functools.cached_property
    def lagrange_coeffs(self):
        return compute_lagrange_coeffs(self.base, self.num_windows)

    @functools.cached_property
    def zs_and_us(self):
        key = f"{self.base[0]:064x}:{self.base[1]:064x}:{self.num_windows}"
        cache = _load_zs_us_cache()
        if key in cache:
            return [(z, [int(u, 16) for u in us]) for z, us in cache[key]]
        if key not in _ZS_US_FOUND:
            _ZS_US_FOUND[key] = find_zs_and_us(self.base, self.num_windows)
        return _ZS_US_FOUND[key]


# ---------------------------------------------------------------------------
# Config + gates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MulFixedConfig:
    ecc: EccConfig
    lagrange_coeffs: List[Column]  # 8 fixed columns
    fixed_z: Column  # fixed
    window: Column  # advice
    u: Column  # advice
    q_mul_fixed_full: Selector
    q_mul_fixed_short: Selector
    running_sum_config: RunningSumConfig
    # base-field-element variant (base_field_elem.rs); None when not configured
    q_mul_fixed_base_field: Optional[Selector] = None
    canon_advices: Optional[List[Column]] = None
    lookup_config: Optional[object] = None  # LookupRangeCheckConfig


def _coords_check(cells, config: MulFixedConfig, window_expr):
    """x interpolation + u^2 = y + z + on-curve (mul_fixed.rs:132-171)."""
    y_p = cells.query_advice(config.ecc.y_p, Rotation.cur())
    x_p = cells.query_advice(config.ecc.x_p, Rotation.cur())
    z = cells.query_fixed(config.fixed_z, Rotation.cur())
    u = cells.query_advice(config.u, Rotation.cur())

    interpolated_x = Constant(0)
    window_pow = Constant(1)
    for coeff in config.lagrange_coeffs:
        interpolated_x = interpolated_x + window_pow * cells.query_fixed(coeff, Rotation.cur())
        window_pow = window_pow * window_expr

    x_check = interpolated_x - x_p
    y_check = u.square() - y_p - z
    on_curve = y_p.square() - x_p.square() * x_p - Constant(PALLAS.b)
    return [("check x", x_check), ("check y", y_check), ("on-curve", on_curve)]


class MulFixedChip:
    """Windowed fixed-base mul helpers sharing the EccChip add gates."""

    def __init__(self, config: MulFixedConfig):
        self.config = config
        self.ecc = EccChip(config.ecc)

    @classmethod
    def configure(
        cls, meta: ConstraintSystem, ecc_config: EccConfig, window: Column, u: Column
    ) -> MulFixedConfig:
        meta.enable_equality(window)
        meta.enable_equality(u)
        lagrange_coeffs = [meta.fixed_column() for _ in range(H)]
        fixed_z = meta.fixed_column()

        q_running = meta.selector()
        running_sum_config = RunningSumConfig.configure(
            meta, q_running, window, FIXED_BASE_WINDOW_SIZE, PALLAS.base
        )

        config = MulFixedConfig(
            ecc=ecc_config,
            lagrange_coeffs=lagrange_coeffs,
            fixed_z=fixed_z,
            window=window,
            u=u,
            q_mul_fixed_full=meta.selector(),
            q_mul_fixed_short=meta.selector(),
            running_sum_config=running_sum_config,
        )

        # full-width: witnessed 3-bit windows (full_width.rs:34-51)
        def full_gate(cells):
            q = cells.query_selector(config.q_mul_fixed_full)
            window_e = cells.query_advice(config.window, Rotation.cur())
            items = [(n, q * e) for n, e in _coords_check(cells, config, window_e)]
            items.append(("window range check", q * range_check(window_e, H)))
            return items

        meta.create_gate("Full-width fixed-base scalar mul", full_gate)

        # running-sum variant: word from the z chain (mul_fixed.rs:113-130);
        # the word's 3-bit range is enforced by RunningSumConfig's own gate.
        def running_gate(cells):
            q = cells.query_selector(q_running)
            z_cur = cells.query_advice(config.window, Rotation.cur())
            z_next = cells.query_advice(config.window, Rotation.next())
            word = z_cur - z_next * H
            return [(n, q * e) for n, e in _coords_check(cells, config, word)]

        meta.create_gate("Running sum coordinates check", running_gate)

        # short signed gate (short.rs:35-80): sign in {-1, 1}, y negation,
        # last magnitude window boolean
        def short_gate(cells):
            q = cells.query_selector(config.q_mul_fixed_short)
            y_p = cells.query_advice(config.ecc.y_p, Rotation.cur())
            y_a = cells.query_advice(config.ecc.y_qr, Rotation.cur())
            last_window = cells.query_advice(config.u, Rotation.cur())
            sign = cells.query_advice(config.window, Rotation.cur())
            one = Constant(1)
            return [
                ("last_window_check", q * (last_window * (last_window - one))),
                ("sign_check", q * (sign.square() - one)),
                ("y_check", q * ((y_p - y_a) * (y_p + y_a))),
                ("negation_check", q * (sign * y_p - y_a)),
            ]

        meta.create_gate("Short fixed-base mul gate", short_gate)
        return config

    @classmethod
    def configure_base_field(
        cls,
        meta: ConstraintSystem,
        config: MulFixedConfig,
        canon_advices: List[Column],
        lookup_config,
    ) -> MulFixedConfig:
        """Add the base-field-element canonicity gate (base_field_elem.rs:59-160).

        ``canon_advices``: 3 equality-enabled advice columns distinct from the
        ECC chip's x_p/y_p/x_qr/y_qr.
        """
        assert len(canon_advices) == 3
        for advice in canon_advices:
            meta.enable_equality(advice)
        config.q_mul_fixed_base_field = meta.selector()
        config.canon_advices = list(canon_advices)
        config.lookup_config = lookup_config
        c0, c1, c2 = canon_advices

        def canon_gate(cells):
            q = cells.query_selector(config.q_mul_fixed_base_field)
            alpha = cells.query_advice(c0, Rotation.prev())
            z_84_alpha = cells.query_advice(c2, Rotation.prev())
            # alpha = alpha_0 (252 bits) || alpha_1 (2 bits) || alpha_2 (1 bit)
            alpha_0 = alpha - z_84_alpha * (1 << 252)
            alpha_1 = cells.query_advice(c1, Rotation.cur())
            alpha_2 = cells.query_advice(c2, Rotation.cur())
            alpha_0_prime = cells.query_advice(c0, Rotation.cur())
            z_13_alpha_0_prime = cells.query_advice(c0, Rotation.next())
            z_44_alpha = cells.query_advice(c1, Rotation.next())
            z_43_alpha = cells.query_advice(c2, Rotation.next())

            one = Constant(1)
            # decomposition checks
            alpha_1_range = alpha_1 * (alpha_1 - one) * (alpha_1 - 2) * (alpha_1 - 3)
            alpha_2_bool = alpha_2 * (alpha_2 - one)
            z_84_check = z_84_alpha - (alpha_1 + alpha_2 * 4)
            # alpha_0_prime = alpha_0 + 2^130 - t_p
            alpha_0_prime_check = alpha_0_prime - (alpha_0 + Constant((1 << 130) - T_P))
            # canonicity when the MSB is set
            alpha_0_hi_120 = z_44_alpha - z_84_alpha * (1 << 120)
            a_43 = z_43_alpha - z_44_alpha * H
            return [
                ("MSB = 1 => alpha_1 = 0", q * (alpha_2 * alpha_1)),
                ("MSB = 1 => alpha_0_hi_120 = 0", q * (alpha_2 * alpha_0_hi_120)),
                ("MSB = 1 => a_43 = 0 or 1", q * (alpha_2 * (a_43 * (a_43 - one)))),
                ("MSB = 1 => z_13_alpha_0_prime = 0", q * (alpha_2 * z_13_alpha_0_prime)),
                ("alpha_1_range_check", q * alpha_1_range),
                ("alpha_2_range_check", q * alpha_2_bool),
                ("z_84_alpha_check", q * z_84_check),
                ("alpha_0_prime check", q * alpha_0_prime_check),
            ]

        meta.create_gate("Canonicity checks", canon_gate)
        return config

    # -- shared window-row assignment ---------------------------------------

    def _assign_windows(
        self,
        layouter: Layouter,
        params: FixedPointParams,
        windows_v: List[Value],
        enable_full: bool,
        running_zs=None,
    ) -> List[EccPoint]:
        """Assign per-window fixed constants, window values, mul_b points and
        u values in one region; return the mul_b points (mul_fixed.rs:199-330)."""
        config = self.config
        num_windows = params.num_windows
        table = params.window_table
        zs_us = params.zs_and_us
        coeffs = params.lagrange_coeffs

        def do(region: Region):
            mul_bs = []
            for w in range(num_windows):
                if enable_full:
                    config.q_mul_fixed_full.enable(region, w)
                else:
                    config.running_sum_config.q_range_check.enable(region, w)
                for k in range(H):
                    region.assign_fixed(
                        config.lagrange_coeffs[k], w, lambda v=coeffs[w][k]: Value.known(v)
                    )
                region.assign_fixed(
                    config.fixed_z, w, lambda v=zs_us[w][0]: Value.known(v)
                )
                if enable_full:
                    region.assign_advice(config.window, w, lambda v=windows_v[w]: v)
                else:
                    # running-sum z values occupy the window column
                    running_zs[w].copy_advice(region, config.window, w)

                mul_b_v = windows_v[w].map(lambda k, w=w: table[w][k])
                x = region.assign_advice(
                    config.ecc.x_p, w, lambda v=mul_b_v: v.map(lambda pt: pt[0])
                )
                y = region.assign_advice(
                    config.ecc.y_p, w, lambda v=mul_b_v: v.map(lambda pt: pt[1])
                )
                u_v = windows_v[w].map(lambda k, w=w: zs_us[w][1][k])
                region.assign_advice(config.u, w, lambda v=u_v: v)
                mul_bs.append(EccPoint(x, y))
            if not enable_full:
                # final z must be copied to the row after the last window so
                # the running-sum gate's z_next query is satisfied
                running_zs[num_windows].copy_advice(region, config.window, num_windows)
            return mul_bs

        return layouter.namespace("mul_fixed windows").assign_region("mul_fixed windows", do)

    def _fold_windows(self, layouter: Layouter, mul_bs: List[EccPoint]) -> EccPoint:
        """Incomplete adds for all but the last window, then a complete add."""
        acc = mul_bs[0]
        for mul_b in mul_bs[1:-1]:
            acc = self.ecc.add_incomplete(layouter, mul_b, acc)
        return self.ecc.add(layouter, mul_bs[-1], acc)

    # -- full-width (full_width.rs) -----------------------------------------

    def mul_full_width(
        self, layouter: Layouter, scalar: Value, base: Tuple[int, int]
    ) -> EccPoint:
        """[scalar]B for a full-width (possibly non-canonical) scalar."""
        params = FixedPointParams(base, NUM_WINDOWS)
        windows_all = scalar.map(
            lambda v: decompose_word(v % FQ, 255, FIXED_BASE_WINDOW_SIZE)
        )
        windows_v = [windows_all.map(lambda ws, i=w: ws[i]) for w in range(NUM_WINDOWS)]
        mul_bs = self._assign_windows(layouter, params, windows_v, enable_full=True)
        return self._fold_windows(layouter, mul_bs)

    # -- short signed (short.rs) --------------------------------------------

    def mul_short(
        self, layouter: Layouter, magnitude_sign: Value, base: Tuple[int, int]
    ) -> EccPoint:
        """[±magnitude]B with magnitude < 2^64 and sign in {1, -1}."""
        params = FixedPointParams(base, NUM_WINDOWS_SHORT)
        config = self.config

        magnitude_v = magnitude_sign.map(lambda t: t[0])
        sign_v = magnitude_sign.map(lambda t: 1 if t[1] == 1 else FP - 1)

        # running-sum decomposition of the magnitude in its own region
        def decomp(region: Region):
            z0 = region.assign_advice(config.window, 0, lambda: magnitude_v)
            zs = [z0]
            z = magnitude_v
            for i in range(NUM_WINDOWS_SHORT):
                word = z.map(lambda v, i=i: (v >> (3 * i)) & 7)
                z_next = zs[-1].value.zip(word).map(
                    lambda t: (t[0] - t[1]) * pow(H, -1, FP) % FP
                )
                zs.append(region.assign_advice(config.window, i + 1, lambda v=z_next: v))
            region.constrain_constant(zs[-1].cell, 0)
            return zs

        running_zs = layouter.namespace("short decompose").assign_region(
            "short magnitude decomposition", decomp
        )

        windows_v = [
            magnitude_v.map(lambda v, w=w: (v >> (3 * w)) & 7)
            for w in range(NUM_WINDOWS_SHORT)
        ]
        mul_bs = self._assign_windows(
            layouter, params, windows_v, enable_full=False, running_zs=running_zs
        )
        magnitude_result = self._fold_windows(layouter, mul_bs)

        return self._finish_short(layouter, magnitude_result, sign_v, running_zs)

    def _finish_short(self, layouter, magnitude_result, sign_v, running_zs):
        config = self.config

        # conditional negation (short.rs:35-80 + assign:150-240)
        def negate(region: Region):
            config.q_mul_fixed_short.enable(region, 0)
            magnitude_result.y.copy_advice(region, config.ecc.y_qr, 0)
            signed_y_v = magnitude_result.y.value.zip(sign_v).map(
                lambda t: t[0] if t[1] == 1 else (FP - t[0]) % FP
            )
            y_cell = region.assign_advice(config.ecc.y_p, 0, lambda: signed_y_v)
            region.assign_advice(config.window, 0, lambda: sign_v)
            # last magnitude window: COPY the running-sum cell z_21 (equal to
            # k_21 since z_22 = 0) so the last_window_check gate constrains a
            # bound cell — a fresh witness here would let magnitudes in
            # [2^64, 2^66) pass the "short" check (reference short.rs:173-176
            # copies z_21 into u).
            running_zs[NUM_WINDOWS_SHORT - 1].copy_advice(region, config.u, 0)
            return EccPoint(magnitude_result.x, y_cell)

        return layouter.namespace("short negate").assign_region(
            "short conditional negation", negate
        )

    # -- base field element (base_field_elem.rs) ----------------------------

    def mul_base_field(self, layouter: Layouter, scalar_cell, base: Tuple[int, int]) -> EccPoint:
        """[alpha]B where alpha is an existing base-field cell, with full
        canonicity enforcement (0 <= alpha < p) via the three-piece
        decomposition and conditional t_p checks (base_field_elem.rs:162-330).
        """
        config = self.config
        assert config.q_mul_fixed_base_field is not None, "configure_base_field first"
        params = FixedPointParams(base, NUM_WINDOWS)

        alpha_v = scalar_cell.value.map(_ev_int)

        # running-sum decomposition of alpha (z_0 = alpha, strict z_85 = 0)
        def decomp(region: Region):
            z0 = scalar_cell.copy_advice(region, config.window, 0)
            zs = [z0]
            for i in range(NUM_WINDOWS):
                z_next = alpha_v.map(lambda v, i=i: _shift_windows(v, i + 1))
                zs.append(region.assign_advice(config.window, i + 1, lambda v=z_next: v))
            region.constrain_constant(zs[-1].cell, 0)
            return zs

        running_zs = layouter.namespace("base-field decompose").assign_region(
            "base-field elem decomposition", decomp
        )

        windows_v = [
            alpha_v.map(lambda v, w=w: (v >> (3 * w)) & 7) for w in range(NUM_WINDOWS)
        ]
        mul_bs = self._assign_windows(
            layouter, params, windows_v, enable_full=False, running_zs=running_zs
        )
        result = self._fold_windows(layouter, mul_bs)

        self.canonicity_check(
            layouter, scalar_cell, running_zs[43], running_zs[44], running_zs[84]
        )
        return result

    def canonicity_check(self, layouter: Layouter, scalar_cell, z_43, z_44, z_84):
        """Enforce 0 <= alpha < p for a base-field cell, given running-sum
        cells z_43 = alpha >> 129, z_44 = alpha >> 132, z_84 = alpha >> 252
        (base_field_elem.rs:240-330).  Also used by the variable-base mul's
        overflow handling (mul/overflow.rs semantics) with the equivalent
        intermediate values from its bit chain.
        """
        config = self.config
        alpha_v = scalar_cell.value.map(_ev_int)

        # canonicity: alpha = alpha_0 (252b) || alpha_1 (2b) || alpha_2 (1b)
        alpha_0_prime_v = alpha_v.map(
            lambda v: ((v & ((1 << 252) - 1)) + (1 << 130) - T_P) % FP
        )
        zs_prime = config.lookup_config.witness_check(
            layouter.namespace("alpha_0_prime range check"),
            alpha_0_prime_v,
            13,
            strict=False,
        )
        alpha_0_prime = zs_prime[0]
        z_13_alpha_0_prime = zs_prime[13]

        c0, c1, c2 = config.canon_advices

        def canon(region: Region):
            config.q_mul_fixed_base_field.enable(region, 1)
            # offset 0: alpha, z_84
            scalar_cell.copy_advice(region, c0, 0)
            z_84.copy_advice(region, c2, 0)
            # offset 1: alpha_0_prime, alpha_1, alpha_2
            alpha_0_prime.copy_advice(region, c0, 1)
            alpha_1_v = alpha_v.map(lambda v: (v >> 252) & 3)
            region.assign_advice(c1, 1, lambda: alpha_1_v)
            alpha_2_v = alpha_v.map(lambda v: (v >> 254) & 1)
            region.assign_advice(c2, 1, lambda: alpha_2_v)
            # offset 2: z_13_alpha_0_prime, z_44, z_43
            z_13_alpha_0_prime.copy_advice(region, c0, 2)
            z_44.copy_advice(region, c1, 2)
            z_43.copy_advice(region, c2, 2)

        layouter.namespace("canonicity").assign_region("Canonicity checks", canon)


def _ev_int(v) -> int:
    from ...circuit.value import Assigned

    if isinstance(v, Assigned):
        if v.denominator == 1:
            return v.numerator % FP
        return v.numerator * pow(v.denominator, -1, FP) % FP
    return v % FP


def _shift_windows(v: int, k: int) -> int:
    """z_k of the 3-bit running sum of v (v >> 3k)."""
    return v >> (3 * k)
