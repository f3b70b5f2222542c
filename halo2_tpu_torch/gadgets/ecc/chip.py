"""ECC chip: witness point, incomplete add, complete add (Pallas).

The identity is represented as (0, 0) in affine coordinates — sound because
x = 0 has no curve solutions for y^2 = x^3 + 5 over the Pallas base field.
Witness values are canonical ints; inv0(x) = 0 when x = 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ...circuit.layouter import AssignedCell, Layouter, Region
from ...circuit.value import Value
from ...plonk.circuit import Column, Constant, ConstraintSystem, Selector
from ...poly.polynomial import Rotation
from ...curves.spec import PALLAS


@dataclasses.dataclass
class EccPoint:
    """An affine point in advice cells; identity = (0, 0)."""

    x: AssignedCell
    y: AssignedCell

    def value(self):
        """Host affine tuple or None for identity (when witnessed)."""
        if self.x.value.is_none() or self.y.value.is_none():
            return Value.unknown()
        xv, yv = self.x.value.value(), self.y.value.value()
        return Value.known(None if (xv == 0 and yv == 0) else (xv, yv))


@dataclasses.dataclass
class EccConfig:
    # witness point
    q_point: Selector
    q_point_non_id: Selector
    # shared coordinate columns
    x_p: Column
    y_p: Column
    x_qr: Column
    y_qr: Column
    # complete-add auxiliaries
    q_add: Selector
    q_add_incomplete: Selector
    lam: Column
    alpha: Column
    beta: Column
    gamma: Column
    delta: Column
    # variable-base scalar mul step (bit select + running sum)
    q_mul_step: Selector = None


def _inv0(v: int, p: int) -> int:
    return 0 if v % p == 0 else pow(v, -1, p)


class EccChip:
    curve = PALLAS

    def __init__(self, config: EccConfig):
        self.config = config

    @classmethod
    def configure(cls, meta: ConstraintSystem, advices) -> EccConfig:
        """advices: >= 9 advice columns."""
        b = cls.curve.b
        x_p, y_p, x_qr, y_qr, lam, alpha, beta, gamma, delta = advices[:9]
        for col in (x_p, y_p, x_qr, y_qr, alpha):
            meta.enable_equality(col)

        config = EccConfig(
            q_point=meta.selector(),
            q_point_non_id=meta.selector(),
            x_p=x_p,
            y_p=y_p,
            x_qr=x_qr,
            y_qr=y_qr,
            q_add=meta.selector(),
            q_add_incomplete=meta.selector(),
            lam=lam,
            alpha=alpha,
            beta=beta,
            gamma=gamma,
            delta=delta,
        )

        def curve_eqn(cells):
            x = cells.query_advice(x_p, Rotation.cur())
            y = cells.query_advice(y_p, Rotation.cur())
            return y * y - (x * x * x) - Constant(b)

        def witness_point(cells):
            q = cells.query_selector(config.q_point)
            x = cells.query_advice(x_p, Rotation.cur())
            y = cells.query_advice(y_p, Rotation.cur())
            eqn = curve_eqn(cells)
            # identity maps to (0, 0); else on-curve (witness_point.rs:58-78)
            return [
                ("x == 0 v on_curve", q * x * eqn),
                ("y == 0 v on_curve", q * y * eqn),
            ]

        meta.create_gate("witness point", witness_point)

        def witness_non_id(cells):
            q = cells.query_selector(config.q_point_non_id)
            return [("on_curve", q * curve_eqn(cells))]

        meta.create_gate("witness non-identity point", witness_non_id)

        def add_incomplete(cells):
            q = cells.query_selector(config.q_add_incomplete)
            xp = cells.query_advice(x_p, Rotation.cur())
            yp = cells.query_advice(y_p, Rotation.cur())
            xq = cells.query_advice(x_qr, Rotation.cur())
            yq = cells.query_advice(y_qr, Rotation.cur())
            xr = cells.query_advice(x_qr, Rotation.next())
            yr = cells.query_advice(y_qr, Rotation.next())
            poly1 = (xr + xq + xp) * (xp - xq) * (xp - xq) - (yp - yq) * (yp - yq)
            poly2 = (yr + yq) * (xp - xq) - (yp - yq) * (xq - xr)
            return [("x_r", q * poly1), ("y_r", q * poly2)]

        meta.create_gate("incomplete addition", add_incomplete)

        def add_complete(cells):
            q = cells.query_selector(config.q_add)
            xp = cells.query_advice(x_p, Rotation.cur())
            yp = cells.query_advice(y_p, Rotation.cur())
            xq = cells.query_advice(x_qr, Rotation.cur())
            yq = cells.query_advice(y_qr, Rotation.cur())
            xr = cells.query_advice(x_qr, Rotation.next())
            yr = cells.query_advice(y_qr, Rotation.next())
            lmb = cells.query_advice(lam, Rotation.cur())
            a = cells.query_advice(alpha, Rotation.cur())
            bt = cells.query_advice(beta, Rotation.cur())
            g = cells.query_advice(gamma, Rotation.cur())
            d = cells.query_advice(delta, Rotation.cur())

            xq_m_xp = xq - xp
            xp_m_xr = xp - xr
            yq_p_yp = yq + yp
            if_alpha = xq_m_xp * a
            if_beta = xp * bt
            if_gamma = xq * g
            if_delta = yq_p_yp * d
            one = Constant(1)

            poly1 = xq_m_xp * (xq_m_xp * lmb - (yq - yp))
            poly2 = (one - if_alpha) * (yp * 2 * lmb - xp * xp * 3)
            nonex_xr = lmb * lmb - xp - xq - xr
            nonex_yr = lmb * xp_m_xr - yp - yr
            poly3a = xp * xq * xq_m_xp * nonex_xr
            poly3b = xp * xq * xq_m_xp * nonex_yr
            poly3c = xp * xq * yq_p_yp * nonex_xr
            poly3d = xp * xq * yq_p_yp * nonex_yr
            poly4a = (one - if_beta) * (xr - xq)
            poly4b = (one - if_beta) * (yr - yq)
            poly5a = (one - if_gamma) * (xr - xp)
            poly5b = (one - if_gamma) * (yr - yp)
            poly6a = (one - if_alpha - if_delta) * xr
            poly6b = (one - if_alpha - if_delta) * yr
            return [
                ("1", q * poly1), ("2", q * poly2),
                ("3a", q * poly3a), ("3b", q * poly3b),
                ("3c", q * poly3c), ("3d", q * poly3d),
                ("4a", q * poly4a), ("4b", q * poly4b),
                ("5a", q * poly5a), ("5b", q * poly5b),
                ("6a", q * poly6a), ("6b", q * poly6b),
            ]

        meta.create_gate("complete addition", add_complete)

        config.q_mul_step = meta.selector()

        def mul_step(cells):
            """One double-and-add select step (variable-base mul).

            Row 0 holds acc (x_p,y_p), acc+P (x_qr,y_qr), the scalar bit
            (lam) and the incoming running sum z_prev (alpha); row 1 holds
            the selected output point (x_p,y_p) and z_new = 2 z_prev + bit
            (alpha).  Replaces the reference's hi/lo incomplete + complete
            round machinery (ecc/chip/mul{,/incomplete,/complete}.rs) with
            all-complete rounds — simpler and branch-free; the adds
            themselves come from the complete-add gate in adjacent regions.
            """
            q = cells.query_selector(config.q_mul_step)
            bit = cells.query_advice(lam, Rotation.cur())
            accx = cells.query_advice(x_p, Rotation.cur())
            accy = cells.query_advice(y_p, Rotation.cur())
            sumx = cells.query_advice(x_qr, Rotation.cur())
            sumy = cells.query_advice(y_qr, Rotation.cur())
            outx = cells.query_advice(x_p, Rotation.next())
            outy = cells.query_advice(y_p, Rotation.next())
            z_prev = cells.query_advice(alpha, Rotation.cur())
            z_new = cells.query_advice(alpha, Rotation.next())
            one = Constant(1)
            return [
                ("bit boolean", q * bit * (bit - one)),
                ("select x", q * (outx - bit * sumx - (one - bit) * accx)),
                ("select y", q * (outy - bit * sumy - (one - bit) * accy)),
                ("z chain", q * (z_new - z_prev * 2 - bit)),
            ]

        meta.create_gate("mul double-and-add step", mul_step)
        return config

    # ------------------------------------------------------------------

    def witness_point(self, layouter: Layouter, value: Value) -> EccPoint:
        """value: Value of host affine (x, y) tuple or None for identity."""
        config = self.config

        def do(region: Region):
            config.q_point.enable(region, 0)
            coords = value.map(lambda pt: (0, 0) if pt is None else pt)
            x = region.assign_advice(config.x_p, 0, lambda: coords.map(lambda c: c[0]))
            y = region.assign_advice(config.y_p, 0, lambda: coords.map(lambda c: c[1]))
            return EccPoint(x, y)

        return layouter.namespace("witness point").assign_region("witness point", do)

    def witness_point_non_id(self, layouter: Layouter, value: Value) -> EccPoint:
        config = self.config

        def do(region: Region):
            config.q_point_non_id.enable(region, 0)
            x = region.assign_advice(config.x_p, 0, lambda: value.map(lambda c: c[0]))
            y = region.assign_advice(config.y_p, 0, lambda: value.map(lambda c: c[1]))
            return EccPoint(x, y)

        return layouter.namespace("witness non-id point").assign_region(
            "witness non-id point", do
        )

    def add_incomplete(self, layouter: Layouter, p: EccPoint, q: EccPoint) -> EccPoint:
        config = self.config
        fp = self.curve.base.p

        def do(region: Region):
            config.q_add_incomplete.enable(region, 0)
            p.x.copy_advice(region, config.x_p, 0)
            p.y.copy_advice(region, config.y_p, 0)
            q.x.copy_advice(region, config.x_qr, 0)
            q.y.copy_advice(region, config.y_qr, 0)

            def compute(vals):
                (xp, yp), (xq, yq) = vals
                assert not (xp == 0 and yp == 0) and not (xq == 0 and yq == 0)
                assert xp != xq, "incomplete addition exceptional case"
                lam = (yq - yp) * _inv0(xq - xp, fp) % fp
                xr = (lam * lam - xp - xq) % fp
                yr = (lam * (xp - xr) - yp) % fp
                return (xr, yr)

            r = p.x.value.zip(p.y.value).zip(q.x.value.zip(q.y.value)).map(compute)
            x_r = region.assign_advice(config.x_qr, 1, lambda: r.map(lambda t: t[0]))
            y_r = region.assign_advice(config.y_qr, 1, lambda: r.map(lambda t: t[1]))
            return EccPoint(x_r, y_r)

        return layouter.namespace("incomplete add").assign_region("incomplete add", do)

    def add(self, layouter: Layouter, p: EccPoint, q: EccPoint) -> EccPoint:
        """Complete addition (add.rs assign_region)."""
        config = self.config
        fp = self.curve.base.p

        def do(region: Region):
            config.q_add.enable(region, 0)
            p.x.copy_advice(region, config.x_p, 0)
            p.y.copy_advice(region, config.y_p, 0)
            q.x.copy_advice(region, config.x_qr, 0)
            q.y.copy_advice(region, config.y_qr, 0)

            vals = p.x.value.zip(p.y.value).zip(q.x.value.zip(q.y.value))

            def aux(v):
                (xp, yp), (xq, yq) = v
                alpha = _inv0(xq - xp, fp)
                beta = _inv0(xp, fp)
                gamma = _inv0(xq, fp)
                delta = _inv0(yq + yp, fp) if xq % fp == xp % fp else 0
                if xq % fp != xp % fp:
                    lam = (yq - yp) * _inv0(xq - xp, fp) % fp
                elif yp % fp != 0:
                    lam = 3 * xp * xp % fp * _inv0(2 * yp, fp) % fp
                else:
                    lam = 0
                # result with identity handling
                if xp % fp == 0 and yp % fp == 0:
                    xr, yr = xq % fp, yq % fp
                elif xq % fp == 0 and yq % fp == 0:
                    xr, yr = xp % fp, yp % fp
                elif xq % fp == xp % fp and (yq + yp) % fp == 0:
                    xr, yr = 0, 0
                else:
                    xr = (lam * lam - xp - xq) % fp
                    yr = (lam * (xp - xr) - yp) % fp
                return alpha, beta, gamma, delta, lam % fp, xr, yr

            computed = vals.map(aux)
            region.assign_advice(config.alpha, 0, lambda: computed.map(lambda t: t[0]))
            region.assign_advice(config.beta, 0, lambda: computed.map(lambda t: t[1]))
            region.assign_advice(config.gamma, 0, lambda: computed.map(lambda t: t[2]))
            region.assign_advice(config.delta, 0, lambda: computed.map(lambda t: t[3]))
            region.assign_advice(config.lam, 0, lambda: computed.map(lambda t: t[4]))
            x_r = region.assign_advice(
                config.x_qr, 1, lambda: computed.map(lambda t: t[5])
            )
            y_r = region.assign_advice(
                config.y_qr, 1, lambda: computed.map(lambda t: t[6])
            )
            return EccPoint(x_r, y_r)

        return layouter.namespace("complete add").assign_region("complete add", do)

    # ------------------------------------------------------------------
    # scalar multiplication
    # ------------------------------------------------------------------

    NUM_BITS = 254  # default mul width; mul_alpha covers the full field range

    def mul(self, layouter: Layouter, scalar: Value, base: EccPoint):
        """Variable-base scalar mul: returns ([scalar] base, scalar_cell).

        Functional replacement for ecc/chip/mul.rs: MSB-first double-and-add
        where every round uses the complete-add gate (the reference splits
        hi/lo incomplete + complete rounds for row count; here uniformity
        wins).  The scalar is decomposed into 254 boolean-constrained bits
        chained through a running sum z_i = 2 z_{i+1} + b_i with z_254
        pinned to 0; the final z_0 cell IS the scalar (returned so callers
        can constrain it).  For scalars in [2^254, p) use ``mul_alpha``,
        which extends to 255 bits and adds the canonicity/overflow check
        (mul/overflow.rs semantics).
        """
        acc, z_cell, _ = self._mul_bits(layouter, scalar, base, self.NUM_BITS)
        return acc, z_cell

    def mul_alpha(self, layouter: Layouter, alpha_cell, base: EccPoint, mul_fixed_chip):
        """[alpha]B for a full-range base-field cell (0 <= alpha < p).

        Replaces the reference's variable-base overflow machinery
        (ecc/chip/mul/overflow.rs): the scalar is decomposed into 255 bits,
        the bit chain's final running sum is equality-bound to ``alpha_cell``,
        and the mod-p ambiguity of a 255-bit decomposition (k vs k + p) is
        eliminated by enforcing that the decomposition is the *canonical*
        alpha < p via the shared three-piece canonicity gate
        (MulFixedChip.canonicity_check).  The bit chain's intermediate values
        provide the needed window sums: alpha >> 252 after 3 steps,
        alpha >> 132 after 123, alpha >> 129 after 126.
        """
        from .mul_fixed import _ev_int

        alpha_v = alpha_cell.value.map(_ev_int)
        acc, z_cell, zs = self._mul_bits(layouter, alpha_v, base, 255)

        def bind(region: Region):
            region.constrain_equal(z_cell.cell, alpha_cell.cell)

        layouter.namespace("bind alpha").assign_region("bind alpha", bind)
        mul_fixed_chip.canonicity_check(
            layouter, alpha_cell, zs[125], zs[122], zs[2]
        )
        return acc

    def _mul_bits(self, layouter: Layouter, scalar: Value, base: EccPoint, num_bits: int):
        """Shared double-and-add loop; returns (acc, final_z_cell, z_cells)
        where z_cells[i] is the running sum after i+1 steps (the value of the
        top i+1 bits of the scalar)."""
        config = self.config
        fp = self.curve.base.p

        # acc starts at the identity, pinned to (0, 0)
        def init(region: Region):
            config.q_point.enable(region, 0)
            x = region.assign_advice(config.x_p, 0, lambda: Value.known(0))
            y = region.assign_advice(config.y_p, 0, lambda: Value.known(0))
            region.constrain_constant(x.cell, 0)
            region.constrain_constant(y.cell, 0)
            return EccPoint(x, y)

        acc = layouter.namespace("mul init").assign_region("mul init", init)

        bits = scalar.map(
            lambda v: [(v >> i) & 1 for i in reversed(range(num_bits))]
        )
        z_prev_cell = None  # z_{num_bits} pinned to 0 inside the first step region
        z_val = Value.known(0)
        z_cells = []

        for i in range(num_bits):
            doubled = self.add(layouter, acc, acc)
            summed = self.add(layouter, doubled, base)
            bit_i = bits.map(lambda bs, i=i: bs[i])
            z_new_val = z_val.zip(bit_i).map(lambda t: (2 * t[0] + t[1]) % fp)

            def step(region: Region, doubled=doubled, summed=summed,
                     bit_i=bit_i, z_val=z_val, z_new_val=z_new_val,
                     z_prev_cell=z_prev_cell):
                config.q_mul_step.enable(region, 0)
                doubled.x.copy_advice(region, config.x_p, 0)
                doubled.y.copy_advice(region, config.y_p, 0)
                summed.x.copy_advice(region, config.x_qr, 0)
                summed.y.copy_advice(region, config.y_qr, 0)
                region.assign_advice(config.lam, 0, lambda: bit_i)
                if z_prev_cell is None:
                    zp = region.assign_advice(config.alpha, 0, lambda: z_val)
                    region.constrain_constant(zp.cell, 0)
                else:
                    z_prev_cell.copy_advice(region, config.alpha, 0)
                # selected output coordinates
                sel = bit_i.zip(
                    doubled.x.value.zip(doubled.y.value).zip(
                        summed.x.value.zip(summed.y.value)
                    )
                ).map(lambda t: t[1][1] if t[0] else t[1][0])
                x_o = region.assign_advice(
                    config.x_p, 1, lambda: sel.map(lambda c: c[0])
                )
                y_o = region.assign_advice(
                    config.y_p, 1, lambda: sel.map(lambda c: c[1])
                )
                z_n = region.assign_advice(config.alpha, 1, lambda: z_new_val)
                return EccPoint(x_o, y_o), z_n

            acc, z_prev_cell = layouter.namespace(f"mul step {i}").assign_region(
                f"mul step {i}", step
            )
            z_cells.append(z_prev_cell)
            z_val = z_new_val

        return acc, z_prev_cell, z_cells

    def mul_fixed(self, layouter: Layouter, scalar: Value, base_xy):
        """Fixed-base mul: the base is pinned to circuit constants.

        API parity with ecc/chip/mul_fixed.rs; this build reuses the
        variable-base machinery on a constant-pinned point instead of the
        reference's windowed fixed tables (divergence noted in PARITY.md —
        same function, more rows).
        """
        config = self.config

        def pin(region: Region):
            config.q_point_non_id.enable(region, 0)
            x = region.assign_advice(config.x_p, 0, lambda: Value.known(base_xy[0]))
            y = region.assign_advice(config.y_p, 0, lambda: Value.known(base_xy[1]))
            region.constrain_constant(x.cell, base_xy[0])
            region.constrain_constant(y.cell, base_xy[1])
            return EccPoint(x, y)

        base = layouter.namespace("fixed base").assign_region("fixed base", pin)
        return self.mul(layouter, scalar, base)
