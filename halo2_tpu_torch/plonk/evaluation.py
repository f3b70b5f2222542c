"""Quotient polynomial evaluation — the prover's hot loop.

Port of the JAX package's ``plonk/evaluation.py`` (the reference
plonk/evaluation.rs).  Every constraint is evaluated as whole-tensor limb ops
over the extended domain, with rotations as ``torch.roll`` and the per-row
omega/delta factors as precomputed power tables.  ``torch.roll`` shifts
toward higher indices for a positive shift, as ``jnp.roll`` does, so the
reference's shift signs carry over unchanged.

Lookups are not in this slice of the port (ROADMAP §1): ``create_proof``
refuses circuits that have them before it gets here.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch

from ..fields import limb
from ..fields.spec import FieldSpec
from ..poly.domain import EvaluationDomain
from ..poly.polynomial import EXTENDED, Poly
from .circuit import (
    AdviceExpr,
    ChallengeExpr,
    Constant,
    Expression,
    FixedExpr,
    InstanceExpr,
    Negated,
    Product,
    Scaled,
    SelectorExpr,
    Sum,
)


class EvalContext:
    """Value sources for expression evaluation over a (16, size) row space.

    ``fixed``/``advice``/``instance`` are either lists of (16, size) tensors or
    a callable ``index -> tensor`` (the streaming coset provider below).
    ``max_cached_rolls=None`` caches every rotation; a number caps the
    rotation cache LRU-style for large extended domains.
    """

    def __init__(
        self,
        spec: FieldSpec,
        size: int,
        rot_scale: int,
        fixed,
        advice,
        instance,
        challenges: List[torch.Tensor],
        device,
        max_cached_rolls: int | None = None,
    ):
        self.spec = spec
        self.device = device
        self.size = size
        self.rot_scale = rot_scale
        self.fixed = fixed
        self.advice = advice
        self.instance = instance
        self.challenges = challenges
        self.max_cached_rolls = max_cached_rolls
        self._rolls: "OrderedDict" = OrderedDict()

    def _source(self, kind: str, index: int) -> torch.Tensor:
        src = {"fixed": self.fixed, "advice": self.advice, "instance": self.instance}[kind]
        return src(index) if callable(src) else src[index]

    def rotated(self, kind: str, index: int, rot: int) -> torch.Tensor:
        if rot == 0:
            return self._source(kind, index)
        key = (kind, index, rot)
        if key in self._rolls:
            self._rolls.move_to_end(key)
            return self._rolls[key]
        out = torch.roll(self._source(kind, index), -rot * self.rot_scale, dims=1)
        self._rolls[key] = out
        if self.max_cached_rolls is not None:
            while len(self._rolls) > self.max_cached_rolls:
                self._rolls.popitem(last=False)
        return out

    def constant(self, v: int) -> torch.Tensor:
        return limb.from_int(self.spec, v % self.spec.p, self.device).reshape(-1, 1)


def evaluate_expr(expr: Expression, ctx: EvalContext) -> torch.Tensor:
    """Evaluate an expression; the result broadcasts to (16, ctx.size)."""
    spec = ctx.spec
    if isinstance(expr, Constant):
        return ctx.constant(expr.value)
    if isinstance(expr, SelectorExpr):
        raise ValueError("virtual selectors must be converted before evaluation")
    if isinstance(expr, FixedExpr):
        return ctx.rotated("fixed", expr.query.column_index, expr.query.rotation.i)
    if isinstance(expr, AdviceExpr):
        return ctx.rotated("advice", expr.query.column_index, expr.query.rotation.i)
    if isinstance(expr, InstanceExpr):
        return ctx.rotated("instance", expr.query.column_index, expr.query.rotation.i)
    if isinstance(expr, ChallengeExpr):
        return ctx.challenges[expr.challenge.index].reshape(-1, 1)
    if isinstance(expr, Negated):
        return limb.fneg(spec, evaluate_expr(expr.expr, ctx))
    if isinstance(expr, Sum):
        return limb.fadd(spec, evaluate_expr(expr.a, ctx), evaluate_expr(expr.b, ctx))
    if isinstance(expr, Product):
        return limb.fmul(spec, evaluate_expr(expr.a, ctx), evaluate_expr(expr.b, ctx))
    if isinstance(expr, Scaled):
        return limb.fmul(spec, evaluate_expr(expr.expr, ctx), ctx.constant(expr.factor))
    raise TypeError(f"unknown expression {type(expr)}")


class Evaluator:
    """Holds the constraint system; evaluates h over the extended domain.

    Above ``stream_threshold`` extended rows, advice and instance cosets are
    computed on demand from their coefficient polys and held in an LRU of
    ``coset_budget`` columns, so peak memory is O(budget) columns instead of
    O(num_columns); an evicted column costs one more extended NTT if reused.
    """

    stream_threshold = 1 << 20
    coset_budget = 6

    def __init__(self, cs):
        self.cs = cs

    def evaluate_h(
        self,
        pk,
        advice_polys: List[List[Poly]],  # coeff, per circuit instance
        instance_polys: List[List[Poly]],
        challenges: List[torch.Tensor],
        y: torch.Tensor,
        beta: torch.Tensor,
        gamma: torch.Tensor,
        permutations: List,  # per instance, permutation Committed
    ) -> Poly:
        cs = self.cs
        domain: EvaluationDomain = pk.vk.domain
        spec = domain.spec
        dev = domain.device
        size = domain.extended_len
        rot_scale = 1 << (domain.extended_k - domain.k)
        fixed = [p.values for p in pk.fixed_cosets]
        l0 = pk.l0.values
        l_last = pk.l_last.values
        l_active = pk.l_active_row.values
        one = limb.from_int(spec, 1, dev).reshape(-1, 1)
        yb = y.reshape(-1, 1)
        betab = beta.reshape(-1, 1)
        gammab = gamma.reshape(-1, 1)

        def fold(acc, term):
            return limb.fadd(spec, limb.fmul(spec, acc, yb), term)

        values = limb.zeros((size,), dev)
        streaming = size >= self.stream_threshold

        for inst_idx in range(len(advice_polys)):
            if streaming:
                cache: "OrderedDict" = OrderedDict()

                def provider(polys, tag):
                    def get(index):
                        key = (tag, index)
                        if key in cache:
                            cache.move_to_end(key)
                            return cache[key]
                        arr = domain.coeff_to_extended(polys[index]).values
                        cache[key] = arr
                        while len(cache) > self.coset_budget:
                            cache.popitem(last=False)
                        return arr

                    return get

                advice = provider(advice_polys[inst_idx], "advice")
                instance = provider(instance_polys[inst_idx], "instance")
                max_rolls = 2
            else:
                advice = [domain.coeff_to_extended(p).values for p in advice_polys[inst_idx]]
                instance = [domain.coeff_to_extended(p).values for p in instance_polys[inst_idx]]
                max_rolls = None
            ctx = EvalContext(
                spec, size, rot_scale, fixed, advice, instance, challenges, dev,
                max_cached_rolls=max_rolls,
            )

            # Custom gates (Horner fold with y, evaluation.rs:229-240)
            for gate in cs.gates:
                for poly in gate.polynomials():
                    values = fold(values, evaluate_expr(poly, ctx))

            # Permutation constraints (evaluation.rs:364-444)
            perm = permutations[inst_idx]
            sets = perm.sets if perm is not None else []
            if sets:
                bf = cs.blinding_factors()
                last_rot = -(bf + 1)
                chunk_len = cs.degree() - 2
                first_z = sets[0].product_coset
                last_z = sets[-1].product_coset

                # l_0(X) * (1 - z_0(X))
                values = fold(values, limb.fmul(spec, limb.fsub(spec, one, first_z), l0))
                # l_last(X) * (z_l(X)^2 - z_l(X))
                values = fold(
                    values,
                    limb.fmul(
                        spec, limb.fsub(spec, limb.fmul(spec, last_z, last_z), last_z), l_last
                    ),
                )
                # l_0(X) * (z_i(X) - z_{i-1}(omega^last X)) for i > 0
                for set_idx in range(1, len(sets)):
                    prev_rot = torch.roll(
                        sets[set_idx - 1].product_coset, -last_rot * rot_scale, dims=1
                    )
                    values = fold(
                        values,
                        limb.fmul(
                            spec, limb.fsub(spec, sets[set_idx].product_coset, prev_rot), l0
                        ),
                    )
                # main constraint per set
                ext_omega_pows = domain._ext_tw_full  # (16, size) table of ext_omega^i
                delta_start = limb.fmul(
                    spec, betab, limb.from_int(spec, spec.zeta, dev).reshape(-1, 1)
                )
                col_counter = 0
                columns = cs.permutation.columns
                for set_idx, pset in enumerate(sets):
                    cols = columns[set_idx * chunk_len : (set_idx + 1) * chunk_len]
                    cosets = pk.permutation.cosets[set_idx * chunk_len : (set_idx + 1) * chunk_len]
                    left = torch.roll(pset.product_coset, -rot_scale, dims=1)
                    right = pset.product_coset
                    for column, sigma in zip(cols, cosets):
                        vals = ctx.rotated(column.kind, column.index, 0)
                        left = limb.fmul(
                            spec,
                            left,
                            limb.fadd(
                                spec,
                                limb.fadd(spec, vals, limb.fmul(spec, betab, sigma.values)),
                                gammab,
                            ),
                        )
                        # current_delta = beta * zeta * delta^col_counter * ext_omega^idx
                        dpow = limb.from_int(spec, pow(spec.delta, col_counter, spec.p), dev)
                        cur_delta = limb.fmul(
                            spec,
                            limb.fmul(spec, delta_start, dpow.reshape(-1, 1)),
                            ext_omega_pows,
                        )
                        right = limb.fmul(
                            spec, right, limb.fadd(spec, limb.fadd(spec, vals, cur_delta), gammab)
                        )
                        col_counter += 1
                    values = fold(
                        values, limb.fmul(spec, limb.fsub(spec, left, right), l_active)
                    )

        return Poly(values, EXTENDED)
