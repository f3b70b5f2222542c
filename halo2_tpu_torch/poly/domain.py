"""Evaluation domains: 2^k base domain + 2^extended_k zeta-coset domain.

Port of the JAX package's ``poly/domain.py`` (the reference EvaluationDomain,
poly/domain.rs:39-362): host-side Python-int scalar precomputation (omegas,
divisors, t-evaluations, barycentric weight) plus cached device twiddle and
coset tables for the six-step NTT of ``ops/ntt.py``.  Every table lives on
``self.device``.  With ``self.mesh`` set (keygen and ``create_proof`` set it
from their ``mesh=``), a transform of length >= D^2 runs sharded over the
mesh's D devices (``parallel/ntt.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import NLIMBS, FieldSpec, int_to_limbs
from ..ops import ntt as ntt_ops
from ..parallel import ntt as parallel_ntt
from .polynomial import COEFF, EXTENDED, LAGRANGE, Poly, Rotation


class EvaluationDomain:
    def __init__(self, spec: FieldSpec, j: int, k: int, device="cuda"):
        """j = max constraint degree (quotient spans (j-1)*n); k = log2 rows.

        Mirrors EvaluationDomain::new (poly/domain.rs:39-142).  The tables and
        every poly the domain makes live on ``device``, the card unless the
        caller names another (a CPU caller passes ``device="cpu"``).
        """
        self.spec = spec
        self.device = torch.device(device)
        p = spec.p
        self.k = k
        self.n = 1 << k
        quotient_poly_degree = j - 1
        self.quotient_poly_degree = quotient_poly_degree

        extended_k = k
        while (1 << extended_k) < self.n * quotient_poly_degree:
            extended_k += 1
        self.extended_k = extended_k

        # extended_omega = root_of_unity^(2^(S - extended_k))
        ext_omega = spec.root_of_unity
        for _ in range(extended_k, spec.s):
            ext_omega = ext_omega * ext_omega % p
        self.extended_omega = ext_omega
        self.extended_omega_inv = pow(ext_omega, -1, p)

        omega = ext_omega
        for _ in range(k, extended_k):
            omega = omega * omega % p
        self.omega = omega
        self.omega_inv = pow(omega, -1, p)

        self.g_coset = spec.zeta
        self.g_coset_inv = spec.zeta * spec.zeta % p

        # t_evaluations[i] = zeta^n * extended_omega^(i*n) - 1, stored inverted
        # (we only ever divide by t; poly/domain.rs:84-124,307-326).
        m = 1 << (extended_k - k)
        orig = pow(spec.zeta, self.n, p)
        step = pow(ext_omega, self.n, p)
        t_evals = []
        cur = orig
        while True:
            t_evals.append((cur - 1) % p)
            cur = cur * step % p
            if cur == orig:
                break
        assert len(t_evals) == m
        self.t_evaluations_inv = [pow(t, -1, p) for t in t_evals]

        self.ifft_divisor = pow(1 << k, -1, p)
        self.extended_ifft_divisor = pow(1 << extended_k, -1, p)
        self.barycentric_weight = pow(self.n, -1, p)
        # optional parallel.DeviceMesh: the transforms run as the four-step
        # sharded NTT (parallel/ntt.py), the analog of the reference's
        # thread-split FFT (arithmetic.rs:202-274)
        self.mesh = None

    def _use_mesh(self, length: int) -> bool:
        if self.mesh is None:
            return False
        ndev = self.mesh.shape["shard"]
        return ndev > 1 and length >= ndev * ndev

    # ------------------------------------------------------------------
    # cached device tables
    # ------------------------------------------------------------------

    def _power_table(self, base: int, n: int):
        return ntt_ops.power_table(self.spec, base, n, self.device)

    @functools.cached_property
    def _tw(self):
        return self._power_table(self.omega, self.n // 2)

    @functools.cached_property
    def _tw_inv(self):
        return self._power_table(self.omega_inv, self.n // 2)

    @functools.cached_property
    def _ext_tw(self):
        return self._power_table(self.extended_omega, self.extended_len // 2)

    @functools.cached_property
    def _ext_tw_inv(self):
        return self._power_table(self.extended_omega_inv, self.extended_len // 2)

    # the six-step's per-axis tables, contiguous (ops.ntt.sixstep_twiddles):
    # a transform then makes no strided-slice copy of its twiddles
    @functools.cached_property
    def _tw_axes(self):
        return ntt_ops.sixstep_twiddles(self._tw, self.k)

    @functools.cached_property
    def _tw_inv_axes(self):
        return ntt_ops.sixstep_twiddles(self._tw_inv, self.k)

    @functools.cached_property
    def _ext_tw_axes(self):
        return ntt_ops.sixstep_twiddles(self._ext_tw, self.extended_k)

    @functools.cached_property
    def _ext_tw_inv_axes(self):
        return ntt_ops.sixstep_twiddles(self._ext_tw_inv, self.extended_k)

    @functools.cached_property
    def _omega_pows_full(self):
        """Full (16, n) table of omega^i (permutation numerators etc.)."""
        return self._power_table(self.omega, self.n)

    @functools.cached_property
    def _ext_tw_full(self):
        """Full (16, extended_len) table of extended_omega^i (quotient eval)."""
        return self._power_table(self.extended_omega, self.extended_len)

    @functools.cached_property
    def _wc(self):
        return ntt_ops.cross_twiddles(self.spec, self.omega, self.k, self.device)

    @functools.cached_property
    def _wc_inv(self):
        return ntt_ops.cross_twiddles(self.spec, self.omega_inv, self.k, self.device)

    @functools.cached_property
    def _ext_wc(self):
        return ntt_ops.cross_twiddles(self.spec, self.extended_omega, self.extended_k, self.device)

    @functools.cached_property
    def _ext_wc_inv(self):
        return ntt_ops.cross_twiddles(
            self.spec, self.extended_omega_inv, self.extended_k, self.device
        )

    @functools.cached_property
    def _ifft_div_mont(self):
        return limb.from_int(self.spec, self.ifft_divisor, self.device)

    @functools.cached_property
    def _ext_ifft_div_mont(self):
        return limb.from_int(self.spec, self.extended_ifft_divisor, self.device)

    def _zeta_table(self, n: int, into_coset: bool):
        """(16, n) table [1, z0, z1, 1, z0, z1, ...] for distribute_powers_zeta
        (poly/domain.rs:335-351)."""
        if into_coset:
            pows = [1, self.g_coset, self.g_coset_inv]
        else:
            pows = [1, self.g_coset_inv, self.g_coset]
        small = np.stack(
            [int_to_limbs(self.spec.to_mont(v)).astype(np.int32) for v in pows], axis=1
        )  # (16, 3)
        idx = np.arange(n) % 3
        return torch.from_numpy(np.ascontiguousarray(small[:, idx])).to(self.device)

    @functools.cached_property
    def _zeta_into(self):
        return self._zeta_table(self.n, True)

    @functools.cached_property
    def _zeta_outof_ext(self):
        return self._zeta_table(self.extended_len, False)

    @functools.cached_property
    def _t_inv_mont(self):
        return limb.from_ints(self.spec, self.t_evaluations_inv, self.device)

    # ------------------------------------------------------------------
    # basic constructors
    # ------------------------------------------------------------------

    @property
    def extended_len(self) -> int:
        return 1 << self.extended_k

    def empty_lagrange(self) -> Poly:
        return Poly(limb.zeros((self.n,), self.device), LAGRANGE)

    def empty_coeff(self) -> Poly:
        return Poly(limb.zeros((self.n,), self.device), COEFF)

    def empty_extended(self) -> Poly:
        return Poly(limb.zeros((self.extended_len,), self.device), EXTENDED)

    # the constants are expanded views of one element: read them, never
    # write into them in place
    def constant_lagrange(self, value_mont) -> Poly:
        return Poly(value_mont.reshape(NLIMBS, 1).expand(NLIMBS, self.n), LAGRANGE)

    def constant_extended(self, value_mont) -> Poly:
        return Poly(value_mont.reshape(NLIMBS, 1).expand(NLIMBS, self.extended_len), EXTENDED)

    def lagrange_from_vec(self, values) -> Poly:
        assert values.shape == (NLIMBS, self.n)
        return Poly(values, LAGRANGE)

    def coeff_from_vec(self, values) -> Poly:
        assert values.shape == (NLIMBS, self.n)
        return Poly(values, COEFF)

    # ------------------------------------------------------------------
    # transforms (poly/domain.rs:225-331)
    # ------------------------------------------------------------------

    def lagrange_to_coeff(self, a: Poly) -> Poly:
        assert a.basis == LAGRANGE
        if self._use_mesh(self.n):
            return Poly(parallel_ntt.sharded_intt(self.spec, a.values, self.k, self.omega,
                                                  self.mesh), COEFF)
        vals = ntt_ops.intt_sixstep(
            self.spec, a.values, self._tw_inv, self._wc_inv, self.k, self._ifft_div_mont,
            self._tw_inv_axes,
        )
        return Poly(vals, COEFF)

    def coeff_to_lagrange(self, a: Poly) -> Poly:
        assert a.basis == COEFF
        if self._use_mesh(self.n):
            return Poly(parallel_ntt.sharded_ntt(self.spec, a.values, self.k, self.omega,
                                                 self.mesh), LAGRANGE)
        return Poly(ntt_ops.ntt_sixstep(self.spec, a.values, self._tw, self._wc, self.k,
                                        self._tw_axes), LAGRANGE)

    def coeff_to_extended(self, a: Poly) -> Poly:
        assert a.basis == COEFF
        vals = limb.fmul(self.spec, a.values, self._zeta_into)
        vals = torch.nn.functional.pad(vals, (0, self.extended_len - self.n))
        if self._use_mesh(self.extended_len):
            vals = parallel_ntt.sharded_ntt(self.spec, vals, self.extended_k,
                                            self.extended_omega, self.mesh)
        else:
            vals = ntt_ops.ntt_sixstep(self.spec, vals, self._ext_tw, self._ext_wc,
                                       self.extended_k, self._ext_tw_axes)
        return Poly(vals, EXTENDED)

    def extended_to_coeff(self, a: Poly):
        """Returns raw coefficient limbs of length n*quotient_poly_degree."""
        assert a.basis == EXTENDED
        if self._use_mesh(self.extended_len):
            vals = parallel_ntt.sharded_intt(self.spec, a.values, self.extended_k,
                                             self.extended_omega, self.mesh)
        else:
            vals = ntt_ops.intt_sixstep(
                self.spec, a.values, self._ext_tw_inv, self._ext_wc_inv,
                self.extended_k, self._ext_ifft_div_mont, self._ext_tw_inv_axes,
            )
        vals = limb.fmul(self.spec, vals, self._zeta_outof_ext)
        return vals[:, : self.n * self.quotient_poly_degree]

    def divide_by_vanishing_poly(self, a: Poly) -> Poly:
        assert a.basis == EXTENDED
        m = 1 << (self.extended_k - self.k)
        x = a.values.reshape(NLIMBS, self.extended_len // m, m)
        out = limb.fmul(self.spec, x, self._t_inv_mont[:, None, :])
        return Poly(out.reshape(NLIMBS, self.extended_len), EXTENDED)

    def rotate_extended(self, a: Poly, rotation: Rotation) -> Poly:
        assert a.basis == EXTENDED
        shift = (1 << (self.extended_k - self.k)) * rotation.i
        return Poly(torch.roll(a.values, -shift, dims=1), EXTENDED)

    # ------------------------------------------------------------------
    # host scalar helpers (canonical ints)
    # ------------------------------------------------------------------

    def rotate_omega(self, value: int, rotation: Rotation) -> int:
        if rotation.i >= 0:
            return value * pow(self.omega, rotation.i, self.spec.p) % self.spec.p
        return value * pow(self.omega_inv, -rotation.i, self.spec.p) % self.spec.p

    def l_i_range(self, x: int, xn: int, rotations) -> list:
        """Lagrange basis evaluations l_i(x) for each rotation i
        (poly/domain.rs:417-487)."""
        p = self.spec.p
        common = (xn - 1) * self.barycentric_weight % p
        out = []
        for rot in rotations:
            d = (x - self.rotate_omega(1, Rotation(rot))) % p
            r = pow(d, -1, p) * common % p
            out.append(self.rotate_omega(r, Rotation(rot)))
        return out

    def get_quotient_poly_degree(self) -> int:
        return self.quotient_poly_degree

    def pinned(self):
        return {"k": self.k, "extended_k": self.extended_k, "omega": self.omega}
