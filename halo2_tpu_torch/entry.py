"""Entry points of the port on one device: a prover round, and the pinned proof.

Port of the JAX package's ``__graft_entry__.py``, one device:

- ``entry()`` returns ``(fn, example_args)``: one prover round over a k=10
  advice column on the card, the hot path of plonk/prover.rs create_proof
  (SURVEY.md §3.2).  ``fn`` commits the column (MSM over the Lagrange SRS),
  takes it to coefficients (inverse NTT), extends it to the zeta coset
  (NTT), evaluates the degree-2 gate v^2 - v there, divides by the vanishing
  polynomial, returns to coefficients and commits the quotient.  The SRS is
  the device ``ParamsKZG.setup``.
- ``dryrun_full_proof()`` proves ``EntryCircuit`` at k=6 (keygen_vk,
  keygen_pk, create_proof over KZG/GWC and Blake2b) and raises unless the
  bytes equal the JAX package's pin ``tests/data/dryrun_proof_k6.hex``.  A
  missing pin fails: this module never writes one.  The multi-device dry run
  waits for the port of ``parallel/``.

    python -m halo2_tpu_torch.entry
"""

from __future__ import annotations

import os
import time

from .circuit import Circuit, Value
from .poly import Rotation

PIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "dryrun_proof_k6.hex")


class EntryCircuit(Circuit):
    """Mul-gate circuit (simple-example.rs shape): out = a^4 at row 0 of the
    instance column, via two mul regions (``__graft_entry__._EntryCircuit``)."""

    def __init__(self, constant, a):
        self.constant = constant
        self.a = a

    def without_witnesses(self):
        return EntryCircuit(self.constant, Value.unknown())

    @classmethod
    def configure(cls, meta):
        advice = [meta.advice_column(), meta.advice_column()]
        instance = meta.instance_column()
        constant = meta.fixed_column()
        meta.enable_equality(instance)
        meta.enable_constant(constant)
        for column in advice:
            meta.enable_equality(column)
        s_mul = meta.selector()

        def gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_mul)
            return [s * (lhs * rhs - out)]

        meta.create_gate("mul", gate)
        return {"advice": advice, "instance": instance, "s_mul": s_mul}

    def synthesize(self, config, layouter):
        advice = config["advice"]

        def load(value):
            return layouter.assign_region(
                "load", lambda region: region.assign_advice(advice[0], 0, lambda: value)
            )

        def mul(a_cell, b_cell):
            def do(region):
                config["s_mul"].enable(region, 0)
                a_cell.copy_advice(region, advice[0], 0)
                b_cell.copy_advice(region, advice[1], 0)
                return region.assign_advice(advice[0], 1, lambda: a_cell.value * b_cell.value)

            return layouter.assign_region("mul", do)

        a = load(self.a)
        ab = mul(a, a)
        out = mul(ab, ab)
        layouter.constrain_instance(out.cell, config["instance"], 0)


def entry(device="cuda"):
    """(fn, example_args): the prover round at k=10 on ``device``."""
    from .curves.spec import BN254_G1
    from .fields import limb
    from .ops.msm import msm
    from .poly.domain import EvaluationDomain
    from .poly.kzg import ParamsKZG
    from .poly.polynomial import LAGRANGE, Poly

    k = 10
    spec = BN254_G1.scalar
    domain = EvaluationDomain(spec, 3, k, device)  # degree-3 gate: extended_k = k + 1
    params = ParamsKZG.setup(k, seed=b"graft-entry", device=device)
    curve, g_lag = params.curve, params.g_lagrange

    def step(values):
        # values: (16, n) Montgomery limbs of an advice column (Lagrange basis)
        commit = msm(curve, values, g_lag)
        coset = domain.coeff_to_extended(domain.lagrange_to_coeff(Poly(values, LAGRANGE)))
        gate = limb.fsub(spec, limb.fmul(spec, coset.values, coset.values), coset.values)
        h = domain.divide_by_vanishing_poly(Poly(gate, coset.basis))
        h_coeff = domain.extended_to_coeff(h)
        h_commit = msm(curve, h_coeff[:, : domain.n], g_lag)
        return commit.x, h_commit.x

    example = limb.from_ints(spec, [(i * i + 1) % spec.p for i in range(domain.n)], device)
    return step, (example,)


def dryrun_full_proof(device="cuda", log=print) -> bytes:
    """The k=6 ``EntryCircuit`` proof on ``device``; raises unless it equals
    the pin.  Returns the proof."""
    from .curves.spec import BN254_G1
    from .plonk import create_proof, keygen_pk, keygen_vk
    from .poly.kzg import ParamsKZG
    from .poly.multiopen_gwc import gwc_create_proof
    from .transcript import Blake2bTranscript
    from .utils.rng import FieldRng

    with open(PIN) as f:
        expected = bytes.fromhex(f.read().strip())
    t0 = time.perf_counter()
    k, a = 6, 5
    spec = BN254_G1.scalar
    circuit = EntryCircuit(1, Value.known(a))
    params = ParamsKZG.setup_host(k, seed=b"dryrun", device=device)  # as the pin was made
    vk = keygen_vk(params, circuit.without_witnesses())
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    proof = create_proof(
        params, pk, [circuit], [[[pow(a, 4, spec.p)]]], FieldRng(spec, b"dryrun-proof"),
        Blake2bTranscript(BN254_G1), gwc_create_proof,
    )
    if proof != expected:
        raise AssertionError(f"k={k} proof bytes differ from {os.path.relpath(PIN)}")
    log(f"[dryrun] k={k} proof == pinned bytes ({len(proof)} B), "
        f"{time.perf_counter() - t0:.2f} s on {device}")
    return proof


def main() -> None:
    fn, example = entry()
    out = fn(*example)
    print("entry OK", [tuple(o.shape) for o in out], flush=True)
    dryrun_full_proof()


if __name__ == "__main__":
    main()
