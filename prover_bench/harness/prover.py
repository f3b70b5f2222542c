"""The system under test: set-up and the measured window, driving
``halo2_tpu_torch.plonk.create_proof`` in a closed loop with one proof in
flight.

Set-up makes the SRS on the device from the seed (``ParamsKZG.setup``), runs
one ``keygen_vk`` + ``keygen_pk`` (fenced by ``torch.cuda.synchronize``; its
wall is the per-layer ``keygen_wall_s`` and pays the domain's tables) and
``WARMUP_PROOFS`` proofs of the window's shapes.  The window proves message
after message until ``seconds`` have passed; a proof that ends after the
deadline was in flight there and is neither counted nor timed, but it is
kept for the check.

With ``trace``, the first proof of the window runs under ``torch.profiler``
with the phase timers off and every later one with ``HALO2_TPU_PROFILE=1``
(device-fenced phase timers) and no profiler.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import tempfile
import time

from . import trace as trace_mod
from . import traffic

WARMUP_PROOFS = 1


@dataclasses.dataclass
class Proof:
    index: int
    message: bytes
    instance: list
    proof: bytes
    end_s: float  # seconds since the window opened
    wall_s: float = 0.0  # this proof's own wall


@dataclasses.dataclass
class Window:
    proofs: list
    counted: int  # proofs that ended inside the window
    last_end_s: float  # end of the last of them, seconds since the window opened
    trace: object = None  # trace.Trace of the profiled proof
    phases: dict = dataclasses.field(default_factory=dict)  # phase -> seconds, summed
    phase_proofs: int = 0


class Prover:
    def __init__(self, cell, seed: int, device: str = "cuda"):
        import torch

        from halo2_tpu_torch.curves.spec import BN254_G1
        from halo2_tpu_torch.transcript import TRANSCRIPTS

        cfg = cell.config
        if (cfg["curve"], cfg["commitment"]) != ("bn254", "kzg"):
            raise ValueError("the harness proves over KZG on BN254")
        traffic.check(cell.traffic)
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device = torch.device(device)
        self.curve = BN254_G1
        self.circuits = cell.circuit_module()
        self.transcript = TRANSCRIPTS[cfg["transcript"]]
        multiopen = importlib.import_module(f"halo2_tpu_torch.poly.multiopen_{cfg['multiopen']}")
        self.multiopen = getattr(multiopen, f"{cfg['multiopen']}_create_proof")
        self.params = self.vk = self.pk = None
        self.keygen_s = None

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()

    def setup(self):
        from halo2_tpu_torch.plonk import keygen_pk, keygen_vk
        from halo2_tpu_torch.poly.kzg import ParamsKZG

        k = self.cfg["k"]
        self.params = ParamsKZG.setup(k, seed=traffic.srs_seed(self.seed), device=self.device)
        self.sync()
        t0 = time.perf_counter()
        blank = self.circuits.blank(self.cfg)
        self.vk = keygen_vk(self.params, blank)
        self.pk = keygen_pk(self.params, self.vk, blank)
        self.sync()
        self.keygen_s = time.perf_counter() - t0
        for w in range(WARMUP_PROOFS):
            self.prove(-1 - w)

    def prove(self, index: int, tamper: bool = False) -> Proof:
        from halo2_tpu_torch.plonk import create_proof
        from halo2_tpu_torch.utils.rng import FieldRng

        message = traffic.message(self.cell.traffic, self.seed, index)
        circuit, instance = self.circuits.prove_inputs(self.cfg, message, tamper)
        rng = FieldRng(self.curve.scalar, traffic.blind_seed(self.seed, index))
        proof = create_proof(self.params, self.pk, [circuit], [instance], rng,
                             self.transcript(self.curve), self.multiopen)
        self.sync()
        return Proof(index, message, instance, proof, 0.0)

    def vk_data(self) -> dict:
        """The verifying key as host integers, for the check."""
        return {"fixed": list(self.vk.fixed_commitments),
                "permutation": list(self.vk.permutation_commitments),
                "repr": self.vk.transcript_repr}

    def release(self):
        """Drop the program's state before the reference runs."""
        self.params = self.vk = self.pk = None
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()


def _profiled(prover: Prover, index: int, prove):
    """prove(index) under torch.profiler; (proof, trace.Trace).  While it
    runs, the prover's phases are ``record_function`` spans: no timer, no
    ``synchronize``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from halo2_tpu_torch.utils import profiling

    activities = [ProfilerActivity.CPU]
    if prover.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    timed_phase = profiling.phase
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            profiling.phase = record_function
            try:
                with record_function(trace_mod.SPAN):
                    proof = prove(index)
            finally:
                profiling.phase = timed_phase
        path = os.path.join(tmp, "trace.json.gz")
        prof.export_chrome_trace(path)
        del prof
        events = trace_mod.read_events(path)
    return proof, trace_mod.reduce(events)


def run_window(prover: Prover, seconds: float, trace: bool = False, fault=None) -> Window:
    """Prove back to back for ``seconds``.  ``fault(index, proof) -> Proof``,
    used only by the control and the tests, stands between the prover and
    the window's record."""
    from halo2_tpu_torch.utils import profiling

    def prove(index):
        p = prover.prove(index, tamper=getattr(fault, "tamper", False))
        return fault(index, p) if fault else p

    proofs, counted, last_end, traced = [], 0, 0.0, None
    phases_on = False
    profiling.report(reset=True)
    t0 = time.perf_counter()
    index = 0
    try:
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            if trace and index == 0:
                p, traced = _profiled(prover, index, prove)
            else:
                if trace and not phases_on:
                    os.environ["HALO2_TPU_PROFILE"] = "1"
                    phases_on = True
                p = prove(index)
            p.end_s = time.perf_counter() - t0
            p.wall_s = p.end_s - (start - t0)
            proofs.append(p)
            if p.end_s <= seconds:
                counted, last_end = counted + 1, p.end_s
            index += 1
    finally:
        if phases_on:
            os.environ.pop("HALO2_TPU_PROFILE", None)
    rows = profiling.report(reset=True)
    return Window(proofs, counted, last_end, traced,
                  {name: secs for name, _, secs in rows}, len(proofs) - 1 if trace else 0)
