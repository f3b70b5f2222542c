"""The port's tracing (``utils/profiling.py``) over one BenchPlonk proof at
k=4 on the CPU, proved four ways on the same seeds:

- with tracing off, the default: no ``synchronize`` (counted with
  ``torch.cuda`` made to look present), no ``record_function`` range and
  nothing in the report;
- with ``HALO2_TPU_PROFILE=1``: the fenced timers, the shape pass of the
  floor planner (``synthesis: region shapes``) more than 0 and less than the
  synthesis around it;
- under an operator's ``torch.profiler``, with nothing swapped: a
  ``user_annotation`` for every phase the timers report, the new spans
  included, and no ``synchronize``;
- under ``profiling.device_trace``: its trace file holds the same spans, one
  ``limb: device to host`` span per ``limb.to_ints`` call.

The proof bytes are the same every way.  The pinned proof of the
tests/plonk_api.rs circuit (a lookup and an instance column, two circuits in
one proof) shows the instance block's span once and the lookup's host
matching once per lookup and circuit, under the profiler and the timers,
with the pinned bytes.  On the CPU the plain MSM and power
chains are hundreds of thousands of tiny torch ops, which the profiler would
record and export for minutes, so the profiled proofs pause its CPU
collection inside them (``toggle_collection_dynamic``); every span opens
outside them.
"""

import gzip
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.circuit.layouter import SHAPE_PHASE
from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.fields.spec import BN254_FR
from halo2_tpu_torch.plonk import create_proof, keygen_pk, keygen_vk
from halo2_tpu_torch.poly import kzg
from halo2_tpu_torch.poly.kzg import ParamsKZG
from halo2_tpu_torch.poly.multiopen_gwc import gwc_create_proof
from halo2_tpu_torch.transcript import Blake2bTranscript
from halo2_tpu_torch.utils import profiling

from torch_circuits import BenchPlonkCircuit, StandardPlonkCircuit, V1Simple, plonk_api_common

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

SPEC = BN254_G1.scalar
K = 4
NEW_SPANS = {"vanishing: random poly", "commit: msm", "limb: device to host"}


@pytest.fixture(scope="module")
def keys():
    params = ParamsKZG.setup(K, seed=b"tracing", device="cpu")
    blank = BenchPlonkCircuit(K, Value.unknown())
    vk = keygen_vk(params, blank)
    return params, keygen_pk(params, vk, blank)


def prove(keys):
    from halo2_tpu_torch.utils.rng import FieldRng

    params, pk = keys
    return create_proof(params, pk, [BenchPlonkCircuit(K, Value.known(0x5EED))], [[]],
                        FieldRng(SPEC, b"tracing-rng"), Blake2bTranscript(BN254_G1),
                        gwc_create_proof)


class Counts:
    """Counts ``torch.cuda.synchronize`` and ``record_function`` calls, with
    ``torch.cuda`` made to look present and initialised."""

    def __init__(self, mp):
        self.syncs = self.ranges = 0
        record_function = torch.profiler.record_function

        def counted_range(name):
            self.ranges += 1
            return record_function(name)

        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "is_initialized", lambda: True)
        mp.setattr(torch.cuda, "synchronize", self.sync)
        mp.setattr(torch.profiler, "record_function", counted_range)

    def sync(self, device=None):
        self.syncs += 1


def run(keys, timers: bool):
    with pytest.MonkeyPatch.context() as mp:
        if timers:
            mp.setenv("HALO2_TPU_PROFILE", "1")
        else:
            mp.delenv("HALO2_TPU_PROFILE", raising=False)
        profiling.report(reset=True)
        counts = Counts(mp)
        proof = prove(keys)
        return {"proof": proof, "syncs": counts.syncs, "ranges": counts.ranges,
                "report": {name: secs for name, _, secs in profiling.report(reset=True)}}


@pytest.fixture(scope="module")
def off(keys):
    return run(keys, timers=False)


@pytest.fixture(scope="module")
def timed(keys):
    return run(keys, timers=True)


def quiet(prof, fn):
    """``fn`` with the profiler's CPU collection paused while it runs."""

    def wrapper(*args, **kwargs):
        prof.toggle_collection_dynamic(False, [ProfilerActivity.CPU])
        try:
            return fn(*args, **kwargs)
        finally:
            prof.toggle_collection_dynamic(True, [ProfilerActivity.CPU])

    return wrapper


def profiled_proof(keys, prof, mp):
    mp.setattr(kzg, "msm_many", quiet(prof, kzg.msm_many))
    mp.setattr(limb, "mont_pow", quiet(prof, limb.mont_pow))
    return prove(keys)


def annotations(events) -> list:
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


@pytest.fixture(scope="module")
def operator(keys, tmp_path_factory):
    """A proof under ``torch.profiler.profile`` opened by the caller."""
    path = str(tmp_path_factory.mktemp("operator") / "trace.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HALO2_TPU_PROFILE", raising=False)
        profiling.report(reset=True)
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
            with pytest.MonkeyPatch.context() as inner:
                counts = Counts(inner)
                proof = profiled_proof(keys, prof, inner)
        prof.export_chrome_trace(path)
        report = profiling.report(reset=True)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {"proof": proof, "syncs": counts.syncs, "report": report, "events": events}


@pytest.fixture(scope="module")
def device_traced(keys, tmp_path_factory):
    """A proof under ``profiling.device_trace``, with ``limb.to_ints``'s calls
    counted."""
    logdir = tmp_path_factory.mktemp("device_trace")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HALO2_TPU_PROFILE", raising=False)
        to_ints = limb.to_ints

        def counted(spec, a):
            calls.append(a.shape)
            return to_ints(spec, a)

        mp.setattr(limb, "to_ints", counted)
        with profiling.device_trace(str(logdir)) as prof:
            proof = profiled_proof(keys, prof, mp)
    with gzip.open(logdir / profiling.TRACE_FILE, "rt") as f:
        events = json.load(f)["traceEvents"]
    return {"proof": proof, "events": events, "to_ints": len(calls),
            "files": sorted(os.listdir(logdir))}


def test_tracing_off_runs_no_synchronize_and_records_nothing(off):
    assert off["syncs"] == 0 and off["ranges"] == 0
    assert off["report"] == {}


def test_timers_time_the_shape_pass_inside_synthesis(timed):
    report = timed["report"]
    assert 0 < report[SHAPE_PHASE] < report["witness synthesis (host)"]
    assert NEW_SPANS <= set(report)
    assert timed["syncs"] > 0 and timed["ranges"] == 0  # fenced, and no range


def test_operators_profiler_sees_every_phase(operator, timed):
    """No harness swaps ``profiling.phase``: the spans are the program's own,
    with the timers' names, and none of them synchronizes."""
    names = set(annotations(operator["events"]))
    assert names == set(timed["report"]) - {SHAPE_PHASE}
    assert NEW_SPANS <= names
    assert operator["syncs"] == 0 and operator["report"] == []


def test_device_trace_writes_the_programs_spans(device_traced, timed):
    assert device_traced["files"] == [profiling.TRACE_FILE]
    names = annotations(device_traced["events"])
    assert set(names) == set(timed["report"]) - {SHAPE_PHASE}
    assert names.count("vanishing: random poly") == 1


def test_one_device_to_host_span_per_pull(device_traced):
    names = annotations(device_traced["events"])
    assert device_traced["to_ints"] > 0
    assert names.count("limb: device to host") == device_traced["to_ints"]


@pytest.mark.parametrize("way", ["timed", "operator", "device_traced"])
def test_proof_bytes_do_not_depend_on_tracing(way, request, off):
    assert request.getfixturevalue(way)["proof"] == off["proof"]


def test_v1_floor_planner_times_its_measuring_pass(monkeypatch):
    p = BN254_FR.p
    monkeypatch.setenv("HALO2_TPU_PROFILE", "1")
    profiling.report(reset=True)
    MockProver.run(BN254_FR, 4, V1Simple(7, Value.known(5)), [[7 * pow(5, 4, p) % p]],
                   device="cpu")
    rows = {name: (calls, secs) for name, calls, secs in profiling.report(reset=True)}
    assert rows[SHAPE_PHASE][0] == 1 and rows[SHAPE_PHASE][1] > 0


def test_phase_reads_its_state_at_each_call(monkeypatch):
    monkeypatch.delenv("HALO2_TPU_PROFILE", raising=False)
    profiling.report(reset=True)
    with profiling.phase("off"):
        pass
    monkeypatch.setenv("HALO2_TPU_PROFILE", "1")
    with profiling.phase("on"):
        pass
    profiling.add("added", 0.25)
    profiling.add("added", 0.5)
    rows = {name: (calls, secs) for name, calls, secs in profiling.report(reset=True)}
    assert set(rows) == {"on", "added"} and rows["added"] == (2, 0.75)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.phase("under the profiler"):
            torch.ones(4).sum()
    assert profiling.report(reset=True) == []  # a range, not a timer
    assert "under the profiler" in {e.key for e in prof.key_averages()}



# -- the instance and lookup spans, over the pinned lookup proof ---------------

LOOKUP_SPANS = ("instance: hash + interpolate", "lookup: host matching")
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def lookup_proofs(tmp_path_factory):
    """The tests/plonk_api.rs circuit at k=5 over GWC, as
    ``tests/data/plonk_api_gwc_k5.hex`` pins it: two circuits of one lookup
    and one instance column each in one proof, proved under an operator's
    ``torch.profiler`` and with the timers."""
    from halo2_tpu_torch.utils.rng import FieldRng

    k = 5
    a, instance, table = plonk_api_common(SPEC)
    params = ParamsKZG.setup_host(k, seed=b"plonk-api", device="cpu")
    blank = StandardPlonkCircuit(Value.unknown(), table)
    vk = keygen_vk(params, blank)
    pk = keygen_pk(params, vk, blank)
    circuit = StandardPlonkCircuit(Value.known(a), table)

    def prove_pinned():
        return create_proof(params, pk, [circuit, circuit], [[[instance]], [[instance]]],
                            FieldRng(SPEC, b"gwc-rng"), Blake2bTranscript(BN254_G1),
                            gwc_create_proof)

    out = {"lookups": 2 * len(vk.cs.lookups)}
    path = str(tmp_path_factory.mktemp("lookup") / "trace.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HALO2_TPU_PROFILE", raising=False)
        with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
            mp.setattr(kzg, "msm_many", quiet(prof, kzg.msm_many))
            mp.setattr(limb, "mont_pow", quiet(prof, limb.mont_pow))
            out["profiled"] = prove_pinned()
        prof.export_chrome_trace(path)
    with open(path) as f:
        out["names"] = annotations(json.load(f)["traceEvents"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HALO2_TPU_PROFILE", "1")
        profiling.report(reset=True)
        out["timed"] = prove_pinned()
        out["report"] = {name: (calls, secs) for name, calls, secs in profiling.report(reset=True)}
    with open(os.path.join(HERE, "data", "plonk_api_gwc_k5.hex")) as f:
        out["pin"] = bytes.fromhex(f.read().strip())
    return out


def test_profiler_sees_the_instance_span_and_one_matching_per_lookup(lookup_proofs):
    names = lookup_proofs["names"]
    assert lookup_proofs["lookups"] == 2
    assert names.count("instance: hash + interpolate") == 1
    assert names.count("lookup: host matching") == lookup_proofs["lookups"]
    assert names.count("lookup: compress + permute") == lookup_proofs["lookups"]


def test_timers_report_the_instance_span_and_the_matching(lookup_proofs):
    report = lookup_proofs["report"]
    assert set(LOOKUP_SPANS) <= set(report)
    assert report["instance: hash + interpolate"][0] == 1
    calls, secs = report["lookup: host matching"]
    assert calls == lookup_proofs["lookups"]
    assert 0 < secs <= report["lookup: compress + permute"][1]


@pytest.mark.parametrize("way", ["profiled", "timed"])
def test_lookup_proof_bytes_equal_the_pin(lookup_proofs, way):
    assert lookup_proofs[way] == lookup_proofs["pin"]
