"""The card's integer and tensor-core ceilings, and the field kernels against them.

    python -m halo2_tpu_torch.bench.roofline [--out PATH]

The counterpart of the JAX package's ``bench_roofline.py``, on one CUDA card.
It prints one JSON line per metric and writes a file only to ``--out``.  It
needs a CUDA device and raises without one: nothing here runs on the CPU.

Metrics, with the JAX metric each one stands for in brackets:

- ``int32_muladd_ops_per_sec`` [``vpu_u32_muladd_ops_per_sec``]: B1, ``y =
  y*x + x`` chained 2^16 times over (2048, 128) u32, counted as the JAX
  metric counts it, a multiply-add as two ops.  On the card a step is one
  IMAD: ``imad_per_sec`` is the instructions per second.
- ``imad_wide_per_sec``, ``imad_hi_per_sec``: B1's wide and high forms, one
  IMAD.WIDE.U32 or one IMAD.HI.U32 a step: the other multiplies of K1.  The
  wide chain also carries the IADD3 / IADD3.X that ptxas puts beside each
  IMAD.WIDE (24 for 16 steps), so its rate is a chain's, not an issue rate:
  costing an IMAD.WIDE at it gives an upper bound on its cost.
- ``int32_addmask_ops_per_sec`` [``vpu_u32_addmask_ops_per_sec``]: B2,
  ``y = (y + x) & 0xFFFF`` chained; its two ops are two instructions, IADD3
  and LOP3, so it is also the ALU instructions per second.
- ``mont_mul_per_sec_n2e18`` [``mont_mul_per_sec_k18``]: K1 chained 256 times
  at n = 2^18; ``mont_mul_tiled_per_sec_n2e18``: K4 the same way.  The 256
  launches are captured once as a CUDA graph and the graph is replayed, so
  the card runs them back to back, with no host gap between them.  The run
  raises unless both chains' outputs equal the plain chain.
- ``mont_mul_speed_of_light_per_sec`` [same name], ``mont_mul_fraction_of_model``
  [``mont_mul_mfu_vs_vpu_model``]: the model of ``speed_of_light``.
- ``int32_arch_peak_per_sec_est`` [``vpu_arch_peak_u32_ops_per_sec_est``]: SMs x
  64 32-bit integer lanes per clock per SM (the CUDA Programming Guide's
  throughput table, compute capability 9.0) x the maximum SM clock: the
  ceiling of one pipe, the multiply pipe (IMAD) or the ALU (IADD3, LOP3);
  ``mont_mul_instr_fraction_of_arch_peak`` [``mont_mul_ops_fraction_of_arch_peak``].
- ``tensor_core_int8_macs_per_sec`` / ``tensor_core_bf16_macs_per_sec``
  [``mxu_int8_macs_per_sec`` / ``mxu_bf16_macs_per_sec``]: ``torch._int_mm``
  and ``torch.matmul`` at 2048^3 chained 256 times, the result cast back to
  the input type each step as the JAX bench does.  These are plain products
  that the JAX package left to XLA, so they stay library calls.  The int8
  B operand is column-major, the layout of cuBLASLt's int8 tensor-core
  kernels: a row-major B takes a path about 5x slower.
- ``<kernel>_n2e22_ms``, its share of the HBM roof and two shares of the
  integer ceiling, for K1, K4, K2 and K3 at n = 2^22 (``kernel_shares``):
  ``_low`` costs every IMAD-class instruction at IMAD's rate, ``_high``
  costs IMAD.WIDE and IMAD.HI at their chains' rates; ``_binding`` names
  the pipe that binds under both, else ``unresolved`` (``int_ceiling``).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from functools import partial

import torch

from .. import _cuda
from ..curves import ec_kernels
from ..fields import limb
from ..fields.mont_mul import mont_mul, mont_mul_plain, mont_mul_tiled
from ..fields.spec import BN254_FR
from .int_chains import int_addmask_chain, int_muladd_chain

SHAPE = (2048, 128)  # the JAX bench's (8 * ROWS, LANES) block
ITERS = 1 << 16

# K1's instruction mix: mont_mul_kernel (csrc/mont_mul.cu) in the SASS of the
# library built with nvcc 12.8 -O3 for sm_90a, counted by sass_mix(): the IMAD
# class (IMAD, IMAD.WIDE, IMAD.HI and the IMAD.MOV / .SHL / .IADD forms
# that issue to the same pipe) and every other instruction, with loads,
# stores and control flow left out.  chip_smoke.py checks that the library
# it builds still gives these counts.
K1_IMAD = 298   # 135 IMAD, 121 IMAD.WIDE, 8 IMAD.HI, 33 IMAD.MOV, 1 IMAD.SHL
K1_OTHER = 305  # 241 IADD3, 24 LOP3, 23 SHF, 8 SEL, 5 ISETP and 4 others
# the JAX model's convention (bench_roofline.py): a multiply-add is two ops
MULS_PER_MONT_MUL = K1_IMAD
OPS_PER_MONT_MUL = 2 * K1_IMAD + K1_OTHER

INT32_LANES_PER_SM_CLOCK = 64
HBM_BYTES_PER_SEC = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_SEC = 1979e12         # dense, H100 SXM data sheet
BF16_FLOPS_PER_SEC = 989e12        # dense, H100 SXM data sheet
CEILING_SLACK = 1.05               # a reading above ceiling * slack is a fault

# kernel -> (SASS function, bytes moved per element)
KERNELS = {
    "mont_mul": ("mont_mul_kernel", 3 * 64),
    "mont_mul_tiled": ("mont_mul_tiled_kernel", 3 * 64),
    "ec_add": ("ec_add_kernel", 9 * 64),
    "ec_double": ("ec_double_kernel", 6 * 64),
}
# chained loop -> (SASS function, instruction classes each unrolled step holds)
LOOPS = {
    "int_muladd": ("int_muladd_kernel", ("IMAD",)),
    "int_muladd_wide": ("int_muladd_wide_kernel", ("IMAD.WIDE",)),
    "int_muladd_hi": ("int_muladd_hi_kernel", ("IMAD.HI",)),
    "int_addmask": ("int_addmask_kernel", ("IADD3", "LOP3")),
}
UNROLL = 16  # csrc/roofline.cu's #pragma unroll


def speed_of_light(muladd_ops_per_sec: float, addmask_ops_per_sec: float,
                   ops: int = OPS_PER_MONT_MUL, muls: int = MULS_PER_MONT_MUL) -> float:
    """Montgomery products per second if the issue rates alone bound them.

    The JAX bench's formula: a product needs ``muls`` multiply issue slots and
    ``ops - 2 * muls`` other ops, and takes whichever bound binds first.
    """
    mul_bound = muladd_ops_per_sec / 2 / muls
    ops_bound = addmask_ops_per_sec / (ops - 2 * muls)
    return min(mul_bound, ops_bound)


def arch_int32_per_sec(sm_count: int, max_sm_clock_mhz: float) -> float:
    """32-bit integer instructions per second per pipe: SMs x 64 lanes x clock."""
    return sm_count * INT32_LANES_PER_SM_CLOCK * max_sm_clock_mhz * 1e6


# ---------------------------------------------------------------------------
# SASS: what the card runs
# ---------------------------------------------------------------------------

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_SKIP = ("LD", "ST", "ULDC", "EXIT", "BRA", "NOP")  # memory and control flow


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` text -> {function: [(address, opcode, branch target)]}.

    The target is the address a ``BRA 0x..`` jumps to, else None.
    """
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line) if cur is not None else None
        if not m:
            continue
        addr, op, args = int(m.group(1), 16), m.group(2), m.group(3)
        hexa = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        cur.append((addr, op, int(hexa.group(1), 16) if hexa else None))
    return funcs


def kernel_sass(funcs: dict, name: str) -> list:
    """The instructions of the one function named ``name`` (plain or mangled)."""
    hits = [f for f in funcs if f == name or f"{len(name)}{name}" in f]
    if len(hits) != 1:
        raise RuntimeError(f"SASS: expected one function {name!r}, found {hits}")
    return funcs[hits[0]]


def sass_class(op: str) -> str:
    """Opcode -> class: the IMAD forms apart, else the opcode without modifiers."""
    parts = op.split(".")
    if parts[0] == "IMAD":
        for mod in ("WIDE", "HI", "MOV", "SHL", "IADD"):
            if mod in parts[1:]:
                return "IMAD." + mod
    return parts[0]


def sass_mix(instrs: list) -> dict:
    """Counts of one kernel's instructions: the IMAD class, the rest, and
    each class; loads, stores and control flow left out."""
    classes: dict = {}
    for _, op, _ in instrs:
        if not op.startswith(_SKIP):
            c = sass_class(op)
            classes[c] = classes.get(c, 0) + 1
    imad = sum(v for c, v in classes.items() if c.startswith("IMAD"))
    return {"imad": imad, "other": sum(classes.values()) - imad,
            "classes": dict(sorted(classes.items()))}


def loop_body(instrs: list) -> list:
    """The instructions of the longest loop: from a backward branch's target
    to the branch."""
    best: list = []
    for addr, _, target in instrs:
        if target is not None and target <= addr:
            body = [x for x in instrs if target <= x[0] <= addr]
            if len(body) > len(best):
                best = body
    return best


def check_loop(instrs: list, classes: tuple, unroll: int = UNROLL) -> dict:
    """Raise unless the loop survived compilation: a backward branch whose
    body holds ``unroll`` instructions of each measured class."""
    body = loop_body(instrs)
    counts = {c: sum(1 for _, op, _ in body if sass_class(op) == c) for c in classes}
    if not body or min(counts.values()) < unroll:
        raise RuntimeError(
            f"SASS: the chained loop is missing or cut ({len(body)} instructions in the "
            f"longest loop, {counts}); a rate measured on it would be impossible"
        )
    return {"body_instructions": len(body), **counts}


def sass_report(text: str) -> dict:
    """The mix of every field kernel and the loop check of every chain."""
    funcs = parse_sass(text)
    out = {k: sass_mix(kernel_sass(funcs, fn)) for k, (fn, _) in KERNELS.items()}
    for k, (fn, classes) in LOOPS.items():
        out[k] = check_loop(kernel_sass(funcs, fn), classes)
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over ``reps`` back-to-back calls, CUDA events."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_chain(step, x0: torch.Tensor, inner: int, reps: int, counted=()) -> tuple:
    """``inner`` chained calls x = step(x), captured once as a CUDA graph and
    replayed once to warm up and ``reps`` times timed: (mean milliseconds of a
    replay, the chain's output after the last replay).

    A wrapper counts its launches at capture, where the card runs nothing;
    each wrapper in ``counted`` is set back and counts the kernels of every
    replay instead, the launches the card runs.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture (cuBLAS handles)
        step(step(x0))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = [fn.launches for fn in counted]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = x0
        for _ in range(inner):
            x = step(x)
    per_replay = [fn.launches - b for fn, b in zip(counted, before)]
    for fn, b in zip(counted, before):
        fn.launches = b

    def replay():
        graph.replay()
        for fn, k in zip(counted, per_replay):
            fn.launches += k

    ms = event_ms(replay, reps)
    return ms, x.clone()


def _chain_input(device) -> torch.Tensor:
    n = SHAPE[0] * SHAPE[1]
    return torch.arange(n, dtype=torch.int64, device=device).reshape(SHAPE).to(torch.int32)


def bench_int_muladd(device, iters: int = ITERS, reps: int = 3, form: str = "lo") -> float:
    """B1 steps per second (one IMAD, IMAD.WIDE.U32 or IMAD.HI.U32 a step)."""
    x = _chain_input(device) | 1
    ms = event_ms(lambda: int_muladd_chain(x, iters, form), reps)
    return x.numel() * iters / (ms * 1e-3)


def bench_int_addmask(device, iters: int = ITERS, reps: int = 3) -> float:
    """B2 steps per second (IADD3 + LOP3 a step)."""
    x = _chain_input(device)
    ms = event_ms(lambda: int_addmask_chain(x, iters), reps)
    return x.numel() * iters / (ms * 1e-3)


def _field_operand(n: int, device) -> torch.Tensor:
    """The JAX bench's operand: (i*7 + 3) mod p for i < 4096, tiled to n."""
    spec = BN254_FR
    a = limb.from_ints(spec, [(i * 7 + 3) % spec.p for i in range(4096)], device)
    return a.repeat(1, n // 4096).contiguous()


def check_mont_chain(out: torch.Tensor, a: torch.Tensor, inner: int) -> None:
    """Raise unless ``out`` is ``inner`` chained products acc = acc * a from
    acc = a.  The operand repeats every 4096 columns, so the output must too,
    and its first 4096 columns must equal the plain chain's."""
    period = out[:, :4096]
    if not bool((out.view(16, -1, 4096) == period[:, None]).all()):
        raise RuntimeError("chained Montgomery product: the output does not repeat as its operand")
    a0 = a[:, :4096]
    acc = a0
    for _ in range(inner):
        acc = mont_mul_plain(BN254_FR, acc, a0)
    if not torch.equal(period, acc):
        raise RuntimeError("chained Montgomery product: the output differs from the plain chain")


def bench_mont_mul(fn, device, n: int = 1 << 18, inner: int = 256, reps: int = 3) -> tuple:
    """(Montgomery products per second, chain output) of ``fn`` (K1 or K4)
    chained ``inner`` times; raises if the output differs from the plain chain."""
    a = _field_operand(n, device)
    ms, out = graph_chain(lambda acc: fn(BN254_FR, acc, a), a, inner, reps, counted=(fn,))
    check_mont_chain(out, a, inner)
    return n * inner / (ms * 1e-3), out


def bench_tensor_core(device, dtype: str, m: int = 2048, inner: int = 256, reps: int = 3) -> float:
    """MACs per second of an m^3 product chained ``inner`` times."""
    if dtype == "int8":
        b = torch.ones((m, m), dtype=torch.int8, device=device).t().contiguous().t()
        x0 = torch.ones((m, m), dtype=torch.int32, device=device)
        step = lambda acc: torch._int_mm(acc.to(torch.int8), b)  # noqa: E731
    else:
        b = torch.ones((m, m), dtype=torch.bfloat16, device=device)
        x0 = torch.ones((m, m), dtype=torch.float32, device=device)
        step = lambda acc: torch.matmul(acc.to(torch.bfloat16), b)  # noqa: E731
    ms, _ = graph_chain(step, x0, inner, reps)
    return m ** 3 * inner / (ms * 1e-3)


def _random_limbs(shape, device, gen) -> torch.Tensor:
    """Limbs below p for every supported field (top limb < 0x3000): the
    kernels' work does not depend on the values."""
    t = torch.randint(0, 1 << 16, shape, dtype=torch.int32, device=device, generator=gen)
    t[15] &= 0x2FFF
    return t


def share_operands(device, n: int = 1 << 22) -> dict:
    """What ``kernel_shares`` times at width n, from a fixed seed: name ->
    (kernel, plain version, operands), each called as ``f(*operands)``."""
    from ..curves.spec import BN254_G1

    gen = torch.Generator(device=device).manual_seed(0)
    a, b = (_random_limbs((16, n), device, gen) for _ in range(2))
    p, q = (tuple(_random_limbs((16, n), device, gen) for _ in range(3)) for _ in range(2))
    fr, g1 = BN254_FR, BN254_G1
    return {
        "mont_mul": (partial(mont_mul, fr), partial(mont_mul_plain, fr), (a, b)),
        "mont_mul_tiled": (partial(mont_mul_tiled, fr), partial(mont_mul_plain, fr), (a, b)),
        "ec_add": (partial(ec_kernels.ec_add, g1), partial(ec_kernels.ec_add_plain, g1), (p, q)),
        "ec_double": (partial(ec_kernels.ec_double, g1), partial(ec_kernels.ec_double_plain, g1),
                      (p,)),
    }


def int_ceiling(mix: dict, rates: dict) -> dict:
    """Seconds per element of one kernel if integer issue alone bound it,
    from its SASS mix: the larger of its multiply-pipe time and its ALU time
    (the non-IMAD instructions at B2's rate).

    The multiply-pipe time has two bounds.  ``low`` costs every IMAD-class
    instruction at IMAD's rate.  ``high`` costs IMAD.WIDE and IMAD.HI at the
    rates of B1's wide and high chains, which also issue the chain's other
    instructions, so it overstates their cost.  ``binding`` is the pipe that
    binds under both bounds, or ``unresolved`` where they disagree.
    """
    wide, high = mix["classes"].get("IMAD.WIDE", 0), mix["classes"].get("IMAD.HI", 0)
    mul_low = mix["imad"] / rates["imad"]
    mul_high = ((mix["imad"] - wide - high) / rates["imad"]
                + wide / rates["imad_wide"] + high / rates["imad_hi"])
    alu = mix["other"] / rates["alu"]
    binding = "alu" if alu >= mul_high else "multiply" if mul_low > alu else "unresolved"
    return {"low": max(mul_low, alu), "high": max(mul_high, alu), "binding": binding}


def kernel_shares(device, mix: dict, rates: dict, n: int = 1 << 22, reps: int = 20) -> dict:
    """K1, K4, K2 and K3 at width n: time, the two shares of the integer
    ceiling (``int_ceiling``), its binding pipe, and the share of the HBM roof."""
    out = {}
    for name, (fn, _, args) in share_operands(device, n).items():
        ms = event_ms(lambda: fn(*args), reps)
        ceil = int_ceiling(mix[name], rates)
        hbm_ms = n * KERNELS[name][1] / HBM_BYTES_PER_SEC * 1e3
        out[name] = {"ms": ms, "int_ceiling_share_low": n * ceil["low"] * 1e3 / ms,
                     "int_ceiling_share_high": n * ceil["high"] * 1e3 / ms,
                     "binding": ceil["binding"], "hbm_share": hbm_ms / ms}
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def check_ceilings(metrics: dict) -> None:
    """Raise on a reading above its ceiling: an elided loop or a wrong count."""
    arch = metrics["int32_arch_peak_per_sec_est"]["value"]
    limits = {
        "imad_per_sec": arch,
        "imad_wide_per_sec": arch,
        "imad_hi_per_sec": arch,
        "int32_addmask_ops_per_sec": arch,
        "tensor_core_int8_macs_per_sec": INT8_OPS_PER_SEC / 2,
        "tensor_core_bf16_macs_per_sec": BF16_FLOPS_PER_SEC / 2,
    }
    for name, limit in limits.items():
        v = metrics[name]["value"]
        if v > CEILING_SLACK * limit:
            raise RuntimeError(f"{name} = {v:.4g} reads above {CEILING_SLACK:.0%} of its "
                               f"ceiling {limit:.4g}")


def run(emit=print) -> dict:
    """Measure every metric on the current CUDA device; emit one JSON line each."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline needs a CUDA device; torch.cuda.is_available() is False")
    dev = torch.device("cuda", torch.cuda.current_device())
    props = torch.cuda.get_device_properties(dev)
    device = {"name": torch.cuda.get_device_name(dev), "sm_count": props.multi_processor_count,
              "max_sm_clock_mhz": float(_smi("clocks.max.sm")),
              "power_limit_w": _smi("power.limit")}
    _cuda.library()
    sass = sass_report(_cuda.sass())
    metrics: dict = {}

    def put(name, value, unit, jax_name=None):
        metrics[name] = {"value": value, "unit": unit, "jax_name": jax_name}
        emit(json.dumps({"metric": name, "value": value, "unit": unit, "jax_name": jax_name}))

    imad = bench_int_muladd(dev)
    put("int32_muladd_ops_per_sec", 2 * imad, "u32 ops/s (a multiply-add counted as 2)",
        "vpu_u32_muladd_ops_per_sec")
    put("imad_per_sec", imad, "IMAD instructions/s (lanes)")
    wide = bench_int_muladd(dev, form="wide")
    put("imad_wide_per_sec", wide, "IMAD.WIDE.U32 instructions/s (lanes)")
    high = bench_int_muladd(dev, form="hi")
    put("imad_hi_per_sec", high, "IMAD.HI.U32 instructions/s (lanes)")
    alu = 2 * bench_int_addmask(dev)
    put("int32_addmask_ops_per_sec", alu, "u32 ops/s = IADD3 + LOP3 instructions/s",
        "vpu_u32_addmask_ops_per_sec")
    fmuls, k1_chain = bench_mont_mul(mont_mul, dev)
    put("mont_mul_per_sec_n2e18", fmuls, "field muls/s (K1, n=2^18, 256 chained)",
        "mont_mul_per_sec_k18")
    k4_muls, k4_chain = bench_mont_mul(mont_mul_tiled, dev)
    put("mont_mul_tiled_per_sec_n2e18", k4_muls, "field muls/s (K4, n=2^18, 256 chained)")
    if not torch.equal(k1_chain, k4_chain):
        raise RuntimeError("the K1 and K4 chains differ")
    sol = speed_of_light(2 * imad, alu, OPS_PER_MONT_MUL, MULS_PER_MONT_MUL)
    put("mont_mul_speed_of_light_per_sec", sol, "field muls/s (K1 SASS mix at B1/B2 rates)",
        "mont_mul_speed_of_light_per_sec")
    put("mont_mul_fraction_of_model", fmuls / sol, "fraction", "mont_mul_mfu_vs_vpu_model")
    arch = arch_int32_per_sec(device["sm_count"], device["max_sm_clock_mhz"])
    put("int32_arch_peak_per_sec_est", arch, "32-bit integer instructions/s per pipe (estimate)",
        "vpu_arch_peak_u32_ops_per_sec_est")
    put("mont_mul_instr_fraction_of_arch_peak", fmuls * (K1_IMAD + K1_OTHER) / arch, "fraction",
        "mont_mul_ops_fraction_of_arch_peak")
    rates = {"imad": imad, "imad_wide": wide, "imad_hi": high, "alu": alu}
    for name, r in kernel_shares(dev, sass, rates).items():
        put(f"{name}_n2e22_ms", r["ms"], "ms per launch (CUDA events)")
        put(f"{name}_n2e22_int_ceiling_share_low", r["int_ceiling_share_low"],
            "fraction (every IMAD-class instruction at IMAD's rate)")
        put(f"{name}_n2e22_int_ceiling_share_high", r["int_ceiling_share_high"],
            "fraction (IMAD.WIDE, IMAD.HI at their chains' rates: an upper bound)")
        put(f"{name}_n2e22_binding", r["binding"], "pipe that binds under both bounds")
        put(f"{name}_n2e22_hbm_share", r["hbm_share"], "fraction of 3.35 TB/s")
    put("tensor_core_int8_macs_per_sec", bench_tensor_core(dev, "int8"), "int8 MACs/s",
        "mxu_int8_macs_per_sec")
    put("tensor_core_bf16_macs_per_sec", bench_tensor_core(dev, "bf16"), "bf16 MACs/s",
        "mxu_bf16_macs_per_sec")
    check_ceilings(metrics)
    return {"device": device, "metrics": metrics, "sass": sass,
            "model": {"k1_imad": K1_IMAD, "k1_other": K1_OTHER,
                      "ops_per_mont_mul": OPS_PER_MONT_MUL, "muls_per_mont_mul": MULS_PER_MONT_MUL}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every result as one JSON file here")
    args = ap.parse_args(argv)
    results = run()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
