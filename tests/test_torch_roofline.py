"""The port's roofline (halo2_tpu_torch.bench) against the JAX bench, on the CPU.

- B1 / B2's plain versions against the bodies of the JAX kernels
  (bench_roofline.py ``bench_vpu_mul`` and ``bench_vpu_add``, written here as
  the same ``jax.lax.fori_loop`` on ``jnp.uint32``), and B1's wide and high
  forms against numpy's wrapping uint64 arithmetic: exact.
- The speed-of-light model against the JAX formula, read from
  bench_roofline.py itself and evaluated on the same fixed rates.
- The SASS reader on a fixed listing, and the refusals of a run without a
  card.  The kernels themselves run only on a card (test_torch_kernels.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from halo2_tpu_torch.bench import int_chains as ic
from halo2_tpu_torch.bench import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M32 = np.uint64(0xFFFFFFFF)


def _x(shape=(16, 128)) -> np.ndarray:
    x = np.random.default_rng(3).integers(0, 1 << 32, size=shape, dtype=np.uint64)
    x = x.astype(np.uint32)
    x.reshape(-1)[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return x


def _torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int32))


def _jax_muladd(x, iters):  # bench_roofline.py:64-67
    x = jnp.asarray(x)
    return jax.lax.fori_loop(0, iters, lambda _, y: y * x + x, x)


def _jax_addmask(x, iters):  # bench_roofline.py:96-99
    mask = np.uint32(0xFFFF)
    x = jnp.asarray(x)
    return jax.lax.fori_loop(0, iters, lambda _, y: (y + x) & mask, x)


@pytest.mark.parametrize("iters", [1, 7, 64])
@pytest.mark.parametrize("chain", ["muladd", "addmask"])
def test_chain_plain_matches_jax_kernel_body(chain, iters):
    x = _x()
    if chain == "muladd":
        want, got = _jax_muladd(x, iters), ic.int_muladd_chain(_torch(x), iters)
    else:
        want, got = _jax_addmask(x, iters), ic.int_addmask_chain(_torch(x), iters)
    assert np.asarray(want).dtype == np.uint32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("iters", [1, 7, 64])
@pytest.mark.parametrize("form", ["wide", "hi"])
def test_muladd_wide_and_high_forms_match_numpy(form, iters):
    x = _x()
    x64 = x.astype(np.uint64)
    if form == "wide":
        s = x64.copy()
        for _ in range(iters):
            s = (s & M32) * x64 + s
        want = ((s & M32) ^ (s >> np.uint64(32))).astype(np.uint32)
    else:
        want = x.copy()
        for _ in range(iters):
            want = ((want.astype(np.uint64) * x64) >> np.uint64(32)).astype(np.uint32) + x
    got = ic.int_muladd_chain(_torch(x), iters, form)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_chain_wrappers_refuse_bad_operands():
    x = _torch(_x())
    assert torch.equal(ic.int_muladd_chain(x, 0), x)  # zero steps: y = x
    with pytest.raises(ValueError, match="form"):
        ic.int_muladd_plain(x, 1, "wider")
    for fn in (ic.int_muladd_chain, ic.int_addmask_chain):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x.to("meta"), 1)


def _jax_speed_of_light(vpu_mul, vpu_add, ops, muls):
    """bench_roofline.py's model lines, executed as written there."""
    with open(os.path.join(REPO, "bench_roofline.py")) as f:
        lines = [ln.strip() for ln in f if ln.strip().startswith(("mul_bound =", "ops_bound =", "sol ="))]
    assert len(lines) == 3
    env = {"vpu_mul": vpu_mul, "vpu_add": vpu_add, "OPS_PER_MONT_MUL": ops,
           "MULS_PER_MONT_MUL": muls}
    exec("\n".join(lines), env)
    return env["sol"]


@pytest.mark.parametrize("rates", [(3.2e13, 1.57e13), (6.6e11, 6.6e11), (1e13, 4e12)])
def test_speed_of_light_matches_jax_formula(rates):
    for ops, muls in ((roofline.OPS_PER_MONT_MUL, roofline.MULS_PER_MONT_MUL), (2736, 528)):
        assert roofline.speed_of_light(*rates, ops, muls) == _jax_speed_of_light(*rates, ops, muls)
    assert roofline.OPS_PER_MONT_MUL == 2 * roofline.K1_IMAD + roofline.K1_OTHER
    assert roofline.speed_of_light(*rates) == roofline.speed_of_light(
        *rates, roofline.OPS_PER_MONT_MUL, roofline.MULS_PER_MONT_MUL)


def test_arch_estimate_is_sms_times_lanes_times_clock():
    assert roofline.arch_int32_per_sec(132, 1980.0) == 132 * 64 * 1980e6


# A cuobjdump -sass listing cut to its shape: one kernel with a loop, one
# with a forward branch and no loop; each ends in its self-branch.
_SASS = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _ZN44_GLOBAL__N__f6ee3a34_11_roofline_cu_faf72c0517int_muladd_kernelEPKiPili
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_CTAID.X ;
        /*0020*/              @!P0 BRA 0x80 ;
        /*0030*/                   IMAD R3, R3, R2, R2 ;
        /*0040*/                   IMAD R3, R3, R2, R2 ;
        /*0050*/                   VIADD R5, R5, 0x2 ;
        /*0060*/                   ISETP.NE.AND P1, PT, R5, R6, PT ;
        /*0070*/               @P1 BRA 0x30 ;
        /*0080*/                   STG.E desc[UR4][R2.64], R3 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
		Function : _ZN44_GLOBAL__N__8a273cec_11_mont_mul_cu_8dec5c3715mont_mul_kernelEPKiS1_PilN2h27ModulusE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.WIDE.U32 R4, R2, R3, R4 ;
        /*0020*/                   IMAD.HI.U32 R6, R2, R3, RZ ;
        /*0030*/                   IMAD.MOV.U32 R7, RZ, RZ, R6 ;
        /*0040*/                   IADD3 R8, P0, R4, R7, RZ ;
        /*0050*/                   IADD3.X R9, R5, RZ, RZ, P0, !PT ;
        /*0060*/                   LOP3.LUT R9, R9, 0xffff, RZ, 0xc0, !PT ;
        /*0070*/              @!P0 BRA 0xa0 ;
        /*0080*/                   STG.E desc[UR4][R2.64], R9 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
"""


def test_sass_reader_counts_the_mix_and_finds_the_loop():
    funcs = roofline.parse_sass(_SASS)
    k1 = roofline.kernel_sass(funcs, "mont_mul_kernel")
    mix = roofline.sass_mix(k1)
    assert (mix["imad"], mix["other"]) == (3, 3)
    assert mix["classes"] == {"IADD3": 2, "IMAD.HI": 1, "IMAD.MOV": 1, "IMAD.WIDE": 1, "LOP3": 1}
    assert roofline.loop_body(k1) == [(0xA0, "BRA", 0xA0)]  # the trailing self-branch only
    b1 = roofline.kernel_sass(funcs, "int_muladd_kernel")
    assert [op for _, op, _ in roofline.loop_body(b1)] == ["IMAD", "IMAD", "VIADD", "ISETP.NE.AND", "BRA"]
    assert roofline.check_loop(b1, ("IMAD",), unroll=2) == {"body_instructions": 5, "IMAD": 2}
    with pytest.raises(RuntimeError, match="loop"):
        roofline.check_loop(b1, ("IMAD",), unroll=16)
    with pytest.raises(RuntimeError, match="loop"):
        roofline.check_loop(k1, ("IADD3", "LOP3"), unroll=1)
    with pytest.raises(RuntimeError, match="expected one function"):
        roofline.kernel_sass(funcs, "mont_mul_tiled_kernel")


_RATES = {"imad": 1.57e13, "imad_wide": 5.44e12, "imad_hi": 7.58e12, "alu": 1.55e13}


@pytest.mark.parametrize("mix, binding", [
    ({"imad": 100, "other": 300, "classes": {"IMAD": 100}}, "alu"),
    ({"imad": 300, "other": 100, "classes": {"IMAD": 300}}, "multiply"),
    ({"imad": 3269, "other": 4967, "classes": {"IMAD.WIDE": 1442, "IMAD": 1827}}, "unresolved"),
])
def test_int_ceiling_bounds_and_binding_pipe(mix, binding):
    got = roofline.int_ceiling(mix, _RATES)
    wide = mix["classes"].get("IMAD.WIDE", 0)
    mul_low = mix["imad"] / _RATES["imad"]
    mul_high = (mix["imad"] - wide) / _RATES["imad"] + wide / _RATES["imad_wide"]
    alu = mix["other"] / _RATES["alu"]
    assert got == {"low": max(mul_low, alu), "high": max(mul_high, alu), "binding": binding}
    assert got["low"] <= got["high"]


def test_mont_chain_check_takes_the_plain_chain_and_refuses_a_wrong_one():
    a = roofline._field_operand(2 * 4096, "cpu")
    acc = a
    for _ in range(3):
        acc = roofline.mont_mul_plain(roofline.BN254_FR, acc, a)
    roofline.check_mont_chain(acc, a, 3)
    with pytest.raises(RuntimeError, match="plain chain"):
        roofline.check_mont_chain(acc, a, 2)
    bad = acc.clone()
    bad[0, 4096 + 7] ^= 1
    with pytest.raises(RuntimeError, match="repeat"):
        roofline.check_mont_chain(bad, a, 3)


def test_ceilings_refuse_an_impossible_reading():
    arch = roofline.arch_int32_per_sec(132, 1980.0)
    metrics = {k: {"value": v} for k, v in {
        "int32_arch_peak_per_sec_est": arch, "imad_per_sec": 0.95 * arch,
        "imad_wide_per_sec": 0.35 * arch, "imad_hi_per_sec": 0.45 * arch,
        "int32_addmask_ops_per_sec": 0.94 * arch,
        "tensor_core_int8_macs_per_sec": 0.3 * roofline.INT8_OPS_PER_SEC,
        "tensor_core_bf16_macs_per_sec": 0.3 * roofline.BF16_FLOPS_PER_SEC}.items()}
    roofline.check_ceilings(metrics)
    metrics["int32_addmask_ops_per_sec"]["value"] = 1.6 * arch  # IMAD.IADD + LOP3: two pipes
    with pytest.raises(RuntimeError, match="int32_addmask_ops_per_sec"):
        roofline.check_ceilings(metrics)


def test_roofline_without_a_card_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline.main(["--out", str(tmp_path / "roofline.json")])
    assert list(tmp_path.iterdir()) == []
