"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per
source and all of them at once, and link into one shared library with a
plain C interface, loaded with ``ctypes``.  The build runs at
first use, into ``halo2_tpu_torch/_build/<hash>/``, where the hash covers the
sources and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time: the CPU tests import every module
of the package on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_SOURCES = ("mont_mul.cu", "field_ops.cu", "ntt.cu", "ec.cu", "msm.cu", "mont_mul_tiled.cu",
            "roofline.cu")
_HEADERS = ("field.cuh", "ec.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
_path = None
build_log = ""  # nvcc's output of the build this process ran ("" if it reused one)
build_seconds = 0.0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "h2_mont_mul": [_P, _P, _P, _I64, _P, _U32, _P],
    "h2_mont_mul_bcast": [_P, _P, _I64, _P, _I64, _P, _U32, _P],
    "h2_field_op": [_I64, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _P, _U32, _P],
    "h2_stockham": [_P, _P, _P, _I64, _I64, _I64, _I64, _P, _U32, _P],
    "h2_mont_pow": [_P, _P, _I64, _P, _U32, _P, _I64, _P],
    "h2_ec_add": [_P] * 9 + [_I64, _P, _U32, _U32, _P],
    "h2_ec_double": [_P] * 6 + [_I64, _P, _U32, _U32, _P],
    "h2_ec_scalar_mul": [_P] * 7 + [_I64, _P, _U32, _U32, _P, _P],
    "h2_ec_horner": [_P] * 6 + [_I64, _I64, _I64, _P, _U32, _U32, _P],
    "h2_msm_digits": [_P, _P] + [_I64] * 7 + [_P, _U32, _P],
    "h2_ec_window_table": [_P] * 4 + [_I64] * 3 + [_P, _U32, _U32, _P, _P],
    "h2_ec_window_fold": [_P] * 6 + [_I64] * 5 + [_P, _U32, _U32, _P, _P],
    "h2_mont_mul_tiled": [_P, _P, _P, ctypes.c_int64, _P, ctypes.c_uint32, _P],
    "h2_int_muladd": [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P],
    "h2_int_addmask": [_P, _P, ctypes.c_int64, ctypes.c_int, _P],
}


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", name)


def _run_all(cmds) -> tuple[list, str]:
    """Run the commands at once; (return codes, their output in order)."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT) for c, f in zip(cmds, logs)]
    rcs = [p.wait() for p in procs]
    out = ""
    for f in logs:
        f.seek(0)
        out += f.read()
        f.close()
    return rcs, out


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _path, build_log, build_seconds
    if _lib is not None:
        return _lib
    out_dir = os.path.join(_BUILD, _source_hash())
    path = os.path.join(out_dir, "libhalo2cuda.so")
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        # build under a unique name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        objs = [f"{tmp[:-3]}.{s[:-3]}.o" for s in _SOURCES]
        t0 = time.perf_counter()
        rcs, build_log = _run_all(
            [[_tool("nvcc"), *NVCC_FLAGS, "-c", "-o", o, os.path.join(_CSRC, s)]
             for s, o in zip(_SOURCES, objs)]
        )
        if not any(rcs):
            rc, link_log = _run_all([[_tool("nvcc"), "-shared", "-o", tmp, *objs]])
            rcs, build_log = rc, build_log + link_log
        build_seconds = time.perf_counter() - t0
        for o in objs:
            if os.path.exists(o):
                os.unlink(o)
        if any(rcs):
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({rcs}):\n{build_log}")
        with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
            f.write(build_log)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib, _path = lib, path
    return lib


def sass() -> str:
    """``cuobjdump -sass`` of the loaded library: the instructions the card runs."""
    library()
    proc = subprocess.run([_tool("cuobjdump"), "-sass", _path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}):\n{proc.stderr}")
    return proc.stdout


def words_arg(v: int):
    """A 256-bit integer as 8 little-endian uint32 words in host memory."""
    return (ctypes.c_uint32 * 8)(*[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)])


@functools.lru_cache(maxsize=None)
def _modulus_args(p: int):
    return words_arg(p), (-pow(p, -1, 1 << 32)) % (1 << 32)


def modulus_args(spec):
    """(p as 8 little-endian uint32 words in host memory, -p^-1 mod 2^32),
    built once per modulus: the kernels only read the words."""
    return _modulus_args(spec.p)


def modulus16_args(spec):
    """(p as 16 little-endian 16-bit limbs in host memory, -p^-1 mod 2^16)."""
    limbs = (ctypes.c_uint32 * 16)(*[(spec.p >> (16 * j)) & 0xFFFF for j in range(16)])
    return limbs, (-pow(spec.p, -1, 1 << 16)) % (1 << 16)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(what: str, *tensors) -> int:
    """Shared wrapper checks; returns n of the (16, n) operands."""
    import torch

    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{what}: all operands must lie on one CUDA device")
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: operands must be int32 limbs, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != 16 or t.shape != first.shape:
            raise ValueError(f"{what}: operands must share one (16, n) shape, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    return first.shape[1]
