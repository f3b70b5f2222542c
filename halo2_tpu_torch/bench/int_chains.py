"""B1 / B2: chained integer loops that measure the card's issue rates.

``int_muladd_chain`` (B1) and ``int_addmask_chain`` (B2) wrap the CUDA
kernels of ``csrc/roofline.cu``, which replace the Pallas kernels of
``bench_roofline.py`` ``bench_vpu_mul`` (``y = y*x + x``) and
``bench_vpu_add`` (``y = (y + x) & 0xFFFF``), each chained ``iters`` times
from ``y = x``.  B1 has two more forms, the other multiplies of K1's CIOS
loop: ``form="wide"``, ``s = lo32(s) * x + s mod 2^64`` from ``s = x`` with
output ``lo32(s) ^ hi32(s)`` (IMAD.WIDE.U32), and ``form="hi"``, ``y =
hi32(y * x) + x mod 2^32`` (IMAD.HI.U32).

The data are u32 bit patterns held in int32 tensors of any shape.  A tensor
on the CPU takes the plain torch versions below; a CUDA tensor launches the
kernel or raises.  CPU torch has no uint32 add or shift, and an int64
product of two 32-bit values can pass 2^63, so the plain versions hold every
value in int64 in [0, 2^32) and split the multiplier x into 16-bit halves:
``y * x = y*x_lo + (y*x_hi) * 2^16``, whose halves are taken from terms
below 2^49.  Every step is exact.
"""

from __future__ import annotations

import torch

from .. import _cuda

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
FORMS = {"lo": 0, "wide": 1, "hi": 2}  # B1's forms, as the C interface numbers them


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values in int64."""
    return x.to(torch.int64) & _M32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> int32 bit patterns."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _form(what: str, form: str) -> int:
    if form not in FORMS:
        raise ValueError(f"{what}: form must be one of {list(FORMS)}, got {form!r}")
    return FORMS[form]


def int_muladd_plain(x: torch.Tensor, iters: int, form: str = "lo") -> torch.Tensor:
    """B1 in plain torch ops (int64), any device."""
    _form("int_muladd_plain", form)
    xv = _u32(x)
    xl, xh = xv & _M16, xv >> 16
    y, hi = xv, torch.zeros_like(xv)
    for _ in range(iters):
        # y * x = mid + (b >> 16) * 2^32, both terms below 2^49
        b = y * xh
        mid = y * xl + ((b & _M16) << 16)
        if form == "lo":
            y = (mid + xv) & _M32
        elif form == "hi":
            y = ((mid >> 32) + (b >> 16) + xv) & _M32
        else:  # (hi:y) += y * x
            s = (mid & _M32) + y
            hi = ((mid >> 32) + (b >> 16) + hi + (s >> 32)) & _M32
            y = s & _M32
    return _i32(y ^ hi)


def int_addmask_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """B2 in plain torch ops (int64), any device."""
    xv = _u32(x)
    y = xv
    for _ in range(iters):
        y = (y + xv) & _M16
    return _i32(y)


def _check(what: str, x: torch.Tensor, iters: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: the operand must lie on a CUDA device")
    if x.dtype != torch.int32:
        raise ValueError(f"{what}: the operand must be int32 (u32 bit patterns), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the operand must be contiguous")
    if not 0 <= iters < 1 << 31:
        raise ValueError(f"{what}: iters must lie in [0, 2^31), got {iters}")


def int_muladd_chain(x: torch.Tensor, iters: int, form: str = "lo") -> torch.Tensor:
    """B1: ``y = y*x + x`` (or its wide or high form) chained ``iters`` times."""
    if x.device.type == "cpu":
        return int_muladd_plain(x, iters, form)
    _check("int_muladd_chain", x, iters)
    code = _form("int_muladd_chain", form)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        rc = lib.h2_int_muladd(
            x.data_ptr(), y.data_ptr(), x.numel(), iters, code, _cuda.stream_ptr(x)
        )
    _cuda.check(rc, "int_muladd_chain")
    int_muladd_chain.launches += 1
    return y


def int_addmask_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """B2: ``y = (y + x) & 0xFFFF`` chained ``iters`` times, elementwise."""
    if x.device.type == "cpu":
        return int_addmask_plain(x, iters)
    _check("int_addmask_chain", x, iters)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        rc = lib.h2_int_addmask(x.data_ptr(), y.data_ptr(), x.numel(), iters, _cuda.stream_ptr(x))
    _cuda.check(rc, "int_addmask_chain")
    int_addmask_chain.launches += 1
    return y


int_muladd_chain.launches = 0
int_addmask_chain.launches = 0
