"""CUDA kernels for arbitrary (e, m) RNE quantization, and their binding.

This is the hot path of the profiling runtime: in op-mode every matched
floating-point result passes through one of these two kernels, so together
they are the profiler's whole overhead. Both are elementwise and bound by
bytes: they read and write the storage dtype (f32, bf16, f16) over the flat
contiguous array, with no padding and no carrier copy in device memory (see
``csrc/quantize_em.cu`` for the design notes).

  * ``quantize_em_static``  — replaces the reference's ``quantize_2d``
    (``src/repro/kernels/quantize_em/kernel.py``). The format is not compiled
    in: the host derives the rounding constants once from the format and
    passes them by value, so one binary serves every format.
  * ``quantize_em_dynamic`` — replaces ``quantize_2d_dynamic`` and the
    ``_bitflip`` pass after it. Reads its own row of a ``(num_sites, 4)``
    int32 table from device memory (a ``(4,)`` row is ``site=0``), derives
    the constants in registers and folds the fault XOR into the same pass.
    No host read of the table, no synchronisation per site.

The library is built with ``nvcc`` at the first launch, never at import.
Each wrapper takes CUDA tensors only, launches on torch's current stream,
does not synchronise, allocates nothing but its output, raises if the launch
is refused, and counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize_em import ref as _ref

_SOURCE = Path(__file__).parent / "csrc" / "quantize_em.cu"
# bit-exactness: denormals never flush, division is IEEE, no fma contraction
_FLAGS = ("-ftz=false", "-prec-div=true", "-prec-sqrt=true", "-fmad=false")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

SOURCE = "src/repro_torch/kernels/quantize_em/csrc/quantize_em.cu"


class _StaticParams(ctypes.Structure):
    """Field for field the ``StaticParams`` struct of the CUDA source."""
    _fields_ = [
        ("k", ctypes.c_int32), ("half_m1", ctypes.c_uint32),
        ("keep", ctypes.c_uint32), ("knz", ctypes.c_int32),
        ("use_sub", ctypes.c_int32), ("ss", ctypes.c_float),
        ("ssinv", ctypes.c_float), ("min_normal", ctypes.c_float),
        ("ovf_gate", ctypes.c_int32), ("max_finite", ctypes.c_float),
        ("ovf_mode", ctypes.c_int32),
    ]


def start_build():
    """Start compiling the library without waiting for it."""
    return _build.start_build("quantize_em", [_SOURCE], _FLAGS)


def _lib():
    lib = _build.load("quantize_em", [_SOURCE], _FLAGS)
    if not getattr(lib, "_repro_bound", False):
        # explicit argtypes: without them ctypes cuts pointers to 32 bits
        lib.quantize_em_static.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, _StaticParams, ctypes.c_void_p]
        lib.quantize_em_static.restype = ctypes.c_int
        lib.quantize_em_dynamic.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.quantize_em_dynamic.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check_input(x, name: str):
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors only, got "
                         f"{getattr(x, 'device', type(x).__name__)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32/bfloat16/float16 storage, "
                        f"got {x.dtype}")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: launch refused, CUDA error {err}")


@functools.lru_cache(maxsize=None)
def static_params(fmt) -> _StaticParams:
    """Rounding constants of one format on the f32 carrier, as the struct
    the static kernel takes by value."""
    c = _ref.static_constants(fmt.exp_bits, fmt.man_bits, fmt.saturate,
                              fmt.ieee_inf, torch.float32)
    return _StaticParams(
        k=c["k"], half_m1=c["half_m1"], keep=c["keep"] & 0xFFFFFFFF,
        knz=int(c["knz"]), use_sub=int(c["use_sub"]), ss=c["ss"],
        ssinv=c["ssinv"], min_normal=c["min_normal"],
        ovf_gate=int(c["ovf_gate"]), max_finite=c["max_finite"],
        ovf_mode=c["ovf_mode"])


def _dense(x) -> bool:
    """Whether ``x``'s elements fill one block of memory with no gap and no
    overlap (a permutation of a contiguous tensor)."""
    expected = 1
    for size, stride in sorted(((n, st) for n, st in zip(x.shape, x.stride())
                                if n != 1), key=lambda p: p[1]):
        if stride != expected:
            return False
        expected *= size
    return True


def _layout(x):
    """``(source, destination, result)`` of one launch. The result has the
    strides an elementwise op on ``x`` gives its output (``empty_like``),
    as the plain versions' results do: a layout change would send the ops
    that read a rounded value down other paths (another GEMM transposition,
    other bits). A dense ``x`` is rounded in its own memory order, into a
    result of the same strides; any other is made contiguous first and
    copied into the result's layout after (``_finish``)."""
    out = torch.empty_like(x)
    if out.stride() == x.stride() and _dense(x):
        return x, out, out
    xc = x.contiguous()
    tmp = torch.empty_like(xc)
    return xc, tmp, tmp if out.is_contiguous() else out


def _finish(dst, result):
    if dst is not result:
        result.copy_(dst)
    return result


def quantize_em_static(x, fmt):
    """Round every element of CUDA tensor ``x`` onto the grid of ``fmt``
    (an ``FPFormat``); returns a new tensor of the same shape, dtype and
    strides (``_layout``)."""
    _check_input(x, "quantize_em_static")
    src, dst, result = _layout(x)
    n = x.numel()
    if n == 0:
        return result
    with torch.cuda.device(x.device):
        err = _lib().quantize_em_static(
            src.data_ptr(), dst.data_ptr(), n, _DTYPE_CODE[x.dtype],
            static_params(fmt), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "quantize_em_static")
    quantize_em_static.launches += 1
    return _finish(dst, result)


def quantize_em_dynamic(x, table, site: int = 0):
    """Round CUDA tensor ``x`` onto the format in row ``site`` of ``table``,
    a contiguous int32 CUDA tensor of shape ``(num_sites, 4)`` or ``(4,)``
    holding ``(exp_bits, man_bits, saturate, ieee_inf | (bit+1) << 1)``.
    The row is read on the device; the fault bit it may carry is XORed in
    the same pass. The result has the strides of ``x`` (``_layout``)."""
    _check_input(x, "quantize_em_dynamic")
    if (not isinstance(table, torch.Tensor) or table.device != x.device
            or table.dtype != torch.int32 or not table.is_contiguous()
            or table.shape[-1:] != (4,) or table.dim() not in (1, 2)):
        raise ValueError(
            "quantize_em_dynamic: table must be a contiguous int32 tensor of "
            "shape (num_sites, 4) or (4,) on the device of x")
    rows = table.numel() // 4
    if not 0 <= site < rows:
        raise IndexError(f"site {site} outside a table of {rows} rows")
    src, dst, result = _layout(x)
    n = x.numel()
    if n == 0:
        return result
    with torch.cuda.device(x.device):
        err = _lib().quantize_em_dynamic(
            src.data_ptr(), dst.data_ptr(), n, _DTYPE_CODE[x.dtype],
            table.data_ptr(), int(site),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "quantize_em_dynamic")
    quantize_em_dynamic.launches += 1
    return _finish(dst, result)


quantize_em_static.launches = 0
quantize_em_dynamic.launches = 0
