"""Native fp8 (e4m3) dot path for ``quantize_dot_inputs`` sites
(``repro.kernels.fp8_dot``).

The emulated path rounds each dot operand onto the e4m3 grid but keeps the
values in the carrier dtype, so the product still runs at carrier width:
the profiler measures the *accuracy* of the policy, not its speed. This
module is the execution path: operands are stored as ``float8_e4m3fn`` and
the dot accumulates in f32, which is what exercises a low-precision matrix
unit.

Bit-exactness: each operand is first rounded onto the e4m3 grid by the
port's bit-exact quantizer (``quantize_dot_operand``: the static CUDA
kernel on the card, its plain version on the CPU), after which the storage
cast is exact -- every e4m3 grid value is representable in float8_e4m3fn --
whatever rounding the cast itself would do.

Specials: ``float8_e4m3fn`` has no infinities, so an operand that is (or
rounds to) +/-inf is stored as NaN, the degradation real fp8 storage
applies (``encode_e4m3``).

``torch.matmul`` takes no ``float8_e4m3fn`` operands, so the contraction on
the card is a kernel of the port's own (``csrc/fp8_dot.cu``, built with
``nvcc`` at its first launch): f32 sums of exact products.

``impl``: ``'auto'`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; ``'cuda'`` launches the kernel and raises
for a CPU tensor; ``'ref'`` is the plain version (fp8 decoded to f32, an f32
matmul with TF32 off) on any device, for tests and comparisons;
``'interpret'`` is the plain version on the CPU, as the quantizer has it.
The kernel's wrapper counts its launches (``fp8_dot_cuda.launches``).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Sequence, Tuple

import torch

from repro_torch.core.formats import FPFormat
from repro_torch.kernels import _build
from repro_torch.kernels.quantize_em import ops as _q

F8_DTYPE = torch.float8_e4m3fn

_SOURCE = Path(__file__).parent / "csrc" / "fp8_dot.cu"
SOURCE = "src/repro_torch/kernels/csrc/fp8_dot.cu"
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_MM = torch.ops.aten.mm.default
_BMM = torch.ops.aten.bmm.default
# the two-operand dot aten ops the native path takes, and their
# dimension numbers: ((lhs contracting, rhs contracting), (lhs batch, rhs
# batch))
ATEN_DOTS = {_MM: (((1,), (0,)), ((), ())),
             _BMM: (((2,), (1,)), ((0,), (0,)))}


def is_native_fp8_format(fmt) -> bool:
    """True when ``fmt`` (an ``FPFormat``) maps onto float8_e4m3fn storage:
    (e=4, m=3) with fn overflow semantics -- saturating (clamp to +/-448,
    still on the storage grid) or non-saturating (overflow -> NaN). IEEE-inf
    e4m3 layouts have no storage type."""
    return fmt.exp_bits == 4 and fmt.man_bits == 3 and not fmt.ieee_inf


def quantize_dot_operand(x, *, saturate: bool = True, impl: str = "auto"):
    """Pre-round a dot operand onto the e4m3 grid (f32 carrier), bit for
    bit the interpreter's emulated input quantize."""
    return _q.quantize(x.to(torch.float32), FPFormat(4, 3, saturate, False),
                       impl=impl)


def encode_e4m3(xq):
    """Cast values already on the e4m3 grid to fp8 storage (exact); an inf
    is stored as NaN."""
    xq = torch.where(torch.isinf(xq), torch.full_like(xq, float("nan")), xq)
    return xq.to(F8_DTYPE)


def start_build():
    """Start compiling the library without waiting for it."""
    return _build.start_build("fp8_dot", [_SOURCE])


def _lib():
    lib = _build.load("fp8_dot", [_SOURCE])
    if not getattr(lib, "_repro_bound", False):
        lib.fp8_dot.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
        lib.fp8_dot.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def fp8_dot_cuda(a, b, out_dtype=torch.float32):
    """``a @ b`` of float8_e4m3fn CUDA tensors ``a`` (batch, M, K) and ``b``
    (batch, K, N), any strides, summed in f32 and written once as
    ``out_dtype`` (f32, bf16 or f16) into a new contiguous (batch, M, N)
    tensor."""
    for t, name in ((a, "a"), (b, "b")):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"fp8_dot_cuda takes CUDA tensors only, {name} "
                             f"is on {getattr(t, 'device', type(t))}")
        if t.dtype != F8_DTYPE or t.dim() != 3:
            raise TypeError(f"fp8_dot_cuda: {name} must be a 3-d "
                            f"float8_e4m3fn tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"fp8_dot_cuda writes f32/bf16/f16, not {out_dtype}")
    (nb, m, k), (nb2, k2, n) = a.shape, b.shape
    if nb != nb2 or k != k2 or a.device != b.device:
        raise ValueError(f"fp8_dot_cuda: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    out = torch.empty((nb, m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        err = _lib().fp8_dot(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), nb, m, n, k,
            *a.stride(), *b.stride(), _OUT_CODE[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fp8_dot_cuda: launch refused, CUDA error {err}")
    fp8_dot_cuda.launches += 1
    return out


fp8_dot_cuda.launches = 0


def fp8_dot_ref(a, b, out_dtype=torch.float32):
    """The plain version of :func:`fp8_dot_cuda` on any device: decode to
    f32, an f32 matmul (TF32 off), one rounding to ``out_dtype``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.to(out_dtype)


def _canonical(x, contract: Sequence[int], batch: Sequence[int],
               lhs: bool) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``x`` as (batch, free, contract) for the lhs, (batch, contract,
    free) for the rhs -- a permuted view, reshaped -- and the free dims'
    sizes."""
    free = [d for d in range(x.dim()) if d not in contract and d not in batch]
    order = list(batch) + (free + list(contract) if lhs
                           else list(contract) + free)
    nb = math.prod(x.shape[d] for d in batch)
    fs = tuple(x.shape[d] for d in free)
    nk = math.prod(x.shape[d] for d in contract)
    shape = (nb, math.prod(fs), nk) if lhs else (nb, nk, math.prod(fs))
    return x.permute(order).reshape(shape), fs


def fp8_dot_general(lhs, rhs, dimension_numbers, *, saturate: bool = True,
                    precision=None, out_dtype=None, impl: str = "auto"):
    """``lax.dot_general`` with e4m3-quantized operands on native fp8
    storage, accumulating in f32: the operands are rounded by the bit-exact
    quantizer, stored as fp8 and contracted by the kernel (``impl``: module
    docstring). ``dimension_numbers`` is lax's ``((lhs_contracting,
    rhs_contracting), (lhs_batch, rhs_batch))``; the result's axes are the
    batch axes, then the lhs's free axes, then the rhs's, in f32 or
    ``out_dtype``. ``precision`` is accepted for the reference's signature
    and has no effect."""
    del precision
    mode = _q._resolve_impl(lhs, impl)
    (lc, rc), (lb, rb) = dimension_numbers
    lq = encode_e4m3(quantize_dot_operand(lhs, saturate=saturate,
                                          impl=impl))
    rq = encode_e4m3(quantize_dot_operand(rhs, saturate=saturate,
                                          impl=impl))
    a, lfree = _canonical(lq, lc, lb, True)
    b, rfree = _canonical(rq, rc, rb, False)
    dt = out_dtype if out_dtype is not None else torch.float32
    dot = fp8_dot_cuda if mode == "cuda" else fp8_dot_ref
    out = dot(a, b, dt if dt in _OUT_CODE else torch.float32).to(dt)
    return out.reshape(tuple(lhs.shape[d] for d in lb) + lfree + rfree)


def fp8_aten_dot(func, args, *, saturate: bool, impl: str = "auto"):
    """One ``aten.mm`` / ``aten.bmm`` call on the native path: the result
    in the operands' dtype, as the op gives it."""
    lhs, rhs = args
    return fp8_dot_general(lhs, rhs, ATEN_DOTS[func], saturate=saturate,
                           out_dtype=lhs.dtype, impl=impl)


__all__ = ["F8_DTYPE", "is_native_fp8_format", "quantize_dot_operand",
           "encode_e4m3", "fp8_dot_general", "fp8_dot_cuda", "fp8_dot_ref",
           "fp8_aten_dot", "ATEN_DOTS"]
