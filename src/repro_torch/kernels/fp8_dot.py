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
``nvcc`` at its first launch): f32 sums of exact products, on the tensor
cores. It reads both operands K-major -- ``(batch, M, Kp)`` and ``(batch,
N, Kp)``, contiguous, K zero-padded to ``Kp``, a multiple of ``K_TILE`` --
the layout ``pack_k_major`` writes. ``fp8_dot_general`` packs as it stores
each operand in fp8 (``encode_e4m3`` writing into the packed buffer), so an
N-major right operand (the MLP's weights) costs no extra pass;
``fp8_dot_cuda`` takes operands of any strides and packs them.

``impl``: ``'auto'`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; ``'cuda'`` launches the kernel and raises
for a CPU tensor; ``'ref'`` is the plain version (fp8 decoded to f32, an f32
matmul with TF32 off) on any device, for tests and comparisons;
``'interpret'`` is the plain version on the CPU, as the quantizer has it.
The kernel's launches are counted on ``fp8_dot_cuda.launches``.
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
_PROBE_SOURCE = Path(__file__).parent / "csrc" / "fp8_mma_probe.cu"
# the kernel's tensor-core route (``csrc/fp8_dot.cu``): the f16 wgmma on
# the decoded operands, its sum promoted into f32 registers after every 8
# instructions (one k-tile); ``mma_probe``'s (route, promote) of it
ROUTE = ("f16", 8)
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


def encode_e4m3(xq, out=None):
    """Cast values already on the e4m3 grid to fp8 storage (exact); an inf
    is stored as NaN. ``out``: a float8_e4m3fn tensor (or view) of
    ``xq``'s shape to write into, as the pack does."""
    xq = torch.where(torch.isinf(xq), torch.full_like(xq, float("nan")), xq)
    if out is None:
        return xq.to(F8_DTYPE)
    return out.copy_(xq)


# the kernel's depth of one k-tile: a packed operand's K is a multiple of it
K_TILE = 128


def packed_k(k: int) -> int:
    """The packed depth of a contraction over ``k``: ``k`` rounded up to a
    whole k-tile (one at least)."""
    return max(K_TILE, -(-k // K_TILE) * K_TILE)


def pack_k_major(x):
    """``x`` (batch, rows, K) of any strides -- float8_e4m3fn, or values on
    the e4m3 grid, stored as ``encode_e4m3`` stores them -- as a new
    contiguous float8_e4m3fn tensor (batch, rows, ``packed_k(K)``) whose
    columns past K are zeros: the operand layout the kernel reads (K-major,
    rows a multiple of 16 bytes). One pass over ``x``."""
    nb, rows, k = x.shape
    buf = torch.empty((nb, rows, packed_k(k)), dtype=torch.uint8,
                      device=x.device)
    buf[..., k:].zero_()
    buf = buf.view(F8_DTYPE)
    if x.dtype == F8_DTYPE:
        buf[..., :k].copy_(x)
    else:
        encode_e4m3(x, out=buf[..., :k])
    return buf


def start_build():
    """Start compiling the library without waiting for it."""
    return _build.start_build("fp8_dot", [_SOURCE])


def _lib():
    lib = _build.load("fp8_dot", [_SOURCE])
    if not getattr(lib, "_repro_bound", False):
        lib.fp8_dot.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.fp8_dot.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _probe_lib():
    lib = _build.load("fp8_mma_probe", [_PROBE_SOURCE])
    if not getattr(lib, "_repro_bound", False):
        lib.fp8_mma_probe.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.fp8_mma_probe.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check_packed(ap, bp, out_dtype):
    """Raise on what the kernel does not take; returns (batch, M, N, Kp)."""
    for t, name in ((ap, "a"), (bp, "b")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fp8_dot_packed: {name} is not a tensor")
        if t.dtype != F8_DTYPE or t.dim() != 3:
            raise TypeError(f"fp8_dot_packed: {name} must be a 3-d "
                            f"float8_e4m3fn tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.shape[2] % K_TILE:
            raise ValueError(
                f"fp8_dot_packed: {name} must be packed K-major "
                f"(pack_k_major): contiguous, K a multiple of {K_TILE}; got "
                f"shape {tuple(t.shape)}, strides {t.stride()}")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"fp8_dot_packed writes f32/bf16/f16, not "
                        f"{out_dtype}")
    (nb, m, kp), (nb2, n, kp2) = ap.shape, bp.shape
    if nb != nb2 or kp != kp2 or ap.device != bp.device:
        raise ValueError(f"fp8_dot_packed: shapes {tuple(ap.shape)} and "
                         f"{tuple(bp.shape)} do not contract")
    for t, name in ((ap, "a"), (bp, "b")):
        if not t.is_cuda:
            raise ValueError(f"fp8_dot_packed takes CUDA tensors only, "
                             f"{name} is on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"fp8_dot_packed: {name} is not 16-byte "
                             "aligned")
    return nb, m, n, kp


def fp8_dot_packed(ap, bp, out_dtype=torch.float32):
    """``a @ b^T`` of packed operands (``pack_k_major``): ``ap`` (batch, M,
    Kp) and ``bp`` (batch, N, Kp) float8_e4m3fn CUDA tensors, summed in f32
    and written once as ``out_dtype`` (f32, bf16 or f16) into a new
    contiguous (batch, M, N) tensor. The launch is counted on
    ``fp8_dot_cuda.launches``."""
    nb, m, n, kp = _check_packed(ap, bp, out_dtype)
    out = torch.empty((nb, m, n), dtype=out_dtype, device=ap.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(ap.device):
        err = _lib().fp8_dot(
            ap.data_ptr(), bp.data_ptr(), out.data_ptr(), nb, m, n, kp,
            _OUT_CODE[out_dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fp8_dot_packed: launch refused, CUDA error "
                           f"{err}")
    fp8_dot_cuda.launches += 1
    return out


def fp8_dot_cuda(a, b, out_dtype=torch.float32):
    """``a @ b`` of float8_e4m3fn CUDA tensors ``a`` (batch, M, K) and ``b``
    (batch, K, N), any strides: both packed K-major, then
    :func:`fp8_dot_packed`."""
    for t, name in ((a, "a"), (b, "b")):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"fp8_dot_cuda takes CUDA tensors only, {name} "
                             f"is on {getattr(t, 'device', type(t))}")
        if t.dtype != F8_DTYPE or t.dim() != 3:
            raise TypeError(f"fp8_dot_cuda: {name} must be a 3-d "
                            f"float8_e4m3fn tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"fp8_dot_cuda: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    return fp8_dot_packed(pack_k_major(a), pack_k_major(b.transpose(1, 2)),
                          out_dtype)


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


_ROUTES = {"fp8": 0, "f16": 1, "bf16": 2}


def mma_probe(ap, bp, route: str, promote: int):
    """Which tensor-core route holds the kernel's contract (the design's
    step 0, ``chip_smoke.py``'s ``fp8_probe``): one warpgroup per 64 x 64
    block sums ``ap`` (M, Kp) times ``bp`` (N, Kp)^T, packed CUDA operands
    with M and N multiples of 64, through the fp8 wgmma (``route='fp8'``)
    or the f16 / bf16 wgmma on the decoded values, adding its accumulator
    into f32 registers after every ``promote`` instructions (0: once at
    the end). Returns the (M, N) f32 result. Its own library
    (``csrc/fp8_mma_probe.cu``), built at its first call; not counted: it
    is no kernel of a path."""
    if route not in _ROUTES:
        raise ValueError(f"mma_probe: route must be one of {sorted(_ROUTES)}")
    _check_packed(ap[None], bp[None], torch.float32)
    m, kp = ap.shape
    n = bp.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=ap.device)
    with torch.cuda.device(ap.device):
        err = _probe_lib().fp8_mma_probe(
            ap.data_ptr(), bp.data_ptr(), out.data_ptr(), m, n, kp,
            _ROUTES[route], promote, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mma_probe: launch refused, CUDA error {err}")
    return out


def _canonical(x, contract: Sequence[int], batch: Sequence[int]
               ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``x`` as (batch, free, contract) -- a permuted view, reshaped -- and
    the free dims' sizes."""
    free = [d for d in range(x.dim()) if d not in contract and d not in batch]
    nb = math.prod(x.shape[d] for d in batch)
    fs = tuple(x.shape[d] for d in free)
    nk = math.prod(x.shape[d] for d in contract)
    order = list(batch) + free + list(contract)
    return x.permute(order).reshape(nb, math.prod(fs), nk), fs


def fp8_dot_general(lhs, rhs, dimension_numbers, *, saturate: bool = True,
                    precision=None, out_dtype=None, impl: str = "auto"):
    """``lax.dot_general`` with e4m3-quantized operands on native fp8
    storage, accumulating in f32: the operands are rounded by the bit-exact
    quantizer, stored as fp8 in the kernel's packed layout and contracted
    by the kernel (``impl``: module docstring). ``dimension_numbers`` is
    lax's ``((lhs_contracting, rhs_contracting), (lhs_batch, rhs_batch))``;
    the result's axes are the batch axes, then the lhs's free axes, then
    the rhs's, in f32 or ``out_dtype``. ``precision`` is accepted for the
    reference's signature and has no effect."""
    del precision
    mode = _q._resolve_impl(lhs, impl)
    (lc, rc), (lb, rb) = dimension_numbers
    lq = quantize_dot_operand(lhs, saturate=saturate, impl=impl)
    rq = quantize_dot_operand(rhs, saturate=saturate, impl=impl)
    a, lfree = _canonical(lq, lc, lb)
    b, rfree = _canonical(rq, rc, rb)
    dt = out_dtype if out_dtype is not None else torch.float32
    ap, bp = pack_k_major(a), pack_k_major(b)
    if mode == "cuda":
        out = fp8_dot_packed(ap, bp, dt if dt in _OUT_CODE else torch.float32)
    else:           # the pad's zero products add nothing
        out = fp8_dot_ref(ap, bp.transpose(1, 2))
    out = out.to(dt)
    return out.reshape(tuple(lhs.shape[d] for d in lb) + lfree + rfree)


def fp8_aten_dot(func, args, *, saturate: bool, impl: str = "auto"):
    """One ``aten.mm`` / ``aten.bmm`` call on the native path: the result
    in the operands' dtype, as the op gives it. DTensor operands run on
    each rank's pieces (``sharding.dot_on_shards``): a column-parallel
    product gives this rank's shard of the result, a row-parallel one f32
    partial sums, reduced before the one rounding."""
    from repro_torch.distributed import sharding as shd
    lhs, rhs = args
    dims = ATEN_DOTS[func]

    def dot(a, b, out_dtype):
        return fp8_dot_general(a, b, dims, saturate=saturate,
                               out_dtype=out_dtype, impl=impl)
    if shd.any_dtensor(args):
        return shd.dot_on_shards(dot, lhs, rhs, dims, lhs.dtype)
    return dot(lhs, rhs, lhs.dtype)


__all__ = ["F8_DTYPE", "K_TILE", "ROUTE", "is_native_fp8_format",
           "quantize_dot_operand", "encode_e4m3", "packed_k", "pack_k_major",
           "fp8_dot_general", "fp8_dot_cuda", "fp8_dot_packed",
           "fp8_dot_ref", "mma_probe", "fp8_aten_dot",
           "ATEN_DOTS"]
