"""CUDA flash-attention kernel (GQA, causal / sliding window, optional
fused quantize epilogue) and its ``ctypes`` binding.

``flash_attention_cuda`` replaces the reference's ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py``); see
``csrc/flash_attention.cu`` for the design notes and what bounds it: bf16
inputs go to a tensor-core kernel (``csrc/flash_attention_sm90.cuh``), f32
inputs to an exact-f32 CUDA-core kernel. The library is built with ``nvcc``
at the first launch, never at import, with the quantizer's flags: the
epilogue is the quantizer's own device code and must round exactly as
``quantize_em_dynamic`` does. The bf16 kernel's tensor maps are encoded with
``cuTensorMapEncodeTiled``, reached through ``cudaGetDriverEntryPoint``, so
the library does not link ``-lcuda``.

The wrapper takes CUDA tensors only, launches on torch's current stream,
does not synchronise, raises if the launch is refused, and counts its
launches in ``flash_attention_cuda.launches``. It allocates its output and,
for bf16, a copy of an input the tensor-core kernel cannot read as it is
(``bf16_operands``): inputs zero-padded to one head dim for q, k and v when
D and Dv are not one and the same of ``HEAD_DIMS_V`` (the output's extra
columns are cut off, another copy), and any of q, k, v whose base address
is not 16-byte aligned or whose batch, head or sequence stride is not a
positive multiple of 8 elements (TMA's terms) copied contiguous. The path's
permuted (B, S, H, D) views need no copy.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.quantize_em.kernel import _FLAGS

_SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS_V = (16, 32, 64, 80, 128)
MAX_HEAD_DIM = 128

SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"


def start_build():
    """Start compiling the library without waiting for it."""
    return _build.start_build("flash_attention", [_SOURCE], _FLAGS)


def _lib():
    lib = _build.load("flash_attention", [_SOURCE], _FLAGS)
    if not getattr(lib, "_repro_bound", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.flash_attention_fwd.argtypes = (
            [p] * 5 + [ll] * 9 + [i] * 8 + [ctypes.c_float, i, p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def check_shapes(q, k, v):
    """Raise on shapes and dtypes the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    B, Hq, S, D = q.shape
    if (k.shape[0] != B or v.shape[0] != B or k.shape[2] != S
            or v.shape[2] != S or k.shape[3] != D
            or v.shape[1] != k.shape[1]):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    Hkv = k.shape[1]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads are not a multiple "
                         f"of {Hkv} KV heads")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside "
                         f"1..{MAX_HEAD_DIM}")
    if v.shape[3] not in HEAD_DIMS_V:
        raise ValueError(f"flash_attention: value head dim {v.shape[3]} "
                         f"not in {HEAD_DIMS_V}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError("flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def bf16_operands(q, k, v):
    """q, k, v as the bf16 kernel reads them: one head dim W for all three,
    the smallest of ``HEAD_DIMS_V`` that holds D and Dv (zero columns of q
    and k leave q . k unchanged; zero columns of v give output columns that
    are cut off), 16-byte aligned bases, and batch, head and sequence
    strides that are positive multiples of 8 elements wherever the axis has
    more than one entry (TMA's terms). Inputs that meet them pass through;
    the others are copied."""
    D, Dv = q.shape[-1], v.shape[-1]
    W = min(w for w in HEAD_DIMS_V if w >= max(D, Dv))
    if D < W:
        q, k = F.pad(q, (0, W - D)), F.pad(k, (0, W - D))
    if Dv < W:
        v = F.pad(v, (0, W - Dv))

    def aligned(t):
        return t.data_ptr() % 16 == 0 and all(
            n == 1 or (st > 0 and st % 8 == 0)
            for n, st in zip(t.shape[:3], t.stride()[:3]))

    # clone, not contiguous(): a contiguous view off the alignment would
    # come back as it is
    return tuple(t if aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))


def flash_attention_cuda(q, k, v, row, causal: bool, window, scale: float):
    """Launch the kernel. ``q`` (B, Hq, S, D), ``k`` (B, Hkv, S, D), ``v``
    (B, Hkv, S, Dv), CUDA tensors of one dtype, any strides as long as the
    last axis is contiguous. ``row`` is a (4,) int32 format row on the
    device (a view of a table row is fine) or ``None``. Returns a new
    contiguous (B, Hq, S, Dv) tensor of q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors only; "
                             f"{name} is on "
                             f"{getattr(t, 'device', type(t).__name__)}")
    check_shapes(q, k, v)
    if row is not None and (row.device != q.device or row.dtype != torch.int32
                            or tuple(row.shape) != (4,)
                            or not row.is_contiguous()):
        raise ValueError("flash_attention_cuda: row must be a contiguous "
                         "(4,) int32 tensor on the device of q")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    Dv = v.shape[3]
    if q.dtype == torch.bfloat16:
        q, k, v = bf16_operands(q, k, v)
    B, Hq, S, D = q.shape
    Hkv, W = k.shape[1], v.shape[3]
    out = torch.empty((B, Hq, S, W), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :Dv]
    win = 0 if window is None else int(window)
    if window is not None and win <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if row is None else row.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            B, Hq, Hkv, S, D, W, int(bool(causal)), win, float(scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = (f"cuTensorMapEncodeTiled error {err - 10000}" if err >= 10000
                else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_cuda: launch refused, {what}")
    flash_attention_cuda.launches += 1
    return out if W == Dv else out[..., :Dv].contiguous()


flash_attention_cuda.launches = 0
