"""Public flash-attention op with implementation dispatch.

``impl`` keeps the reference's meanings:

  * ``'auto'``      — the CUDA kernel for a tensor on the card, ``'ref'`` for
                      a tensor on the CPU. No fallback: for a CUDA tensor the
                      kernel is launched or the call raises.
  * ``'cuda'``      — the CUDA kernel; raises for a tensor on the CPU.
  * ``'interpret'`` — the custom op's CPU registration: the plain version
                      inside ONE op, epilogue included. The counterpart of the
                      reference's ``interpret=True``: the interpreter sees the
                      same single op it sees on the card, so the CPU tests
                      exercise the routing. Raises for a tensor on the card.
  * ``'ref'``       — the chunked plain version (``models.attention
                      .flash_attention``), visible op by op, then
                      ``quantize_dynamic(..., impl='ref')`` for ``out_fmt``:
                      the reference's ``'xla'`` path.

``'cuda'`` and ``'interpret'`` go through one ``torch.library`` custom op,
``repro_torch::flash_attention``, which the interpreter knows as the fused
kernel ``pallas_call`` (``kernels/fused.py``). Its format row is a tensor
argument, so a table row (``table[site]``, a view on the device) goes into
the kernel without any host read.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.fused import row_tensor
from repro_torch.kernels.quantize_em import ref as _qref
from repro_torch.kernels.quantize_em.ops import quantize_dynamic
from repro_torch.models.attention import flash_attention as _chunked


def _plain(q, k, v, causal, window, scale):
    return _chunked(q, k, v, causal=causal, window=window,
                    scale=scale).to(q.dtype)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              row: Optional[torch.Tensor], causal: bool,
              window: Optional[int], scale: float) -> torch.Tensor:
    if q.is_cuda:
        return _kernel.flash_attention_cuda(q, k, v, row, causal, window,
                                            scale)
    out = _plain(q, k, v, causal, window, scale)
    if row is not None:
        out = _qref.quantize_epilogue(out, row)
    return out


@_flash_op.register_fake
def _(q, k, v, row, causal, window, scale):
    B, Hq, S, _ = q.shape
    return q.new_empty((B, Hq, S, v.shape[-1]))


def flash_attention(q, k, v, *, causal: bool = True, window=None, scale=None,
                    impl: str = "auto", out_fmt=None, **kw):
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D/Dv). Returns (B, Hq, S, Dv) in
    q's dtype.

    ``out_fmt`` (optional): a (4,) int32 runtime format row
    (exp_bits, man_bits, saturate, ieee_inf | fault << 1). On the kernel
    paths the dynamic quantize runs as the kernel's epilogue on the stored
    output; on ``'ref'`` it composes as a separate pass — bit-identical
    either way. Hand it an int32 tensor already on q's device to keep the
    call free of host synchronisation. ``**kw`` takes the reference's
    tiling arguments (``block_q``, ``block_k``), which the CUDA kernel
    fixes itself."""
    unknown = set(kw) - {"block_q", "block_k"}
    if unknown:
        raise TypeError(f"flash_attention: unexpected arguments {unknown}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "ref"
    if impl == "cuda" and not q.is_cuda:
        raise ValueError("impl='cuda' needs tensors on the card, got q on "
                         f"{q.device}")
    if impl == "interpret" and q.is_cuda:
        raise ValueError("impl='interpret' runs the plain version on the "
                         "CPU; q is on the card (use 'cuda' or 'ref')")
    if impl in ("cuda", "interpret"):
        return _flash_op(q, k, v, row_tensor(out_fmt, q.device), causal,
                         window, scale)
    if impl != "ref":
        raise ValueError(f"unknown impl {impl!r}")
    out = _plain(q, k, v, causal, window, scale)
    if out_fmt is not None:
        out = quantize_dynamic(out, out_fmt, impl="ref")
    return out
