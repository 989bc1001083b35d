"""Public WKV6 op with implementation dispatch.

``impl`` keeps the reference's meanings, as in ``flash_attention.ops``:

  * ``'auto'``      — the CUDA kernel for tensors on the card, ``'ref'`` for
                      tensors on the CPU. No fallback on the card.
  * ``'cuda'``      — the CUDA kernel; raises for tensors on the CPU.
  * ``'interpret'`` — the custom op's CPU registration: the plain loop
                      inside ONE op, epilogue included (the counterpart of the
                      reference's ``interpret=True``). Raises on the card.
  * ``'ref'``       — the plain loop, visible op by op, then
                      ``quantize_dynamic(..., impl='ref')`` on ``y``.

``'cuda'`` and ``'interpret'`` go through the ``torch.library`` custom op
``repro_torch::wkv6``, which the interpreter knows as the fused kernel
``pallas_call`` whose epilogue covers ``y`` only (``kernels/fused.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.fused import row_tensor
from repro_torch.kernels.quantize_em import ref as _qref
from repro_torch.kernels.quantize_em.ops import quantize_dynamic
from repro_torch.kernels.rwkv6 import kernel as _kernel
from repro_torch.kernels.rwkv6.ref import wkv6_ref


@torch.library.custom_op("repro_torch::wkv6", mutates_args=())
def _wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
             row: Optional[torch.Tensor], chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if r.is_cuda:
        return _kernel.wkv6_cuda(r, k, v, w, u, s0, row, chunk)
    y, sT = wkv6_ref(r, k, v, w, u, s0)
    if row is not None:
        y = _qref.quantize_epilogue(y, row)
    return y, sT


@_wkv6_op.register_fake
def _(r, k, v, w, u, s0, row, chunk):
    B, H, S, hd = r.shape
    return (r.new_empty((B, H, S, hd), dtype=torch.float32),
            r.new_empty((B, H, hd, hd), dtype=torch.float32))


def wkv6(r, k, v, w, u, s0, *, impl: str = "auto", chunk: int = 64,
         out_fmt=None):
    """r/k/v/w: (B, H, S, hd); u: (H, hd); s0: (B, H, hd, hd) f32.
    Returns (y (B, H, S, hd) f32, sT (B, H, hd, hd) f32).

    ``out_fmt``: optional (4,) int32 runtime format row applied to ``y``
    (fused in the kernel on the ``'cuda'`` / ``'interpret'`` paths, composed
    on ``'ref'``); ``sT`` is returned unquantized either way. ``chunk`` sets
    how many tokens the kernel stages at a time; results do not depend on
    it."""
    if impl == "auto":
        impl = "cuda" if r.is_cuda else "ref"
    if impl == "cuda" and not r.is_cuda:
        raise ValueError("impl='cuda' needs tensors on the card, got r on "
                         f"{r.device}")
    if impl == "interpret" and r.is_cuda:
        raise ValueError("impl='interpret' runs the plain version on the "
                         "CPU; r is on the card (use 'cuda' or 'ref')")
    if impl in ("cuda", "interpret"):
        return _wkv6_op(r, k, v, w, u, s0, row_tensor(out_fmt, r.device),
                        int(chunk))
    if impl != "ref":
        raise ValueError(f"unknown impl {impl!r}")
    y, sT = wkv6_ref(r, k, v, w, u, s0)
    if out_fmt is not None:
        y = quantize_dynamic(y, out_fmt, impl="ref")
    return y, sT
