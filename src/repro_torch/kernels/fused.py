"""Recognition of the fused-epilogue kernels under the dispatch mode.

The flash-attention and WKV6 kernels take an optional ``(4,)`` int32 runtime
format row and apply the dynamic quantize as an epilogue on their output
stores: the CUDA kernels call the quantizer's own device code
(``kernels/csrc/quantize_em.cuh``), the plain versions call
``quantize_em.ref.quantize_epilogue``. Each is registered as one
``torch.library`` custom op, so the interpreter's walk meets it as one op,
as the reference's walk meets one ``pallas_call`` equation.

When the walk meets such an op with a row wired in, it can *route* the
site's format row into the op, replacing the row argument, instead of
appending a separate quantize pass after it: a policy then runs as one
fused kernel per site. Routing is sound because the epilogue is bit for bit
``quantize_dynamic`` on the stored value, and program code wires the hook
with ``IDENTITY_ROW`` (an exact passthrough), so replacing the row is
exactly "quantize this site's output" with no extra kernel. A call made
without a row has no epilogue and its outputs stay ordinary sites.

Kept free of any ``repro_torch.core`` import so both the interpreter and the
kernel modules can use it while either is still being imported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# custom-op name -> (index of the format-row argument, output indices
# covered by the in-kernel epilogue). Other outputs -- wkv6's recurrence
# state sT -- are ordinary sites and keep the separate quantize pass.
FUSED_KERNELS = {
    "repro_torch::flash_attention": (3, (0,)),
    "repro_torch::wkv6": (6, (0,)),
}

# what a policy sees for these ops: the reference's primitive
PRIM = "pallas_call"


def _schema_name(func) -> Optional[str]:
    schema = getattr(func, "_schema", None)
    return getattr(schema, "name", None)


def fused_outputs(func) -> Optional[Tuple[int, ...]]:
    """Output indices covered by a fused quantize epilogue, or ``None`` for
    an op that has none (every aten op)."""
    hit = FUSED_KERNELS.get(_schema_name(func))
    return None if hit is None else hit[1]


def row_argument(func) -> int:
    """Position of the format-row argument of a fused op."""
    return FUSED_KERNELS[_schema_name(func)][0]


def covered_dtype(func, args) -> torch.dtype:
    """dtype of the covered output, known before the op runs: flash
    attention stores in ``q.dtype``, WKV6's ``y`` is always float32."""
    if _schema_name(func) == "repro_torch::flash_attention":
        return args[0].dtype
    return torch.float32


def row_tensor(out_fmt, device) -> Optional[torch.Tensor]:
    """``out_fmt`` (a (4,) row: numpy, list or tensor) as the contiguous
    int32 tensor on ``device`` that a fused op takes; ``None`` stays
    ``None``. A row already there is used as it is (no copy, no host
    synchronisation)."""
    if out_fmt is None:
        return None
    return torch.as_tensor(out_fmt, device=device).to(torch.int32) \
        .reshape(4).contiguous()
