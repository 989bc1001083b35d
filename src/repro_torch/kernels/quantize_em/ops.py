"""Public quantization ops with implementation dispatch.

``impl``:
  * ``'auto'`` — the CUDA kernel for a tensor on the card, the plain PyTorch
                 version for a tensor on the CPU. There is no fallback: for a
                 CUDA tensor the kernel is launched or the call raises.
  * ``'cuda'`` — the CUDA kernel; raises for a tensor that is not on the card
  * ``'ref'``  — the plain PyTorch version on whatever device the tensor is
                 on (for tests and for comparing the kernel with it)
  * ``'interpret'`` — the plain version, for a tensor on the CPU only (the
                 reference's Pallas interpret mode; ``truncate(...,
                 impl='interpret')`` hands it down to every site); raises for
                 a tensor on the card

float64 is plain-only on every device, as in the reference package.

Fast paths (RAPTOR's zero-overhead hardware mode): when (e,m) matches a
hardware storage type and overflow semantics agree, emit a plain convert
pair instead of the bit-math; a target at least as fine as the storage grid
returns its input.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.formats import FPFormat, parse_format
from repro_torch.kernels.quantize_em import kernel as _kernel
from repro_torch.kernels.quantize_em import ref as _ref

_HW_DTYPES = {(8, 7): torch.bfloat16, (5, 10): torch.float16}
_KERNEL_STORAGE = (torch.float32, torch.bfloat16, torch.float16)

# Runtime format vectors: (exp_bits, man_bits, saturate, ieee_inf) as int32.
# IDENTITY_ROW is at least as fine as any carrier grid and IEEE, so the
# dynamic quantizer's identity gate passes values through unchanged — the
# runtime analogue of the static identity fast path.
IDENTITY_ROW = np.array([11, 52, 0, 1], np.int32)


def format_row(fmt) -> np.ndarray:
    """Lower an ``FPFormat`` (or spec string) to its (4,) int32 runtime row."""
    fmt = parse_format(fmt)
    return np.array([fmt.exp_bits, fmt.man_bits, int(fmt.saturate),
                     int(fmt.ieee_inf)], np.int32)


def _is_float_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype.is_floating_point


def _storage_grid(dt):
    """(stored mantissa bits, exponent bits) of a torch float dtype, derived
    from finfo so any float dtype works."""
    fi = torch.finfo(dt)
    nmant = int(round(-math.log2(fi.eps)))
    return nmant, fi.bits - 1 - nmant


def _resolve_impl(x, impl: str) -> str:
    if impl == "auto":
        return "cuda" if x.is_cuda else "ref"
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError("impl='cuda' needs a tensor on the card, got one "
                             f"on {x.device}")
        return impl
    if impl == "ref":
        return impl
    if impl == "interpret":
        if x.is_cuda:
            raise ValueError("impl='interpret' runs the plain version on the "
                             "CPU; the tensor is on the card")
        return "ref"
    raise ValueError(f"unknown impl {impl!r}")


def quantize(x, fmt, *, impl: str = "auto"):
    """Round every element of float tensor ``x`` onto the (e,m) grid of ``fmt``.

    Non-float inputs pass through unchanged. The result dtype equals the
    input dtype (values merely lie on the coarser grid) — op-mode semantics.
    """
    fmt: FPFormat = parse_format(fmt)
    if not _is_float_tensor(x):
        return x
    dt = x.dtype

    # identity: target grid at least as fine as the storage grid
    storage_bits, storage_exp = _storage_grid(dt)
    if (fmt.man_bits >= storage_bits and fmt.exp_bits >= storage_exp
            and not fmt.saturate and fmt.ieee_inf):
        return x

    # hardware convert-pair fast path
    hw = _HW_DTYPES.get((fmt.exp_bits, fmt.man_bits))
    if hw is not None and not fmt.saturate and fmt.ieee_inf:
        return x.to(hw).to(dt)

    # carrier selection: f64 stays f64 (plain), everything else goes via f32
    if dt == torch.float64:
        return _ref.quantize_ref_fmt(x, fmt)

    if _resolve_impl(x, impl) == "ref":
        return _ref.quantize_ref_fmt(x.to(torch.float32), fmt).to(dt)
    if dt in _KERNEL_STORAGE:
        # the kernel widens, rounds and narrows in registers
        return _kernel.quantize_em_static(x, fmt)
    return _kernel.quantize_em_static(x.to(torch.float32), fmt).to(dt)


def _bitflip(y, fault):
    """XOR bit ``fault - 1`` into every element's carrier bit pattern.

    ``fault == 0`` is an exact no-op (the XOR mask is zero), so unarmed rows
    are bit-identical to a quantizer without the fault channel. The bit
    index addresses the carrier layout: f32 for <=32-bit floats (31 = sign,
    30 = top exponent bit), f64 for f64 inputs."""
    itype = torch.int64 if y.dtype == torch.float64 else torch.int32
    fault = torch.as_tensor(fault, device=y.device).to(torch.int32)
    shift = torch.clamp(fault - 1, min=0).to(itype)
    mask = torch.where(fault > 0, _ref._shl_one(shift, itype),
                       torch.zeros((), dtype=itype, device=y.device))
    return (y.view(itype) ^ mask).view(y.dtype)


def _split_table(fmt):
    """``fmt`` as ``(table, site)``: a (4,) row is the table with site 0."""
    if isinstance(fmt, tuple) and len(fmt) == 2 and not np.isscalar(fmt[0]):
        return fmt[0], int(fmt[1])
    return fmt, 0


def quantize_dynamic(x, fmt, *, impl: str = "auto"):
    """Runtime-parameterized ``quantize``: ``fmt`` is a (4,) int32 row
    (exp_bits, man_bits, saturate, ieee_inf) whose values are *runtime* data,
    or a pair ``(table, site)`` naming row ``site`` of a ``(num_sites, 4)``
    int32 table.

    One kernel serves every format: the static identity and
    hardware-convert fast paths are replaced by the quantizer's
    ``man_bits >= carrier`` identity gate, so sweeping formats is a change
    of table values only. Bit-for-bit identical to the static entry point
    for every format with ``man_bits <= 23`` on f32 carriers (``<= 52`` on
    f64). Non-float inputs pass through; the result dtype equals the input
    dtype.

    On the card the row is read by the kernel from device memory: hand it
    an int32 tensor that already lies on the device of ``x`` and the call
    makes no host synchronisation. (A numpy row or a CPU tensor is copied
    to the device first, which does synchronise.)

    **Fault channel**: the high bits of the row's fourth field carry an
    optional bit-flip fault, ``field3 = ieee_inf | (bit_index + 1) << 1``.
    The chosen carrier bit is XORed into every (already quantized) element.
    A clean row (field3 in {0, 1}) decodes to fault 0 and the XOR is an
    exact no-op, so arming or disarming a fault is a table *value* change."""
    if not _is_float_tensor(x):
        return x
    dt = x.dtype
    table, site = _split_table(fmt)

    if dt != torch.float64 and _resolve_impl(x, impl) == "cuda":
        table = torch.as_tensor(table, dtype=torch.int32, device=x.device)
        if dt in _KERNEL_STORAGE:
            return _kernel.quantize_em_dynamic(x, table.contiguous(), site)
        return _kernel.quantize_em_dynamic(
            x.to(torch.float32), table.contiguous(), site).to(dt)

    row = torch.as_tensor(table, device=x.device).to(torch.int32)
    row = row.reshape(-1, 4)[site]
    e, m, s, f3 = row[0], row[1], row[2], row[3]
    # carrier selection mirrors the static path: f64 stays f64, rest via f32
    carrier = torch.float64 if dt == torch.float64 else torch.float32
    p = _ref.dynamic_row_params(e, m, s, f3 & 1, f3 >> 1, carrier,
                                device=x.device)
    return _ref.apply_row_params(x.to(carrier), p).to(dt)


# --------------------------------------------------------------------------
# prepared-table path: derive row constants once, apply cheaply per site
# --------------------------------------------------------------------------
#
# The plain-version twin of what the dynamic kernel does on the card: derive
# the constants for the WHOLE table in one vectorized block, then each site
# slices its row and runs only the array-side math. This is the path the
# interpreter takes for tensors on the CPU.

def prepare_dynamic(table, dtype=torch.float32, device=None):
    """Vectorized derived constants for every row of a ``(num_sites, 4)``
    format table (fault channel included): one dict of ``(num_sites,)``
    tensors consumed by :func:`quantize_prepared`."""
    t = torch.as_tensor(table, device=device).to(torch.int32)
    e, m, s, f3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    return _ref.dynamic_row_params(e, m, s, f3 & 1, f3 >> 1, dtype,
                                   device=t.device)


def quantize_prepared(x, prep, site: int):
    """Quantize ``x`` onto row ``site`` of a prepared table — bit-identical
    to ``quantize_dynamic(x, table[site], impl='ref')``. ``prep`` must have
    been built for ``x``'s carrier (f32 for everything but f64 inputs)."""
    if not _is_float_tensor(x):
        return x
    row = {k: v[site] for k, v in prep.items()}
    if x.dtype == torch.float64:
        return _ref.apply_row_params(x, row)
    return _ref.apply_row_params(x.to(torch.float32), row).to(x.dtype)
