"""CUDA WKV6 recurrence kernel (optional fused quantize epilogue on y) and
its ``ctypes`` binding.

``wkv6_cuda`` replaces the reference's ``wkv6_pallas``
(``src/repro/kernels/rwkv6/kernel.py``); see ``csrc/wkv6.cu`` for the design
notes and what bounds it. The library is built with ``nvcc`` at the first
launch, never at import, with the quantizer's flags: the epilogue is the
quantizer's own device code.

The wrapper takes CUDA tensors only, launches on torch's current stream,
does not synchronise, allocates nothing but its outputs (float32
contiguous copies of ``u`` / ``s0`` where they are not already so, and a
contiguous copy of any of r / k / v / w that the kernel's 16-byte loads
cannot read as it is: see ``aligned``), raises if the launch is refused, and
counts its launches in ``wkv6_cuda.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize_em.kernel import _FLAGS

_SOURCE = Path(__file__).parent / "csrc" / "wkv6.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64)

SOURCE = "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu"


def start_build():
    """Start compiling the library without waiting for it."""
    return _build.start_build("wkv6", [_SOURCE], _FLAGS)


def _lib():
    lib = _build.load("wkv6", [_SOURCE], _FLAGS)
    if not getattr(lib, "_repro_bound", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.wkv6_fwd.argtypes = [p] * 9 + [ll] * 12 + [i] * 7 + [p]
        lib.wkv6_fwd.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def check_shapes(r, k, v, w, u, s0):
    """Raise on shapes and dtypes the kernel does not take."""
    if any(t.dim() != 4 for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v, w must be (B, H, S, hd)")
    B, H, S, hd = r.shape
    if any(tuple(t.shape) != (B, H, S, hd) for t in (k, v, w)):
        raise ValueError("wkv6: r, k, v, w must share one shape")
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv6: u must be {(H, hd)} and s0 "
                         f"{(B, H, hd, hd)}; got {tuple(u.shape)}, "
                         f"{tuple(s0.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd} not in {HEAD_DIMS}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODE \
            or w.dtype not in _DTYPE_CODE:
        raise TypeError("wkv6: r, k, v must share one dtype and w have one "
                        "of float32 / bfloat16; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel's 16-byte loads can read it as it is (unit stride
    on the last axis, a 16-byte aligned base, the other strides multiples of
    16 bytes), else a contiguous copy. A fresh allocation is aligned, and
    the head dims are multiples of 16 bytes."""
    per = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % per == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def wkv6_cuda(r, k, v, w, u, s0, row, chunk: int):
    """Launch the kernel on CUDA tensors. ``row`` is a (4,) int32 format row
    on the device (a view of a table row is fine) or ``None``; it rounds y
    only. ``chunk`` is the tokens staged at a time; the kernel takes at
    least 1, at most S and what its shared memory holds. No result depends
    on it.
    Returns new contiguous ``(y, sT)``, both float32."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"wkv6_cuda takes CUDA tensors only; {name} is "
                             f"on {getattr(t, 'device', type(t).__name__)}")
    check_shapes(r, k, v, w, u, s0)
    if row is not None and (row.device != r.device or row.dtype != torch.int32
                            or tuple(row.shape) != (4,)
                            or not row.is_contiguous()):
        raise ValueError("wkv6_cuda: row must be a contiguous (4,) int32 "
                         "tensor on the device of r")
    B, H, S, hd = r.shape
    r, k, v, w = (aligned(t) for t in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32).contiguous()
    y = torch.empty((B, H, S, hd), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if sT.numel() == 0:
        return y, sT
    with torch.cuda.device(r.device):
        err = _lib().wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            None if row is None else row.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], B, H, S, hd, int(chunk), _DTYPE_CODE[r.dtype],
            _DTYPE_CODE[w.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_cuda: launch refused, CUDA error {err}")
    wkv6_cuda.launches += 1
    return y, sT


wkv6_cuda.launches = 0
