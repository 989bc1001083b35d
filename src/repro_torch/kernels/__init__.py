"""Hand-written CUDA kernels of the port, one sub-package per kernel family.

Each family keeps its CUDA source under ``csrc/``, its ``ctypes`` binding in
``kernel.py``, the plain PyTorch version of the same function in ``ref.py``
and the public, dispatching entry points in ``ops.py``.
"""


def kernel_wrappers() -> dict:
    """name -> wrapper for every kernel the port has; each wrapper carries a
    ``launches`` counter."""
    from repro_torch.kernels import fp8_dot as f8
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quantize_em import kernel as qk
    from repro_torch.kernels.rwkv6 import kernel as wk
    return {"quantize_em_static": qk.quantize_em_static,
            "quantize_em_dynamic": qk.quantize_em_dynamic,
            "flash_attention": fk.flash_attention_cuda,
            "wkv6": wk.wkv6_cuda,
            "fp8_dot": f8.fp8_dot_cuda}


def start_builds() -> list:
    """Start compiling every kernel library side by side (one ``nvcc`` per
    library); ``wait()`` on each result."""
    from repro_torch.kernels import fp8_dot as f8
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quantize_em import kernel as qk
    from repro_torch.kernels.rwkv6 import kernel as wk
    return [m.start_build() for m in (qk, fk, wk, f8)]


def launch_counts() -> dict:
    return {n: w.launches for n, w in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0
