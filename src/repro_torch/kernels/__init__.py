"""Hand-written CUDA kernels of the port, one sub-package per kernel family.

Each family keeps its CUDA source under ``csrc/``, its ``ctypes`` binding in
``kernel.py``, the plain PyTorch version of the same function in ``ref.py``
and the public, dispatching entry points in ``ops.py``.
"""


def kernel_wrappers() -> dict:
    """name -> wrapper for every kernel the port has; each wrapper carries a
    ``launches`` counter."""
    from repro_torch.kernels.quantize_em import kernel as qk
    return {"quantize_em_static": qk.quantize_em_static,
            "quantize_em_dynamic": qk.quantize_em_dynamic}


def launch_counts() -> dict:
    return {n: w.launches for n, w in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0
