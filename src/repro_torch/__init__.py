"""PyTorch + CUDA port of the RAPTOR numerical profiler.

Mirrors the directory layout of the reference package ``repro`` (JAX), which
it never imports. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
