"""Gradient compression with error feedback (``repro.optim.compression``).

  * bf16: ``g_q = bf16(g + e)``, the residual ``(g + e) - g_q`` kept in a
    bf16 buffer, so long runs stay unbiased;
  * int8: per-tensor absmax scaling to ``[-127, 127]``, the same feedback.

The trainer compresses the (accumulated) gradient after the backward pass
and decompresses before the optimizer; the error buffer rides the optimizer
state under ``"err"``. On one card there is no reduction to shrink: the
round trip is kept so that training under compression gives the
reference's numbers.
"""
from __future__ import annotations

import torch

from repro_torch.optim import tree as T


def init_error_buffer(params):
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                            device=p.device), params)


def compress_bf16(grads, err):
    """(g_q, new error buffer)."""
    def one(g, e):
        gf = g.to(torch.float32) + e.to(torch.float32)
        gq = gf.to(torch.bfloat16)
        return gq, (gf - gq.to(torch.float32)).to(torch.bfloat16)
    return _per_leaf(one, grads, err)


def compress_int8(grads, err):
    """((q int8, scale f32), new error buffer) per leaf."""
    def one(g, e):
        gf = g.to(torch.float32) + e.to(torch.float32)
        scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return (q, scale), (gf - deq).to(torch.bfloat16)
    return _per_leaf(one, grads, err)


def decompress_int8(qs):
    """The f32 gradients of ``compress_int8``'s ``(q, scale)`` leaves."""
    return _map_pairs(lambda qs_: qs_[0].to(torch.float32) * qs_[1], qs)


def _per_leaf(one, grads, err):
    """``one(g, e) -> (x, new_e)`` over the leaves of ``grads`` and ``err``:
    the tree of the ``x`` and the tree of the ``new_e``."""
    outs = [one(g, e) for g, e in zip(T.leaves(grads), T.up_to(grads, err))]
    return (T.unflatten(grads, [o[0] for o in outs]),
            T.unflatten(grads, [o[1] for o in outs]))


def _map_pairs(fn, tree):
    """``fn`` over the 2-tuples of ``tree``, which stand for leaves."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and len(tree) == 2 and not isinstance(
            tree[0], (dict, list)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_pairs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_pairs(fn, v) for v in tree]
    return fn(tree)
