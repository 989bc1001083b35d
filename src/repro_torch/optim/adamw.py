"""AdamW on tensors with dtype-configurable state (``repro.optim.adamw``).

State mirrors the parameter tree. ``state_dtype="bfloat16"`` halves the m/v
footprint; the f32 master copy is kept whenever a parameter is half
precision (``None`` otherwise). On sharded (DTensor) parameters ``m``,
``v`` and the master are laid out as their parameter, the clip uses the
norm of the global gradient, and the update runs on the local shards. Nothing here reads a value back to the host:
the step counter, the clip scale and a scheduled learning rate are tensors
on the parameters' device, so a train step makes no host synchronisation.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import sharding as _shd
from repro_torch.models.common import torch_dtype
from repro_torch.optim import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # m/v dtype
    master_dtype: str = "float32"    # master copy (when params half prec)


# elements of a leaf updated at a time (see ``apply_updates``)
_SLICE = 1 << 25


def _is_half(x: torch.Tensor) -> bool:
    return x.dtype in (torch.bfloat16, torch.float16)


def _device(params) -> torch.device:
    return T.leaves(params)[0].device


def init_state(params, cfg: AdamWConfig):
    sd, md = torch_dtype(cfg.state_dtype), torch_dtype(cfg.master_dtype)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
        "m": T.tree_map(lambda p: _zeros_as(p, sd), params),
        "v": T.tree_map(lambda p: _zeros_as(p, sd), params),
        "master": T.tree_map(
            lambda p: p.detach().to(md, copy=True) if _is_half(p) else None,
            params),
    }


def _zeros_as(p, dtype):
    """Zeros of ``p``'s shape in ``dtype``, laid out as ``p`` (a DTensor's
    zeros are its placements' shards)."""
    if _shd._is_dtensor(p):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, the leaves added
    in the reference's order from zero. Of DTensor leaves, the norm of the
    global tree: each shard's sum of squares, summed over the ranks that
    hold the pieces (a plain tensor on every rank)."""
    total = None
    for g in T.leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return _shd.gather(_shd.settled(torch.sqrt(_shd.settled(total))))


def apply_updates(params, grads, state, cfg: AdamWConfig, lr):
    """One AdamW step. ``lr`` is a Python float or a scalar tensor on the
    device (a schedule's value). Returns ``(params, state, {"grad_norm"})``;
    the inputs are left as they were."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = 1.0
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, stepf)
    c2 = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v, master):
        gf = g.to(torch.float32) * scale
        mf = m.to(torch.float32) * cfg.b1 + gf * (1.0 - cfg.b1)
        vf = v.to(torch.float32) * cfg.b2 + gf * gf * (1.0 - cfg.b2)
        del gf
        base = (master if master is not None else p).to(torch.float32)
        step_ = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        new_base = base - lr * (step_ + cfg.weight_decay * base)
        del step_
        new_p = new_base.to(p.dtype)
        new_master = (new_base.to(master.dtype) if master is not None
                      else None)
        return new_p, mf.to(m.dtype), vf.to(v.dtype), new_master

    def upd_leaf(p, g, m, v, master):
        """``upd`` on this rank's shards (elementwise, so the global
        update's values), rewrapped as ``p`` is laid out."""
        if not _shd._is_dtensor(p):
            return upd_slices(p, g, m, v, master)
        g = _shd.redistribute_as(g, p)
        new = upd_slices(*[None if t is None else _shd.local_parts(t)[0]
                           for t in (p, g, m, v, master)])
        return tuple(None if n is None else _shd.like(o, n)
                     for o, n in zip((p, m, v, master), new))

    def upd_slices(p, g, m, v, master):
        """``upd`` on slices of at most ``_SLICE`` elements along the first
        axis (elementwise, so the same values), written into the new
        leaves: the f32 temporaries of one slice, not of a whole stacked
        layer tensor, are alive at a time."""
        rows = p.shape[0] if p.ndim else 1
        per = max(1, _SLICE // max(1, p.numel() // max(rows, 1)))
        if p.ndim == 0 or rows <= per:
            return upd(p, g, m, v, master)
        out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v),
               None if master is None else torch.empty_like(master))
        for lo in range(0, rows, per):
            sl = slice(lo, lo + per)
            part = upd(p[sl], g[sl], m[sl], v[sl],
                       None if master is None else master[sl])
            for dst, src in zip(out, part):
                if dst is not None:
                    dst[sl] = src
        return out

    outs = [upd_leaf(*leaf) for leaf in zip(
        T.leaves(params), T.up_to(params, grads), T.up_to(params, state["m"]),
        T.up_to(params, state["v"]), T.up_to(params, state["master"]))]
    return (T.unflatten(params, [o[0] for o in outs]),
            {"step": step,
             "m": T.unflatten(params, [o[1] for o in outs]),
             "v": T.unflatten(params, [o[2] for o in outs]),
             "master": T.unflatten(params, [o[3] for o in outs])},
            {"grad_norm": gnorm})


def warmup_cosine(step, *, peak_lr: float, warmup: int = 2000,
                  total: int = 100_000, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine to ``floor * peak_lr``.
    ``step`` is an integer tensor (on the device of the train step) or a
    Python int; the result is an f32 tensor on the same device."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step)
    s = step.to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
