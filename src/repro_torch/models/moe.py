"""Mixture-of-Experts: top-k router + capacity-grouped expert matmuls.

Dispatch as in the reference package: token->expert assignments are sorted
(stably), truncated to a per-expert capacity C = tokens*top_k/E * cf,
gathered into a dense (E, C, d) block and processed with batched matmuls —
the compute shape a grouped-matmul kernel would see (top_k * tokens * cf
useful rows, not E * tokens). The same (token, k) slots are dropped as in the
reference: those past their expert's capacity in stable-sort order.

Router math is f32 (precision-fragile — a profiling target in the paper's
module-truncation study).

**Ties.** ``torch.topk`` breaks ties between equal router probabilities in
another order than ``lax.top_k`` (lower index first). The expert ids are
therefore taken from a descending *stable* sort, which gives the reference's
order on the CPU and the card alike; ``torch.topk`` gives the gate values
(equal values whichever index won), so the router keeps the reference's one
``top_k`` site.

**No host synchronisation.** Nothing here reads a device value on the host:
the expert counts are a ``scatter_add`` into E zeros (``bincount`` would read
the largest id to size its output), the capacity is a Python int from the
shapes, and there is no boolean-mask indexing or ``nonzero``. Dropped slots
are scattered to a sentinel row past the E*C expert slots; that row takes
several writes in no fixed order and is cut off, so none of them is read.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.interpreter import scope
from repro_torch.models import common
from repro_torch.models.common import ParamDef, ACTIVATIONS


def moe_param_defs(cfg: ArchConfig) -> dict:
    mc = cfg.moe
    d = cfg.d_model
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    defs = {
        "router": ParamDef((d, mc.n_experts), ("embed", None)),
        "wi": ParamDef((mc.n_experts, d, 2 * mc.d_expert),
                       ("experts", "embed", "mlp")),
        "wo": ParamDef((mc.n_experts, mc.d_expert, d),
                       ("experts", "mlp", "embed"), scale=o_scale),
    }
    if mc.n_shared:
        defs["shared_wi"] = ParamDef((d, 2 * mc.n_shared * mc.d_expert),
                                     ("embed", "mlp"))
        defs["shared_wo"] = ParamDef((mc.n_shared * mc.d_expert, d),
                                     ("mlp", "embed"), scale=o_scale)
    return defs


class _TopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, k):
        values, _ = torch.topk(probs, k, dim=-1)
        _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        ids = order[..., :k]
        ctx.mark_non_differentiable(ids)
        ctx.save_for_backward(ids)
        ctx.shape = probs.shape
        return values, ids

    @staticmethod
    def backward(ctx, g, _):
        (ids,) = ctx.saved_tensors
        return g.new_zeros(ctx.shape).scatter(-1, ids, g), None


def top_k(probs, k: int):
    """(values, ids) of the ``k`` largest entries of the last axis, ties to
    the lower index as ``lax.top_k`` breaks them. The values' cotangent is
    scattered to those ids (``top_k``'s transpose), not to the ones
    ``torch.topk`` picked among equal values."""
    return _TopK.apply(probs, k)


def _routing(p, x, mc: MoEConfig):
    """Returns (expert_ids, gates) with shapes (T, k), router probs in f32."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = common.softmax(logits, dim=-1)
    gates, ids = top_k(probs, mc.top_k)
    if mc.renormalize:
        gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return ids, gates


def capacity_of(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert: tokens*top_k/E * capacity_factor, rounded up to a
    multiple of 8 and at least 8 (the reference's rule)."""
    mc = cfg.moe
    capacity = int(math.ceil(n_tokens * mc.top_k / mc.n_experts
                             * mc.capacity_factor))
    return max(8, -(-capacity // 8) * 8)


def dispatch_plan(ids, n_experts: int, capacity: int):
    """Where each (token, k) slot goes: returns ``(slot_tok, slot_of)``.
    ``slot_tok`` (E*C,) is the source token of every expert slot (T, the
    zero sentinel row, where empty); ``slot_of`` (T*K,) the expert slot of
    every (token, k) pair (E*C, the sentinel, where dropped)."""
    T, K = ids.shape
    E, C = n_experts, capacity
    dev = ids.device
    flat_ids = ids.reshape(-1)                                   # (T*K,)
    flat_tok = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    sorted_tok = flat_tok[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    offsets = torch.cumsum(counts, 0) - counts         # start of each expert
    pos_in_expert = torch.arange(T * K, device=dev) - offsets[sorted_ids]
    keep = pos_in_expert < C
    dest = torch.where(keep, sorted_ids * C + pos_in_expert, E * C)
    # slot -> source token (sentinel row T = zeros); the sentinel index
    # E*C takes every dropped slot's write and is cut off
    slot_tok = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    slot_tok = slot_tok.scatter(0, dest, sorted_tok)[:E * C]
    # (token, k) slot -> its expert slot
    slot_of = torch.full((T * K,), E * C, dtype=torch.int64, device=dev)
    slot_of = slot_of.scatter(0, order, dest)
    return slot_tok, slot_of


def moe_forward(p, x, cfg: ArchConfig, capacity: Optional[int] = None):
    """x: (B, S, d) -> (B, S, d). Capacity-dropped top-k MoE."""
    mc = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = mc.n_experts, mc.top_k
    if capacity is None:
        capacity = capacity_of(cfg, T)

    xf = x.reshape(T, d)
    with scope("router"):
        ids, gates = _routing(p, xf, mc)              # (T,K)

    with scope("dispatch"):
        slot_tok, slot_of = dispatch_plan(ids, E, capacity)
        x_pad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype,
                                           device=xf.device)], dim=0)
        x_grp = x_pad[slot_tok].reshape(E, capacity, d)

    with scope("experts"):
        h = common.einsum("ecd,edf->ecf", x_grp, p["wi"].to(x.dtype))
        h = ACTIVATIONS["swiglu"](h)
        y_grp = common.einsum("ecf,efd->ecd", h, p["wo"].to(x.dtype))

    with scope("combine"):
        y_flat = y_grp.reshape(E * capacity, d)
        y_flat = torch.cat([y_flat, torch.zeros((1, d), dtype=y_flat.dtype,
                                                device=y_flat.device)])
        # per (token, k) slot: value gathered back from its expert slot
        y_tk = y_flat[slot_of].reshape(T, K, d)
        g = gates.to(torch.float32)[..., None]
        y = (y_tk.to(torch.float32) * g).sum(dim=1).to(x.dtype)

    if mc.n_shared:
        with scope("shared"):
            hs = ACTIVATIONS["swiglu"](xf @ p["shared_wi"].to(x.dtype))
            y = y + hs @ p["shared_wo"].to(x.dtype)

    return y.reshape(B, S, d)


def aux_load_balance_loss(p, x, cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (f32)."""
    mc = cfg.moe
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, -1)
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = common.softmax(logits, dim=-1)
    _, ids = top_k(probs, mc.top_k)
    one_hot = (ids[..., None] == torch.arange(
        mc.n_experts, device=ids.device)).to(torch.float32)
    occupancy = one_hot.sum(dim=(0, 1)) / (ids.shape[0] * ids.shape[1])
    importance = probs.sum(dim=0) / probs.shape[0]
    return mc.n_experts * (occupancy * importance).sum()
