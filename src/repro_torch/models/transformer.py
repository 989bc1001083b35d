"""Decoder stack: embeds -> layers -> norm -> logits (dense GQA path).

The port covers the dense grouped-query family (h2o-danube with its sliding
window, and any config of the same shape). Layers are stacked into a single
(L, ...) parameter tree, as in the reference package, and executed with a
Python loop. Every module runs under ``scope(...)`` — these names are the
truncation-policy surface of the profiling engine (core/policy.py), and they
are the reference's: ``embed``, ``layer/pre_norm/rmsnorm``,
``layer/attn/qkv``, ``layer/attn/mix``, ``layer/attn/proj``,
``layer/post_norm``, ``layer/mlp``, ``final_norm``, ``logits``, ``loss``.
With ``scan_layers`` every layer runs under the one scope ``layer`` and
shares its quantize sites (what scanning the stack gives the reference);
without it the scopes are ``layer0``, ``layer1``, … and the sites distinct.

Other attention types (mla, hymba, rwkv6), MoE, caches and ``decode_step``
are not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.interpreter import scope
from repro_torch.models import attention
from repro_torch.models.common import (
    ParamDef, ACTIVATIONS, rmsnorm, layernorm, map_defs, torch_dtype,
)


def _check_ported(cfg: ArchConfig):
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"attn_type {cfg.attn_type!r} is not ported yet (only 'gqa')")
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.family == "encdec" or cfg.input_mode != "tokens":
        raise NotImplementedError(
            "encoder-decoder and embedding-input models are not ported yet")
    if cfg.global_layers:
        raise NotImplementedError("global-attention layers are not ported yet")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_param_defs(cfg: ArchConfig, d_ff: int) -> dict:
    d = cfg.d_model
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    mult = 2 if cfg.act == "swiglu" else 1
    return {
        "wi": ParamDef((d, mult * d_ff), ("embed", "mlp")),
        "wo": ParamDef((d_ff, d), ("mlp", "embed"), scale=o_scale),
    }


def mlp_forward(p, x, cfg: ArchConfig):
    with scope("mlp"):
        h = x @ p["wi"].to(x.dtype)
        h = ACTIVATIONS[cfg.act](h)
        return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# norm dispatch
# ---------------------------------------------------------------------------

def norm_defs(cfg: ArchConfig) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((cfg.d_model,), ("embed",), init="ones"),
                "bias": ParamDef((cfg.d_model,), ("embed",), init="zeros")}
    return {"scale": ParamDef((cfg.d_model,), ("embed",), init="ones")}


def apply_norm(p, x, cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# layer definitions
# ---------------------------------------------------------------------------

def layer_param_defs(cfg: ArchConfig, kind: str = "dense") -> dict:
    _check_ported(cfg)
    return {"norm1": norm_defs(cfg), "norm2": norm_defs(cfg),
            "attn": attention.gqa_param_defs(cfg),
            "mlp": mlp_param_defs(cfg, cfg.d_ff)}


def layer_forward(cfg: ArchConfig, p, x, positions, kind: str = "dense",
                  is_global=None):
    """One decoder layer. ``is_global=True`` lifts the sliding window."""
    with scope("pre_norm"):
        h = apply_norm(p["norm1"], x, cfg)
    window = None if is_global else cfg.sliding_window
    with scope("attn"):
        y, _ = attention.gqa_forward(p["attn"], h, cfg, positions=positions,
                                     window=window)
    x = x + y
    with scope("post_norm"):
        h = apply_norm(p["norm2"], x, cfg)
    return x + mlp_forward(p["mlp"], h, cfg)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def model_param_defs(cfg: ArchConfig) -> dict:
    _check_ported(cfg)
    d = cfg.d_model

    def stacked(defs):  # prepend the layer-stack dim to every ParamDef
        return map_defs(
            lambda pd: ParamDef((cfg.n_layers,) + pd.shape,
                                ("layers",) + pd.axes, pd.init, pd.scale),
            defs)

    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_defs(cfg),
        "layers": stacked(layer_param_defs(cfg)),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab), ("embed", "vocab"),
                                   scale=0.02)
    return defs


def segments(cfg: ArchConfig):
    """Execution plan over the layer stack: homogeneous ("scan", lo, hi)
    runs. (The reference interleaves unrolled global-attention layers for
    its hybrid family, which is not ported yet.)"""
    _check_ported(cfg)
    return [("scan", 0, cfg.n_layers)]


def _tree_index(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def forward(params, batch, cfg: ArchConfig, last_only: bool = False):
    """Full forward to logits. batch: tokens (+labels elsewhere).
    ``last_only`` computes the LM head for the final position only (prefill
    fast path: avoids materializing (B, S, vocab) logits)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    with scope("embed"):
        x = params["embed"].to(torch_dtype(cfg.dtype))[tokens]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)

    stack = params["layers"]
    for kind, lo, hi in segments(cfg):
        for i in range(lo, hi):
            with scope("layer" if cfg.scan_layers else f"layer{i}"):
                x = layer_forward(cfg, _tree_index(stack, i), x, positions,
                                  is_global=False)

    if last_only:
        x = x[:, -1:]
    with scope("final_norm"):
        x = apply_norm(params["final_norm"], x, cfg)
    with scope("logits"):
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        logits = x.to(torch.float32) @ head.to(torch.float32)
    return logits


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean token cross-entropy (f32)."""
    logits = forward(params, batch, cfg)
    labels = batch["labels"]
    with scope("loss"):
        # log-sum-exp written out from the reference's elementary steps
        amax = logits.amax(dim=-1, keepdim=True)
        sumexp = torch.exp(logits - amax).sum(dim=-1)
        logz = torch.log(sumexp) + amax[..., 0]
        gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))
        nll = logz - gold[..., 0]
        mask = batch.get("mask")
        if mask is not None:
            nll = nll * mask
            return nll.sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.sum() / nll.numel()


def prefill(params, batch, cfg: ArchConfig):
    """Inference forward over a full prompt; returns last-token logits."""
    logits = forward(params, batch, cfg, last_only=True)
    return logits[:, 0]


def init_cache(cfg: ArchConfig, batch: int, seq_len: int):
    raise NotImplementedError("decode caches are not ported yet")


def decode_step(params, cache, tokens, cfg: ArchConfig, embeds=None):
    raise NotImplementedError("decode_step is not ported yet")
