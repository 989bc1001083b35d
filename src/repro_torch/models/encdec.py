"""Encoder-decoder backbone (seamless-m4t-large-v2) — training/prefill.

The speech frontend is a stub, as in the reference package: the batch
carries precomputed frame embeddings ``src_embeds`` (B, T_src, d); the
encoder is a bidirectional transformer stack over them. The text decoder is
causal self-attention + cross-attention into the encoder's output. Scopes
are the reference's: ``enc_layer/self_attn``, ``enc_norm``, ``embed``,
``dec_layer/self_attn``, ``dec_layer/cross_attn``, ``final_norm``,
``logits``, ``loss``. Each encoder layer and each decoder layer is one trip
of the reference's two scans, so one trajectory step each (encoder layers
first), and each stack shares one set of sites.

Decode grows a self-attention cache against a fixed cross-attention
memory (per-layer cross K/V in the cache, computed from the encoder's
output by the caller, zeros otherwise). As in the reference, the decode
self-attention opens no ``self_attn`` scope and the logits no ``logits``
scope: only ``embed``, ``dec_layer``, ``dec_layer/cross_attn`` and
``final_norm``.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.core.interpreter import (loop_body, loop_const, scope,
                                          zero_cotangents)
from repro_torch.distributed.sharding import constrain, lookup
from repro_torch.models import attention
from repro_torch.models.common import ParamDef, resolve_device, torch_dtype
from repro_torch.models.transformer import (
    _maybe_remat, _positions, _stack_caches, _tree_index, apply_norm,
    mlp_forward, mlp_param_defs, norm_defs, stacked, token_nll, unstack,
)

# fixed source length for decode cells (prompt memory)
CROSS_MEMORY_LEN = 4096


def _enc_layer_defs(cfg: ArchConfig) -> dict:
    return {
        "norm1": norm_defs(cfg),
        "attn": attention.gqa_param_defs(cfg),
        "norm2": norm_defs(cfg),
        "mlp": mlp_param_defs(cfg, cfg.d_ff),
    }


def _dec_layer_defs(cfg: ArchConfig) -> dict:
    return {
        "norm1": norm_defs(cfg),
        "self_attn": attention.gqa_param_defs(cfg),
        "norm_x": norm_defs(cfg),
        "cross_attn": attention.gqa_param_defs(cfg),
        "norm2": norm_defs(cfg),
        "mlp": mlp_param_defs(cfg, cfg.d_ff),
    }


def model_param_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed")),
        "enc_layers": stacked(_enc_layer_defs(cfg), cfg.enc_layers),
        "enc_norm": norm_defs(cfg),
        "dec_layers": stacked(_dec_layer_defs(cfg), cfg.n_layers),
        "final_norm": norm_defs(cfg),
        "lm_head": ParamDef((d, cfg.vocab), ("embed", "vocab")),
    }


def encode(params, src_embeds, cfg: ArchConfig):
    x = constrain(src_embeds.to(torch_dtype(cfg.dtype)),
                  "batch", "seq", "embed")
    B, T = x.shape[:2]
    positions = _positions({}, cfg, T, B, x.device)

    def body(x, p_l):
        h = apply_norm(p_l["norm1"], x, cfg)
        with scope("self_attn"):
            y, _ = attention.gqa_forward(p_l["attn"], h, cfg,
                                         positions=positions, causal=False)
        x = x + y
        h = _norm_again("norm2", p_l, x, cfg)
        return x + mlp_forward(p_l["mlp"], h, cfg)

    for p_l in unstack(params["enc_layers"], cfg.enc_layers):
        with scope("enc_layer", loop=True):
            x = _maybe_remat(cfg, body, x, p_l)
    with scope("enc_norm"):
        return apply_norm(params["enc_norm"], x, cfg)


def _norm_again(name: str, p_l, x, cfg: ArchConfig):
    """A layer's second or third norm, all under one scope: its own sites
    (the reference traces each call), but the jitted ``jnp.var`` inside a
    layernorm still shares one body with the first norm's."""
    with loop_body(name, once=True):
        return apply_norm(p_l[name], x, cfg)


def _cross_attend(p, x, memory, cfg: ArchConfig):
    """q from decoder x, kv from encoder memory (non-causal, no RoPE)."""
    B, S, _ = x.shape
    T = memory.shape[1]
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd).permute(0, 2, 1, 3)
    k = (memory @ p["wk"].to(x.dtype)).reshape(B, T, Hkv, hd).permute(0, 2, 1, 3)
    v = (memory @ p["wv"].to(x.dtype)).reshape(B, T, Hkv, hd).permute(0, 2, 1, 3)
    o = attention.flash_attention(q, k, v, causal=False,
                                  q_chunk=min(1024, S), kv_chunk=min(1024, T))
    o = o.permute(0, 2, 1, 3).reshape(B, S, -1)
    return o @ p["wo"].to(x.dtype)


def _dec_layer(cfg, p_l, x, memory, positions, mix_state=None,
               decode=False, pos=None, cross_kv=None):
    """One decoder layer. Returns ``(x, new self-attention cache)``."""
    h = apply_norm(p_l["norm1"], x, cfg)
    if decode:
        y, new_kv = attention.gqa_decode(p_l["self_attn"], h, mix_state, pos,
                                         cfg)
    else:
        with scope("self_attn"):
            y, _ = attention.gqa_forward(p_l["self_attn"], h, cfg,
                                         positions=positions, causal=True)
        new_kv = mix_state
    x = x + y
    h = _norm_again("norm_x", p_l, x, cfg)
    with scope("cross_attn"):
        if decode:
            k, v = cross_kv
            B = h.shape[0]
            q = (h[:, 0] @ p_l["cross_attn"]["wq"].to(h.dtype)).reshape(
                B, cfg.n_heads, cfg.resolved_head_dim)
            o = attention.decode_attention(q, k, v, k.shape[2])
            y = o.reshape(B, 1, -1) @ p_l["cross_attn"]["wo"].to(h.dtype)
        else:
            y = _cross_attend(p_l["cross_attn"], h, memory, cfg)
    x = x + y
    h = _norm_again("norm2", p_l, x, cfg)
    return x + mlp_forward(p_l["mlp"], h, cfg), new_kv


def forward(params, batch, cfg: ArchConfig, last_only: bool = False):
    """batch: src_embeds (B,T,d), tokens (B,S) -> logits (B,S,V)."""
    memory = encode(params, batch["src_embeds"], cfg)
    with scope("embed"):
        x = lookup(params["embed"].to(torch_dtype(cfg.dtype)),
                   batch["tokens"])
    x = constrain(x, "batch", "seq", "embed")
    B, S = x.shape[:2]
    positions = _positions({}, cfg, S, B, x.device)

    def body(x, p_l, memory):
        return _dec_layer(cfg, p_l, x, memory, positions)[0]

    for p_l in unstack(params["dec_layers"], cfg.n_layers):
        # the memory is a const of the reference's decoder scan. Under
        # remat it transposes each checkpointed layer as a unit: the
        # layer's two cotangents (k and v) are summed inside it, under the
        # cross attention, and the layers' sums outside the layer's scopes.
        # Without remat each cotangent is added, under the cross attention,
        # to a running sum that starts at zero: v's, then k's, layer by
        # layer
        mem = loop_const(memory) if cfg.remat else memory
        with scope("dec_layer", loop=True):
            x = _maybe_remat(cfg, body, x, p_l, mem)
    if not cfg.remat:
        x = zero_cotangents(x, memory)
    if last_only:
        x = x[:, -1:]
    with scope("final_norm"):
        x = apply_norm(params["final_norm"], x, cfg)
    with scope("logits"):
        logits = x.to(torch.float32) @ params["lm_head"].to(torch.float32)
        return constrain(logits, "batch", "seq", "vocab")


def loss_fn(params, batch, cfg: ArchConfig):
    logits = forward(params, batch, cfg)
    with scope("loss"):
        return token_nll(logits, batch["labels"])


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               memory_len: int = CROSS_MEMORY_LEN, *, device=None):
    """Decoder self-KV cache + per-layer cross K/V (computed from the
    encoder's output by the caller; zeros here), on ``device`` (``None`` =
    the CUDA device)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    self_kv = attention.gqa_init_cache(cfg, batch, seq_len, dtype, device)
    cross_shape = (cfg.n_layers, batch, cfg.n_kv_heads, memory_len,
                   cfg.resolved_head_dim)
    return {
        "layers": _stack_caches(self_kv, cfg.n_layers),
        "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg: ArchConfig):
    """One decode step of the decoder: tokens (B,) int32 -> ``(logits (B,
    vocab), new cache)``; the input cache is left unchanged."""
    pos = cache["pos"]
    with scope("embed"):
        x = lookup(params["embed"].to(torch_dtype(cfg.dtype)),
                   tokens)[:, None]
    x = constrain(x, "batch", "seq", "embed")
    outs = []
    for i in range(cfg.n_layers):
        with scope("dec_layer", loop=True):
            x, new_kv = _dec_layer(
                cfg, _tree_index(params["dec_layers"], i), x, None, None,
                mix_state=_tree_index(cache["layers"], i), decode=True,
                pos=pos, cross_kv=(cache["cross_k"][i], cache["cross_v"][i]))
        outs.append(new_kv)
    with scope("final_norm"):
        x = apply_norm(params["final_norm"], x, cfg)
    logits = x[:, 0].to(torch.float32) @ params["lm_head"].to(torch.float32)
    new_cache = dict(cache, pos=pos + 1,
                     layers=pytree.tree_map(lambda *ts: torch.stack(ts),
                                            *outs))
    return constrain(logits, "batch", "vocab"), new_cache
