"""Attention: GQA/MQA with RoPE / M-RoPE / partial RoPE and sliding windows,
and Multi-head Latent Attention — the training/prefill paths.

``flash_attention`` is the chunked, memory-bounded plain-tensor version
(loops over KV blocks with a running max/denominator), as it is plain tensor
code in the reference package's models too. It deliberately does not call
``scaled_dot_product_attention``: the profiler must see the arithmetic
inside. KV heads are never materialized to Hq (grouped einsum). The
``(B, H, S, D)`` layout is the reference's.

Decode paths (one token against a cache) belong to the serving slice and
are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.interpreter import loop_body, scope
from repro_torch.models import common
from repro_torch.models.common import ParamDef


NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked flash attention (plain tensor code)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, scale: Optional[float] = None,
                    q_chunk: int = 1024, kv_chunk: int = 1024):
    """q: (B, Hq, S, Dk); k: (B, Hkv, T, Dk); v: (B, Hkv, T, Dv), T == S
    but for cross-attention (the reference's reshapes need T == S there
    too). Grouped-query: Hq % Hkv == 0. Returns (B, Hq, S, Dv).

    The two chunk loops are marked as loop bodies, so to the profiler every
    (q chunk, kv chunk) pair is the same set of quantize sites."""
    B, Hq, S, Dk = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)

    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    nq, nk = -(-S // q_chunk), -(-T // kv_chunk)
    assert S % q_chunk == 0 and T % kv_chunk == 0, (S, T, q_chunk, kv_chunk)

    qg = q.reshape(B, Hkv, G, S, Dk)
    pos = torch.arange(max(S, T), device=q.device)

    # sliding-window block skipping: with a static window each q chunk only
    # needs the kv chunks covering [q0 - window + 1, q0 + Cq) — an O(S*W)
    # instead of O(S^2) schedule
    n_win = nk
    if causal and isinstance(window, int):
        n_win = min(nk, (window + q_chunk - 1 + kv_chunk - 1) // kv_chunk + 1)

    outs = []
    for qi in range(nq):
        with loop_body("q_chunk"):
            q0 = qi * q_chunk
            q_blk = qg[:, :, :, q0:q0 + q_chunk]        # (B,Hkv,G,Cq,Dk)
            qp = pos[q0:q0 + q_chunk]
            start = 0
            if n_win < nk:
                start = min(max((q0 - (window - 1)) // kv_chunk, 0),
                            nk - n_win)

            m = torch.full((B, Hkv, G, q_chunk), NEG_INF,
                           dtype=torch.float32, device=q.device)
            l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32,
                            device=q.device)
            acc = torch.zeros((B, Hkv, G, q_chunk, Dv), dtype=torch.float32,
                              device=q.device)
            for kj in range(start, start + n_win):
                with loop_body("kv_chunk"):
                    k0 = kj * kv_chunk
                    k_blk = k[:, :, k0:k0 + kv_chunk]
                    v_blk = v[:, :, k0:k0 + kv_chunk]
                    kp = pos[k0:k0 + kv_chunk]
                    s = common.einsum("bhgqd,bhkd->bhgqk",
                                      q_blk.to(torch.float32),
                                      k_blk.to(torch.float32)) * scale
                    mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                                      device=q.device)
                    if causal:
                        mask = mask & (qp[:, None] >= kp[None, :])
                    if window is not None:
                        mask = mask & ((qp[:, None] - kp[None, :]) < window)
                    s = torch.where(mask[None, None, None], s, NEG_INF)
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    p = torch.exp(s - m_new[..., None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(dim=-1)
                    acc = acc * corr[..., None] + common.einsum(
                        "bhgqk,bhkd->bhgqd", p, v_blk.to(torch.float32))
                    m = m_new
            outs.append(acc / torch.clamp(l, min=1e-30)[..., None])

    # outs: nq x (B, Hkv, G, Cq, Dv) -> (B, Hq, S, Dv)
    out = torch.cat(outs, dim=3).reshape(B, Hq, S, Dv)
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_param_defs(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    scale = 0.02
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    defs = {
        "wq": ParamDef((d, H * hd), ("embed", "heads"), scale=scale),
        "wk": ParamDef((d, Hkv * hd), ("embed", "kv_heads"), scale=scale),
        "wv": ParamDef((d, Hkv * hd), ("embed", "kv_heads"), scale=scale),
        "wo": ParamDef((H * hd, d), ("heads", "embed"), scale=o_scale),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), ("heads",), init="zeros")
        defs["bk"] = ParamDef((Hkv * hd,), ("kv_heads",), init="zeros")
        defs["bv"] = ParamDef((Hkv * hd,), ("kv_heads",), init="zeros")
    return defs


def _project_qkv(p, x, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd).permute(0, 2, 1, 3)
    k = k.reshape(B, S, Hkv, hd).permute(0, 2, 1, 3)
    v = v.reshape(B, S, Hkv, hd).permute(0, 2, 1, 3)
    if cfg.rope_type == "rope":
        q = common.apply_rope(q, positions, theta=cfg.rope_theta,
                              fraction=cfg.rope_fraction)
        k = common.apply_rope(k, positions, theta=cfg.rope_theta,
                              fraction=cfg.rope_fraction)
    elif cfg.rope_type == "mrope":
        q = common.apply_mrope(q, positions, theta=cfg.rope_theta,
                               sections=cfg.mrope_sections)
        k = common.apply_mrope(k, positions, theta=cfg.rope_theta,
                               sections=cfg.mrope_sections)
    return q, k, v


def gqa_forward(p, x, cfg: ArchConfig, *, positions, causal: bool = True,
                window: Optional[int] = None):
    """Training/prefill attention. x: (B, S, d). Returns ((B,S,d), kv)."""
    B, S, _ = x.shape
    with scope("qkv"):
        q, k, v = _project_qkv(p, x, cfg, positions)
    with scope("mix"):
        o = flash_attention(q, k, v, causal=causal, window=window)
    with scope("proj"):
        o = o.permute(0, 2, 1, 3).reshape(B, S, -1)
        out = o @ p["wo"].to(x.dtype)
    return out, (k, v)


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_param_defs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "q_down": ParamDef((d, m.q_lora), ("embed", None)),
        "q_norm": ParamDef((m.q_lora,), (None,), init="ones"),
        "q_up": ParamDef((m.q_lora, H * (m.nope_head_dim + m.rope_head_dim)),
                         (None, "heads")),
        "kv_down": ParamDef((d, m.kv_lora + m.rope_head_dim), ("embed", None)),
        "kv_norm": ParamDef((m.kv_lora,), (None,), init="ones"),
        "kv_up": ParamDef((m.kv_lora, H * (m.nope_head_dim + m.v_head_dim)),
                          (None, "heads")),
        "wo": ParamDef((H * m.v_head_dim, d), ("heads", "embed"), scale=o_scale),
    }


def _mla_q(p, x, cfg, positions):
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = common.rmsnorm(x @ p["q_down"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = (cq @ p["q_up"].to(x.dtype)).reshape(
        B, S, H, m.nope_head_dim + m.rope_head_dim).permute(0, 2, 1, 3)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = common.apply_rope(q_rope, positions, theta=cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, x, cfg, positions):
    m = cfg.mla
    kv = x @ p["kv_down"].to(x.dtype)
    c_kv, k_rope = kv[..., :m.kv_lora], kv[..., m.kv_lora:]
    # the second rmsnorm under mla_qkv (after _mla_q's): sites of its own
    with loop_body("kv_norm", once=True):
        c_kv = common.rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = common.apply_rope(k_rope[:, None], positions,
                               theta=cfg.rope_theta)[:, 0]
    return c_kv, k_rope          # (B,S,kv_lora), (B,S,rope_dim)


def mla_forward(p, x, cfg: ArchConfig, *, positions):
    """Training/prefill MLA in the expanded form: q/k heads of
    nope + rope width, v heads of ``v_head_dim``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    with scope("mla_qkv"):
        q_nope, q_rope = _mla_q(p, x, cfg, positions)
        c_kv, k_rope = _mla_latent(p, x, cfg, positions)
        kv = (c_kv @ p["kv_up"].to(x.dtype)).reshape(
            B, S, H, m.nope_head_dim + m.v_head_dim).permute(0, 2, 1, 3)
        k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
        k = torch.cat([k_nope, k_rope[:, None].expand(
            B, H, S, m.rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
    with scope("mla_mix"):
        scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
        o = flash_attention(q, k, v, causal=True, scale=scale)
    with scope("mla_proj"):
        o = o.permute(0, 2, 1, 3).reshape(B, S, H * m.v_head_dim)
        out = o @ p["wo"].to(x.dtype)
    return out, (c_kv, k_rope)
