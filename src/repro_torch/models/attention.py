"""Attention: GQA/MQA with RoPE / M-RoPE / partial RoPE and sliding windows,
and Multi-head Latent Attention — the training/prefill paths.

``flash_attention`` is the chunked, memory-bounded plain-tensor version
(loops over KV blocks with a running max/denominator), as it is plain tensor
code in the reference package's models too. It deliberately does not call
``scaled_dot_product_attention``: the profiler must see the arithmetic
inside. KV heads are never materialized to Hq (grouped einsum). The
``(B, H, S, D)`` layout is the reference's.

Decode paths attend one new token against a pre-allocated cache; MLA
decode uses the absorbed low-rank form so the cache stays (kv_lora +
rope_dim) wide. A decode path opens none of the forward's ``qkv`` / ``mix``
/ ``proj`` scopes: it runs under its caller's scope, as the reference's
does. The cache is updated as the reference updates it, by selecting the
new row where a one-hot slot mask is true (``torch.where``, a structural
op to a policy), never by writing into the old cache in place.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    constrain, replicate_like, whole_groups,
)
from repro_torch.core.interpreter import (
    loop_body, loop_const, remat, scope, zero_cotangents,
)
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
    pos = replicate_like(q, torch.arange(max(S, T), device=q.device))

    # sliding-window block skipping: with a static window each q chunk only
    # needs the kv chunks covering [q0 - window + 1, q0 + Cq) — an O(S*W)
    # instead of O(S^2) schedule
    n_win = nk
    if causal and isinstance(window, int):
        n_win = min(nk, (window + q_chunk - 1 + kv_chunk - 1) // kv_chunk + 1)

    def kv_step(m, l, acc, q_blk, k_blk, v_blk, qp, kj):
        k0 = kj * kv_chunk
        kp = pos[k0:k0 + kv_chunk]
        s = common.einsum("bhgqd,bhkd->bhgqk", q_blk.to(torch.float32),
                          k_blk.to(torch.float32)) * scale
        mask = replicate_like(q, torch.ones((q_chunk, kv_chunk),
                                            dtype=torch.bool,
                                            device=q.device))
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
        return m_new, l, acc

    def q_step(q_blk, k, v, qi):
        q0 = qi * q_chunk
        qp = pos[q0:q0 + q_chunk]
        start = 0
        if n_win < nk:
            start = min(max((q0 - (window - 1)) // kv_chunk, 0), nk - n_win)
        m = replicate_like(q, torch.full((B, Hkv, G, q_chunk), NEG_INF,
                                         dtype=torch.float32,
                                         device=q.device))
        l = replicate_like(q, torch.zeros((B, Hkv, G, q_chunk),
                                          dtype=torch.float32,
                                          device=q.device))
        acc = replicate_like(q, torch.zeros((B, Hkv, G, q_chunk, Dv),
                                            dtype=torch.float32,
                                            device=q.device))
        # the kv chunks are the scan's xs, as in the reference: one split,
        # whose transpose concatenates the trips' cotangents (no sum)
        ks, vs = k.split(kv_chunk, dim=2), v.split(kv_chunk, dim=2)
        for kj in range(start, start + n_win):
            with loop_body("kv_chunk"):
                # the chunk's indices are bound now: the recompute runs in
                # the backward pass, after the loop has moved on
                m, l, acc = remat(functools.partial(kv_step, qp=qp, kj=kj),
                                  m, l, acc, loop_const(q_blk), ks[kj],
                                  vs[kj])
        # the scan's transpose: the final m's cotangent and the sum of the
        # q block's start at zero
        acc = zero_cotangents(acc, m, q_blk)
        return acc / torch.clamp(l, min=1e-30)[..., None]

    # as in the reference, each q chunk and each kv chunk is recomputed in
    # the backward pass (flash-style: no (Cq, Ck) block is kept per chunk
    # pair); without gradients ``remat`` is a plain call
    outs = []
    for qi in range(nq):
        with loop_body("q_chunk"):
            q0 = qi * q_chunk
            q_blk = qg[:, :, :, q0:q0 + q_chunk]        # (B,Hkv,G,Cq,Dk)
            outs.append(remat(functools.partial(q_step, qi=qi), q_blk,
                              loop_const(k), loop_const(v)))

    # outs: nq x (B, Hkv, G, Cq, Dv) -> (B, Hq, S, Dv); the sums of k's and
    # v's cotangents over the q chunks start at zero
    out = zero_cotangents(torch.cat(outs, dim=3), k, v).reshape(B, Hq, S, Dv)
    return out.to(v.dtype)


def _cursors(pos, B: int, device) -> torch.Tensor:
    """``pos`` (a Python int, a scalar or a (B,) tensor) as a (B,) int32
    vector of per-slot cursors. A Python int is filled in on the device:
    no copy from the host, so no host synchronisation."""
    if isinstance(pos, int):
        return torch.full((B,), pos, dtype=torch.int32, device=device)
    return pos.to(torch.int32).expand(B)



def decode_attention(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                     scale: Optional[float] = None, ring: bool = False):
    """One-token attention. q: (B, Hq, Dk); caches: (B, Hkv, S, D*);
    pos: int32 scalar or (B,) vector — per-slot count of valid cache entries
    (the new token's index in slot b is pos[b]-1 after the cache update).
    A scalar means every batch lane sits at the same cursor; the serving
    engine passes a ragged (B,) vector so slots decode independently.

    ``ring=True``: the cache is a ring buffer of size S == window; slot s
    holds the token at position pos - ((pos - s) mod S) — negative means the
    slot hasn't been written yet (masked). No separate window mask needed:
    the ring IS the window."""
    B, Hq, Dk = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    pos_b = _cursors(pos, B, q.device)

    qg = q.reshape(B, Hkv, G, Dk)
    s = common.einsum("bhgd,bhkd->bhgk", qg.to(torch.float32),
                      k_cache.to(torch.float32)) * scale
    idx = replicate_like(q, torch.arange(S, device=q.device))[
        None, None, None, :]
    cur = replicate_like(q, pos_b)[:, None, None, None]
    if ring:
        last = cur - 1  # index of the newest token (already inserted)
        slot_pos = last - torch.remainder(last - idx, S)
        valid = slot_pos >= 0
    else:
        valid = idx < cur
        if window is not None:
            valid = valid & (idx >= (cur - window))
    s = torch.where(valid, s, NEG_INF)
    p = common.softmax(s, dim=-1)
    out = common.einsum("bhgk,bhkd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(B, Hq, -1).to(v_cache.dtype)


def _write_slot(cache, new, onehot):
    """The cache with ``new`` in the slots ``onehot`` marks: a select, as the
    reference's ``jnp.where`` is, so the input cache is left unchanged."""
    return torch.where(onehot, new.to(cache.dtype), cache)


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
    q = whole_groups(q, -1, H).reshape(B, S, H, hd).permute(0, 2, 1, 3)
    k = whole_groups(k, -1, Hkv).reshape(B, S, Hkv, hd).permute(0, 2, 1, 3)
    v = whole_groups(v, -1, Hkv).reshape(B, S, Hkv, hd).permute(0, 2, 1, 3)
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
        q = constrain(q, "batch", "heads", "seq", None)
        k = constrain(k, "batch", "kv_heads", "seq", None)
        v = constrain(v, "batch", "kv_heads", "seq", None)
    with scope("mix"):
        o = flash_attention(q, k, v, causal=causal, window=window)
        o = constrain(o, "batch", "heads", "seq", None)
    with scope("proj"):
        o = whole_groups(o.permute(0, 2, 1, 3).reshape(B, S, -1), -1,
                         cfg.n_heads)
        out = o @ p["wo"].to(x.dtype)
        out = constrain(out, "batch", "seq", "embed")
    return out, (k, v)


def gqa_decode(p, x1, cache, pos, cfg: ArchConfig, *,
               window: Optional[int] = None, positions3=None):
    """x1: (B, 1, d); cache: dict(k=(B,Hkv,S,hd), v=...). pos: scalar or
    (B,) count of tokens already in each slot's cache (ragged decode writes
    each lane at its own cursor). When the cache was allocated ring-sized
    (S == window < requested seq_len) the slot is pos mod S; a non-ring
    cursor past the cache end simply doesn't write (dead serving lanes).
    Returns ``(out (B,1,d), new cache)``."""
    B = x1.shape[0]
    S_cache = cache["k"].shape[2]
    ring = window is not None and S_cache == window
    pos_b = _cursors(pos, B, x1.device)
    if cfg.rope_type == "mrope" and positions3 is None:
        positions3 = pos_b[None, :, None].expand(3, B, 1)
    positions = pos_b[:, None]
    q, k, v = _project_qkv(
        p, x1, cfg, positions3 if cfg.rope_type == "mrope" else positions)
    slot = torch.remainder(pos_b, S_cache) if ring else pos_b
    onehot = (replicate_like(cache["k"], torch.arange(
        S_cache, device=x1.device))[None, :]
              == replicate_like(cache["k"], slot)[:, None])[
        :, None, :, None]                                   # (B,1,S,1)
    k_cache = _write_slot(cache["k"], k, onehot)
    v_cache = _write_slot(cache["v"], v, onehot)
    o = decode_attention(q[:, :, 0], k_cache, v_cache, pos_b + 1,
                         window=None if ring else window, ring=ring)
    out = o.reshape(B, 1, -1) @ p["wo"].to(x1.dtype)
    return out, {"k": k_cache, "v": v_cache}


def gqa_init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype,
                   device, window: Optional[int] = None):
    """``window``: allocate a ring buffer of that size instead of the full
    sequence (sliding-window layers never need more)."""
    S = min(seq_len, window) if window else seq_len
    shape = (batch, cfg.n_kv_heads, S, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
        q = constrain(q, "batch", "heads", "seq", None)
        k = constrain(k, "batch", "heads", "seq", None)
        v = constrain(v, "batch", "heads", "seq", None)
    with scope("mla_mix"):
        scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
        o = flash_attention(q, k, v, causal=True, scale=scale)
    with scope("mla_proj"):
        o = o.permute(0, 2, 1, 3).reshape(B, S, H * m.v_head_dim)
        out = o @ p["wo"].to(x.dtype)
    return out, (c_kv, k_rope)


def mla_decode(p, x1, cache, pos, cfg: ArchConfig):
    """Absorbed-form decode: the cache holds only (c_kv, k_rope). pos:
    scalar or (B,) per-slot cursor, matching ``gqa_decode``."""
    m = cfg.mla
    B = x1.shape[0]
    H = cfg.n_heads
    pos_b = _cursors(pos, B, x1.device)
    positions = pos_b[:, None]
    q_nope, q_rope = _mla_q(p, x1, cfg, positions)     # (B,H,1,dn),(B,H,1,dr)
    c_new, kr_new = _mla_latent(p, x1, cfg, positions)
    S = cache["c_kv"].shape[1]
    pos_b = replicate_like(cache["c_kv"], pos_b)
    onehot = (replicate_like(pos_b, torch.arange(S, device=x1.device))[
        None, :] == pos_b[:, None])[..., None]                  # (B,S,1)
    c_cache = _write_slot(cache["c_kv"], c_new, onehot)
    r_cache = _write_slot(cache["k_rope"], kr_new, onehot)

    # kv_up columns interleave [nope | v] per head
    w_up = p["kv_up"].reshape(m.kv_lora, H, m.nope_head_dim + m.v_head_dim)
    w_uk = w_up[..., :m.nope_head_dim]
    w_uv = w_up[..., m.nope_head_dim:]
    f32 = torch.float32
    # absorb W_uk into q: (B,H,dn) x (kv_lora,H,dn) -> (B,H,kv_lora)
    q_lat = common.einsum("bhd,lhd->bhl", q_nope[:, :, 0].to(f32),
                          w_uk.to(f32))
    s = common.einsum("bhl,bsl->bhs", q_lat, c_cache.to(f32))
    s = s + common.einsum("bhd,bsd->bhs", q_rope[:, :, 0].to(f32),
                          r_cache.to(f32))
    s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    idx = replicate_like(pos_b, torch.arange(S, device=x1.device))
    s = torch.where(idx[None, None, :] <= pos_b[:, None, None], s, NEG_INF)
    pr = common.softmax(s, dim=-1)
    ctx_lat = common.einsum("bhs,bsl->bhl", pr, c_cache.to(f32))
    o = common.einsum("bhl,lhd->bhd", ctx_lat, w_uv.to(f32))
    out = (o.reshape(B, 1, H * m.v_head_dim).to(x1.dtype)
           @ p["wo"].to(x1.dtype))
    return out, {"c_kv": c_cache, "k_rope": r_cache}


def mla_init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, device):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, seq_len, m.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, seq_len, m.rope_head_dim), dtype=dtype,
                              device=device),
    }
