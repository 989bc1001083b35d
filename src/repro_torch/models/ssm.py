"""State-space sequence mixers: Mamba (Hymba's parallel SSM heads) and
RWKV-6 "Finch" (data-dependent decay linear attention) — the
training/prefill paths.

Both are linear recurrences run over the sequence in chunks of 64 tokens,
token by token inside a chunk, as the reference package scans them (an
outer ``lax.scan`` over chunks, an inner one over steps). Here the two
loops are Python loops marked as nested ``loop_body`` frames: every chunk
shares one set of quantize sites and every step inside it another, as the
reference's scanned bodies do, and neither inner loop is ever a trajectory
step. The recurrence is plain tensor code, not the WKV6 kernel: the
reference's model does not call its kernel either, and the site lists must
stay the reference's. Every step is written from the reference's
elementary operations, in its order, conversions included.

Decode carries O(1)-per-token state: Mamba's last ``conv_width - 1``
inputs and its (B, di, N) state, RWKV-6's token-shift rows and its
(B, H, hd, hd) state. Mamba's decode is one step of the recurrence; RWKV-6's
is ``_rwkv6_mix`` at S = 1 (a chunk of one token), as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.interpreter import (
    loop_body, loop_const, zero_cotangents,
)
from repro_torch.distributed.sharding import on_shards, replicate_like
from repro_torch.models import common
from repro_torch.models.common import ParamDef

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — Hymba's parallel-head branch
# ---------------------------------------------------------------------------

def mamba_param_defs(cfg: ArchConfig) -> dict:
    sc = cfg.ssm
    d = cfg.d_model
    di = sc.expand * d
    dt_rank = sc.dt_rank or -(-d // 16)
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "in_proj": ParamDef((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamDef((sc.conv_width, di), ("conv", "mlp"), scale=0.1),
        "conv_b": ParamDef((di,), ("mlp",), init="zeros"),
        "x_proj": ParamDef((di, dt_rank + 2 * sc.state_dim), ("mlp", None)),
        "dt_proj": ParamDef((dt_rank, di), (None, "mlp"), scale=0.1),
        "dt_bias": ParamDef((di,), ("mlp",), init="zeros"),
        "a_log": ParamDef((di, sc.state_dim), ("mlp", "state"), init="zeros"),
        "d_skip": ParamDef((di,), ("mlp",), init="ones"),
        "out_proj": ParamDef((di, d), ("mlp", "embed"), scale=o_scale),
    }


_CHUNK = 64      # the scans' chunk length


def _chunks(S: int):
    c = min(_CHUNK, S)
    assert S % c == 0, (S, c)
    return c, S // c


def _mamba_core(p, xz, cfg: ArchConfig, conv_state, ssm_state, *,
                decode: bool):
    """xz: (B, S, 2*di). Returns (y (B,S,di), conv_state, ssm_state).
    ``decode``: S = 1, and the convolution reads the carried
    ``conv_state`` (the last W-1 inputs) instead of zero padding."""
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    dt_rank = sc.dt_rank or -(-cfg.d_model // 16)
    x, z = torch.chunk(xz, 2, dim=-1)
    B_, S, _ = x.shape

    # causal depthwise conv (width W): the state carries the last W-1 inputs
    W = sc.conv_width
    if decode:
        hist = torch.cat([conv_state, x], dim=1)                # (B, W, di)
        new_conv_state = hist[:, 1:]
        xc = common.einsum("bwd,wd->bd", hist,
                           p["conv_w"].to(x.dtype))[:, None]
    else:
        pad = replicate_like(x, torch.zeros((B_, W - 1, di), dtype=x.dtype,
                                            device=x.device))
        hist = torch.cat([pad, x], dim=1)
        new_conv_state = hist[:, S:]                            # last W-1
        xc = sum(hist[:, i:i + S] * p["conv_w"][i].to(x.dtype)
                 for i in range(W))
    xc = common.silu(xc + p["conv_b"].to(x.dtype))

    proj = xc @ p["x_proj"].to(x.dtype)                         # (B,S,r+2N)
    dt_r, Bc, Cc = torch.split(proj, [dt_rank, sc.state_dim, sc.state_dim],
                               dim=-1)
    dt = common.softplus(dt_r @ p["dt_proj"].to(x.dtype)
                         + p["dt_bias"].to(x.dtype))            # (B,S,di)
    A = -torch.exp(p["a_log"].to(_F32))                         # (di,N)

    if decode:
        # one step of the recurrence
        da = torch.exp(dt.to(_F32)[..., None] * A)              # (B,1,di,N)
        db_x = (dt.to(_F32) * xc.to(_F32))[..., None] \
            * Bc.to(_F32)[..., None, :]
        h = ssm_state.to(_F32)
        c_t = Cc.to(_F32)[:, 0]
        ssm_state = da[:, 0] * h + db_x[:, 0]                   # (B,di,N)
        y = common.einsum("bdn,bn->bd", ssm_state, c_t)[:, None].to(x.dtype)
        y = y + xc * p["d_skip"].to(x.dtype)
    else:
        # the recurrence acts channel by channel: on a mesh each rank runs
        # it on its channels (and its batch rows)
        y, ssm_state = on_shards("mamba_scan", _selective_scan,
                                 (dt, xc, Bc, Cc, A, ssm_state, p["d_skip"]),
                                 "bsd,bsd,bsn,bsn,dn,bdn,d", "bsd,bdn",
                                 repeats=("s", _CHUNK))
    y = y * common.silu(z)
    return y, new_conv_state, ssm_state


def _selective_scan(dt, xc, Bc, Cc, A, h, d_skip):
    """The selective scan over (B, S, di) inputs from ``h`` (B, di, N),
    with its skip term: ``(y (B, S, di), final state)``. Chunked over the
    sequence, token by token inside a chunk; each loop's inputs come from
    one split / unbind: the reference's scans stack their inputs'
    cotangents, where per-trip slices would sum them (``add_any`` sites it
    does not have). The skip term reads ``xc`` here too, so on a mesh its
    two cotangents are summed on each rank's pieces, where the scan's
    delivers its term, as in the global run."""
    c, _ = _chunks(dt.shape[1])
    h = h.to(_F32)
    ys = []
    for dt_c, xc_c, b_c, cc_c in zip(*(torch.split(t, c, dim=1)
                                       for t in (dt, xc, Bc, Cc))):
        with loop_body("chunk"):
            da = torch.exp(dt_c.to(_F32)[..., None]
                           * loop_const(A))                     # (B,c,di,N)
            dbx = (dt_c.to(_F32) * xc_c.to(_F32))[..., None] \
                * b_c.to(_F32)[..., None, :]
            for da_t, dbx_t, c_t in zip(da.unbind(1), dbx.unbind(1),
                                        cc_c.to(_F32).unbind(1)):
                with loop_body("step"):
                    h = da_t * h + dbx_t                        # (B,di,N)
                    ys.append(common.einsum("bdn,bn->bd", h, c_t))
    # the final carry's and ``A``'s cotangent sums start at zero, as the
    # reference's scan transposes start them
    y = zero_cotangents(torch.stack(ys, dim=1), h, A).to(xc.dtype)
    return y + xc * d_skip.to(xc.dtype), h


def mamba_forward(p, x, cfg: ArchConfig):
    """Training/prefill: x (B,S,d) -> (y (B,S,di->d), final states)."""
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    B = x.shape[0]
    xz = x @ p["in_proj"].to(x.dtype)
    ssm0 = replicate_like(xz, torch.zeros((B, di, sc.state_dim), dtype=_F32,
                                          device=x.device))
    y, conv_state, ssm_state = _mamba_core(p, xz, cfg, None, ssm0,
                                           decode=False)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"conv": conv_state, "ssm": ssm_state}


def mamba_decode(p, x1, cache, cfg: ArchConfig):
    """One token: x1 (B,1,d), cache {conv (B,W-1,di), ssm (B,di,N) f32}."""
    xz = x1 @ p["in_proj"].to(x1.dtype)
    y, conv_state, ssm_state = _mamba_core(
        p, xz, cfg, cache["conv"], cache["ssm"], decode=True)
    out = y @ p["out_proj"].to(x1.dtype)
    return out, {"conv": conv_state, "ssm": ssm_state}


def mamba_init_cache(cfg: ArchConfig, batch: int, dtype, device):
    sc = cfg.ssm
    di = sc.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, sc.conv_width - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, sc.state_dim), dtype=_F32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

_LORA_DIM = 64


def _heads(cfg: ArchConfig, d: int):
    H = cfg.n_heads if cfg.n_heads else d // 64
    return H, d // H


def rwkv6_param_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    H, hd = _heads(cfg, d)
    return {
        # token-shift interpolation vectors for r,k,v,w,g
        "mu": ParamDef((5, d), (None, "embed"), scale=0.1),
        "wr": ParamDef((d, d), ("embed", "heads")),
        "wk": ParamDef((d, d), ("embed", "heads")),
        "wv": ParamDef((d, d), ("embed", "heads")),
        "wg": ParamDef((d, d), ("embed", "heads")),
        # data-dependent decay LoRA:  w = exp(-exp(w0 + tanh(x A) B))
        "w0": ParamDef((d,), ("embed",), init="zeros"),
        "w_a": ParamDef((d, _LORA_DIM), ("embed", None), scale=0.1),
        "w_b": ParamDef((_LORA_DIM, d), (None, "embed"), scale=0.1),
        "bonus": ParamDef((H, hd), ("heads", None), scale=0.1),
        "ln_scale": ParamDef((d,), ("embed",), init="ones"),
        "wo": ParamDef((d, d), ("heads", "embed"), scale=o_scale),
    }


def _rwkv6_mix(p, x, x_prev, cfg: ArchConfig, state):
    """Sequence mix. x: (B,S,d); x_prev: (B,1,d) last token of the previous
    chunk (token shift); state: (B,H,hd,hd) f32. Returns (y, x_last, state)."""
    B, S, d = x.shape
    H, hd = _heads(cfg, d)

    xs = torch.cat([x_prev, x[:, :-1]], dim=1)                  # shifted
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))

    r = (xr @ p["wr"].to(x.dtype)).reshape(B, S, H, hd)
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, S, H, hd)
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, S, H, hd)
    g = common.silu(xg @ p["wg"].to(x.dtype))

    w_log = p["w0"].to(_F32) + common.tanh(
        xw.to(_F32) @ p["w_a"].to(_F32)) @ p["w_b"].to(_F32)
    w = torch.exp(-torch.exp(w_log)).reshape(B, S, H, hd)       # decay in (0,1)
    u = p["bonus"].to(_F32)                                     # (H,hd)

    # the recurrence acts head by head: on a mesh each rank runs it on its
    # heads (and its batch rows)
    y, state = on_shards("rwkv6_scan", _wkv_scan, (r, k, v, w, u, state),
                         "bshi,bshi,bshi,bshi,hi,bhij", "bshi,bhij",
                         repeats=("s", _CHUNK))
    y = y.reshape(B, S, d)

    # per-head group norm (RWKV uses GroupNorm(H); rms per head here)
    yh = y.reshape(B, S, H, hd).to(_F32)
    yh = yh * torch.rsqrt((yh * yh).sum(dim=-1, keepdim=True) / hd + 1e-5)
    y = (yh.reshape(B, S, d) * p["ln_scale"].to(_F32)).to(x.dtype)
    y = y * g
    out = y @ p["wo"].to(x.dtype)
    return out, x[:, -1:], state


def _wkv_scan(r, k, v, w, u, state):
    """The WKV recurrence over (B, S, H, hd) inputs from ``state`` (B, H,
    hd, hd): ``(y (B, S, H, hd) f32, final state)``. Chunked over the
    sequence (the reference's chunk structure), token by token inside a
    chunk; each input is widened once, as the reference's chunking of (r, k,
    v, w) does, and the steps read ``unbind``'s slices, whose cotangents are
    stacked as the reference's scanned inputs' are (a ``select`` per step
    would sum them, one ``add_any`` per step)."""
    c, nch = _chunks(r.shape[1])
    r, k, v, w = (t.to(_F32).unbind(1) for t in (r, k, v, w))
    # ``u`` is a const of both scans: its cotangent sums over a chunk's
    # steps and over the chunks start at zero, as does the final state's
    s = state.to(_F32)
    ys = []
    for ci in range(nch):
        with loop_body("chunk"):
            u_c = loop_const(u)
            for t in range(ci * c, (ci + 1) * c):
                with loop_body("step"):
                    r_t, k_t, v_t, w_t = r[t], k[t], v[t], w[t]
                    kv = k_t[..., :, None] * v_t[..., None, :]  # (B,H,hd,hd)
                    ys.append(common.einsum(
                        "bhi,bhij->bhj", r_t,
                        s + loop_const(u_c)[..., None] * kv))
                    s = w_t[..., None] * s + kv
            s = zero_cotangents(s, u_c)
    return zero_cotangents(torch.stack(ys, dim=1), s, u), s


def rwkv6_channel_defs(cfg: ArchConfig) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    o_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "mu": ParamDef((2, d), (None, "embed"), scale=0.1),
        "wk": ParamDef((d, dff), ("embed", "mlp")),
        "wv": ParamDef((dff, d), ("mlp", "embed"), scale=o_scale),
        "wr": ParamDef((d, d), ("embed", None)),
    }


def rwkv6_channel_mix(p, x, x_prev, cfg: ArchConfig):
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = common.square(common.relu(xk @ p["wk"].to(x.dtype)))
    kv = k @ p["wv"].to(x.dtype)
    return common.sigmoid(xr @ p["wr"].to(x.dtype)) * kv, x[:, -1:]


def rwkv6_init_state(cfg: ArchConfig, batch: int, dtype, device):
    d = cfg.d_model
    H, hd = _heads(cfg, d)
    return {
        "tm_state": torch.zeros((batch, H, hd, hd), dtype=_F32,
                                device=device),
        "tm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
    }
