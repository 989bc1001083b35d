"""Decoder stack: embeds -> layers -> norm -> logits.

One generic implementation hosts all decoder families of the reference:
  * dense GQA (glm4, deepseek-coder, internlm2, h2o-danube/SWA, qwen2-vl/M-RoPE)
  * MoE (olmoe; deepseek-v2 with MLA + shared experts + leading dense layers)
  * hybrid (hymba: parallel GQA-SWA + Mamba heads per layer, 3 global layers)
  * attn-free (rwkv6: time-mix + channel-mix)

Layers are stacked into a single (L, ...) parameter tree, as in the
reference package, and executed with a Python loop. Every module runs under
``scope(...)`` — these names are the truncation-policy surface of the
profiling engine (core/policy.py), and they are the reference's, letter for
letter: ``embed``, ``lead_layer{i}``, ``layer``, ``global_layer``,
``pre_norm``, ``attn/{qkv,mix,proj}``, ``attn/{mla_qkv,mla_mix,mla_proj}``,
``mamba``, ``time_mix``, ``channel_mix``, ``post_norm``, ``mlp``,
``moe/{router,dispatch,experts,combine,shared}``, ``final_norm``,
``logits``, ``loss``.

**Sites of repeated layers.** With ``scan_layers`` every stacked layer runs
under the one scope ``layer`` and shares its quantize sites (what scanning
the stack gives the reference), and each layer is one trajectory step; the
reference's several scan segments (hymba's, split by its global layers)
share one body too. The unrolled global layers run under ``global_layer``:
with ``remat`` the reference traces its ``jax.checkpoint``-ed global layer
once and every call re-uses that body, so here too they share one set of
sites; without ``remat`` each call is inlined with sites of its own, and
here each runs in a one-trip frame of its own. Without ``scan_layers`` the
scopes are ``layer0``, ``layer1``, … and the sites distinct.

**Remat.** The reference's ``remat`` wraps each scanned (and each global)
layer in ``jax.checkpoint``, and its blockwise attention checkpoints every q
chunk and every kv chunk whatever ``remat`` says. The port takes route (a):
the same regions run under ``core.interpreter.remat``, which is
``torch.utils.checkpoint`` (non-reentrant) when autograd records and a plain
call otherwise. The recompute re-enters the region's scopes on whatever
thread the autograd engine uses, with sites of its own, so a
differentiated loss has the reference's recomputed sites
(``tests/test_torch_grad_scopes.py``) and a full-depth train step keeps no
layer's activations but its input. The stacked layers are split once
(``unstack``): the stack's gradient is one stacking of the layers', as the
reference's scan transposes it.

**Decode** (``init_cache``, ``decode_step``) keeps the reference's scopes,
which are not the forward's: every stacked layer runs under ``layer`` (also
without ``scan_layers``, and hymba's global layers too), the attention,
Mamba and MLA decode paths open no scope of their own (no ``attn/...``, no
``mamba``), and ``embed``, ``final_norm`` and ``logits`` stay. Sites follow
the reference's traced program: a scan segment is one body (its layers
share sites, one trajectory step each), and each segment, each unrolled
global layer and, without ``scan_layers``, each layer is inlined code with
sites of its own (a one-trip frame here).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.core.interpreter import loop_body, remat, scope
from repro_torch.distributed.sharding import (
    constrain, lookup, settled, whole_over_data,
)
from repro_torch.models import attention, moe as moe_mod, ssm
from repro_torch.models.common import (
    ParamDef, ACTIVATIONS, rmsnorm, layernorm, map_defs, resolve_device,
    torch_dtype,
)


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
        h = constrain(h, "batch", "seq", "mlp")
        h = ACTIVATIONS[cfg.act](h)
        out = h @ p["wo"].to(x.dtype)
        return constrain(out, "batch", "seq", "embed")


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

def layer_param_defs(cfg: ArchConfig, kind: str) -> dict:
    """kind: 'dense' | 'moe' | 'dense_lead' — which feed-forward the layer
    carries."""
    defs: Dict[str, Any] = {"norm1": norm_defs(cfg), "norm2": norm_defs(cfg)}
    if cfg.attn_type == "gqa":
        defs["attn"] = attention.gqa_param_defs(cfg)
    elif cfg.attn_type == "mla":
        defs["attn"] = attention.mla_param_defs(cfg)
    elif cfg.attn_type == "hymba":
        defs["attn"] = attention.gqa_param_defs(cfg)
        defs["mamba"] = ssm.mamba_param_defs(cfg)
        defs["branch_norm_attn"] = ParamDef((cfg.d_model,), ("embed",),
                                            init="ones")
        defs["branch_norm_ssm"] = ParamDef((cfg.d_model,), ("embed",),
                                           init="ones")
        defs["branch_beta"] = ParamDef((2,), (None,), init="ones")
    elif cfg.attn_type == "rwkv6":
        defs["time_mix"] = ssm.rwkv6_param_defs(cfg)
    else:
        raise ValueError(cfg.attn_type)

    if cfg.attn_type == "rwkv6":
        defs["channel_mix"] = ssm.rwkv6_channel_defs(cfg)
    elif kind == "moe":
        defs["moe"] = moe_mod.moe_param_defs(cfg)
    else:
        d_ff = cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense and
                                      kind == "dense_lead") else cfg.d_ff
        defs["mlp"] = mlp_param_defs(cfg, d_ff)
    return defs


def _seq_mix(cfg: ArchConfig, p, x, positions, is_global, mix_state,
             decode: bool, pos):
    """The sequence-mixing block. Returns ``(y, new_mix_state)``.
    ``is_global=True`` lifts the sliding window (global-attention layers run
    as their own unrolled segments, so the window stays static and the flash
    path skips out-of-window KV blocks). ``decode``: one token against
    ``mix_state`` (the layer's cache) at the per-slot cursors ``pos``."""
    if cfg.attn_type == "gqa":
        window = None if is_global else cfg.sliding_window
        if decode:
            return attention.gqa_decode(p["attn"], x, mix_state, pos, cfg,
                                        window=window)
        with scope("attn"):
            y, _ = attention.gqa_forward(p["attn"], x, cfg,
                                         positions=positions, window=window)
        return y, mix_state

    if cfg.attn_type == "mla":
        if decode:
            return attention.mla_decode(p["attn"], x, mix_state, pos, cfg)
        with scope("attn"):
            y, _ = attention.mla_forward(p["attn"], x, cfg,
                                         positions=positions)
        return y, mix_state

    if cfg.attn_type == "hymba":
        window = None if is_global else cfg.sliding_window
        if decode:
            ya, kv = attention.gqa_decode(p["attn"], x, mix_state["kv"], pos,
                                          cfg, window=window)
            ym, ms = ssm.mamba_decode(p["mamba"], x, mix_state["mamba"], cfg)
            new_state = {"kv": kv, "mamba": ms}
        else:
            with scope("attn"):
                ya, _ = attention.gqa_forward(p["attn"], x, cfg,
                                              positions=positions,
                                              window=window)
            with scope("mamba"):
                ym, _ = ssm.mamba_forward(p["mamba"], x, cfg)
            new_state = mix_state
        ya = rmsnorm(ya, p["branch_norm_attn"], cfg.norm_eps)
        with loop_body("branch_norm_ssm", once=True):   # sites of its own
            ym = rmsnorm(ym, p["branch_norm_ssm"], cfg.norm_eps)
        beta = p["branch_beta"].to(x.dtype)
        return 0.5 * (beta[0] * ya + beta[1] * ym), new_state

    if cfg.attn_type == "rwkv6":
        with scope("time_mix"):
            if decode:
                y, x_last, s = ssm._rwkv6_mix(
                    p["time_mix"], x, mix_state["tm_shift"], cfg,
                    mix_state["tm_state"])
                return y, dict(mix_state, tm_shift=x_last, tm_state=s)
            B = x.shape[0]
            x_prev = torch.zeros((B, 1, x.shape[-1]), dtype=x.dtype,
                                 device=x.device)
            hd = cfg.d_model // cfg.n_heads
            s0 = torch.zeros((B, cfg.n_heads, hd, hd), dtype=torch.float32,
                             device=x.device)
            y, _, _ = ssm._rwkv6_mix(p["time_mix"], x, x_prev, cfg, s0)
            return y, mix_state

    raise ValueError(cfg.attn_type)


def layer_forward(cfg: ArchConfig, p, x, positions, kind: str = "dense",
                  is_global=None, mix_state=None, decode: bool = False,
                  pos=None):
    """One decoder layer. Returns ``(x, new_mix_state)``."""
    with scope("pre_norm"):
        h = apply_norm(p["norm1"], x, cfg)
    y, new_state = _seq_mix(cfg, p, h, positions, is_global, mix_state,
                            decode, pos)
    x = x + y
    with scope("post_norm"):
        h = apply_norm(p["norm2"], x, cfg)
    if cfg.attn_type == "rwkv6":
        with scope("channel_mix"):
            if decode:
                y2, cm_last = ssm.rwkv6_channel_mix(
                    p["channel_mix"], h, new_state["cm_shift"], cfg)
                new_state = dict(new_state, cm_shift=cm_last)
            else:
                x_prev = torch.zeros((h.shape[0], 1, h.shape[-1]),
                                     dtype=h.dtype, device=h.device)
                y2, _ = ssm.rwkv6_channel_mix(p["channel_mix"], h, x_prev,
                                              cfg)
    elif "moe" in p:
        with scope("moe"):
            y2 = moe_mod.moe_forward(p["moe"], h, cfg)
    else:
        y2 = mlp_forward(p["mlp"], h, cfg)
    return x + y2, new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _n_lead(cfg: ArchConfig) -> int:
    return cfg.moe.first_k_dense if cfg.moe else 0


def _stack_kind(cfg: ArchConfig) -> str:
    return "moe" if cfg.moe else "dense"


def stacked(defs, n: int):
    """Prepend a layer-stack dim of ``n`` to every ParamDef of ``defs``."""
    return map_defs(lambda pd: ParamDef((n,) + pd.shape, ("layers",) + pd.axes,
                                        pd.init, pd.scale), defs)


def model_param_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    n_lead = _n_lead(cfg)
    n_stack = cfg.n_layers - n_lead
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_defs(cfg),
        "layers": stacked(layer_param_defs(cfg, _stack_kind(cfg)), n_stack),
    }
    if n_lead:
        defs["lead_layers"] = [layer_param_defs(cfg, "dense_lead")
                               for _ in range(n_lead)]
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab), ("embed", "vocab"),
                                   scale=0.02)
    return defs


def segments(cfg: ArchConfig):
    """Execution plan over the stacked layers: homogeneous ("scan", lo, hi)
    runs + unrolled ("global", idx, idx + 1) layers (hymba's full-attention
    layers). Keeps per-segment sliding windows static so the flash path can
    skip out-of-window KV blocks."""
    n_stack = cfg.n_layers - _n_lead(cfg)
    globals_ = sorted(i - _n_lead(cfg) for i in cfg.global_layers
                      if i >= _n_lead(cfg))
    if cfg.sliding_window is None or not globals_:
        return [("scan", 0, n_stack)]
    segs = []
    prev = 0
    for g in globals_:
        if g > prev:
            segs.append(("scan", prev, g))
        segs.append(("global", g, g + 1))
        prev = g + 1
    if prev < n_stack:
        segs.append(("scan", prev, n_stack))
    return segs


def _tree_index(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int):
    """The ``n`` layers of a stacked tree, split once (``torch.unbind``):
    the gradient of the stack is then one stacking of the layers' gradients,
    what the reference's scan transposes to, not ``n - 1`` accumulations of
    per-layer selects."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return torch.unbind(tree)


def _embed_inputs(params, batch, cfg: ArchConfig):
    """tokens -> embeddings, or pass through stub-frontend embeddings."""
    dtype = torch_dtype(cfg.dtype)
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(dtype)
    else:
        with scope("embed"):
            x = lookup(params["embed"].to(dtype), batch["tokens"])
    return constrain(x, "batch", "seq", "embed")


def _positions(batch, cfg: ArchConfig, S: int, B: int, device):
    """(B, S) token positions, or (3, B, S) t/h/w streams for M-RoPE (from
    ``batch["positions"]`` where the frontend gives them)."""
    if cfg.rope_type == "mrope":
        if "positions" in batch:
            return batch["positions"]
        return torch.arange(S, dtype=torch.int32,
                            device=device)[None, None].expand(3, B, S)
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(params, batch, cfg: ArchConfig, last_only: bool = False):
    """Full forward to logits. batch: tokens or embeds (+labels elsewhere;
    ``positions`` (3, B, S) for M-RoPE). ``last_only`` computes the LM head
    for the final position only (prefill fast path: avoids materializing
    (B, S, vocab) logits)."""
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    positions = _positions(batch, cfg, S, B, x.device)

    for i in range(_n_lead(cfg)):
        with scope(f"lead_layer{i}"):
            x, _ = layer_forward(cfg,
                                 whole_over_data(params["lead_layers"][i]),
                                 x, positions, "dense_lead", is_global=None)

    stack, n_stack = params["layers"], cfg.n_layers - _n_lead(cfg)
    kind = _stack_kind(cfg)

    def body(is_global):
        def run(x, p_l):
            # FSDP gathers a layer's weights where it runs them
            return layer_forward(cfg, whole_over_data(p_l), x, positions,
                                 kind, is_global=is_global)[0]
        return run

    if cfg.scan_layers:
        segs = segments(cfg)
        for seg, lo, hi in segs:
            if seg == "scan":
                # as the reference scans a slice of the stack per segment
                # (and indexes it for a global layer), the stack's
                # cotangent is the sum of the segments' (``add_any`` sites
                # at the root); one segment is the whole stack, unsliced
                part = (stack if len(segs) == 1
                        else pytree.tree_map(lambda t: t[lo:hi], stack))
                for p_l in unstack(part, hi - lo):
                    # one layer is one trip of the reference's scan: one
                    # trajectory step here
                    with scope("layer", loop=True):
                        x = _maybe_remat(cfg, body(False), x, p_l)
            else:
                p_l = _tree_index(stack, lo)
                with _global_frame(cfg, lo, x, p_l), scope("global_layer"):
                    x = _maybe_remat(cfg, body(True), x, p_l)
    else:
        layers = unstack(stack, n_stack)
        globals_set = {i - _n_lead(cfg) for i in cfg.global_layers}
        for i in range(n_stack):
            with scope(f"layer{i}"):
                x = body(i in globals_set)(x, layers[i])

    if last_only:
        x = x[:, -1:]
    with scope("final_norm"):
        x = apply_norm(whole_over_data(params["final_norm"]), x, cfg)
    with scope("logits"):
        head = whole_over_data(params["embed"].T if cfg.tie_embeddings
                               else params["lm_head"])
        logits = x.to(torch.float32) @ head.to(torch.float32)
        logits = constrain(logits, "batch", "seq", "vocab")
    return logits


def _maybe_remat(cfg: ArchConfig, fn, *args):
    """A scanned or global layer under ``remat``: recomputed in the backward
    pass, as the reference's ``jax.checkpoint``-ed scan body is."""
    return remat(fn, *args) if cfg.remat else fn(*args)


def _global_frame(cfg: ArchConfig, idx: int, x, p_l):
    """Each global layer has sites of its own without ``remat``. Under it
    the reference calls one checkpointed function: in a program autograd
    does not record the calls share one traced body, and in one it does
    each call's forward is its own while the backward and the recompute
    stay one (``loop_body(..., shared_grad=True)``)."""
    if not cfg.remat:
        return loop_body(f"global{idx}", once=True)
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *pytree.tree_leaves(p_l)])):
        return contextlib.nullcontext()
    return loop_body(f"global{idx}", once=True, shared_grad=True)


def token_nll(logits, labels, mask=None):
    """Mean token cross-entropy (f32), log-sum-exp written out from the
    reference's elementary steps (``jax.nn.logsumexp``): the shift by the
    maximum carries no gradient (a non-finite maximum shifts by 0), and the
    log is taken of ``|sumexp|``."""
    amax = logits.amax(dim=-1, keepdim=True)
    # finite iff |x| < inf (not NaN): torch.isfinite dispatches a ``mul``,
    # which the counters would charge to the loss
    amax = torch.where(amax.abs() < math.inf, amax, 0.0).detach()
    sumexp = torch.exp(logits - amax).sum(dim=-1)
    logz = torch.log(torch.abs(sumexp)) + amax[..., 0]
    # over vocab-sharded logits each rank gathers the labels its shard
    # holds: the terms are summed before the select below
    gold = settled(torch.gather(logits, -1,
                                labels[..., None].to(torch.int64)))
    nll = logz - gold[..., 0]
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / nll.numel()


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean token cross-entropy (f32)."""
    logits = forward(params, batch, cfg)
    with scope("loss"):
        return token_nll(logits, batch["labels"], batch.get("mask"))


def prefill(params, batch, cfg: ArchConfig):
    """Inference forward over a full prompt; returns last-token logits."""
    logits = forward(params, batch, cfg, last_only=True)
    return logits[:, 0]


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype,
                     device, window=None):
    if cfg.attn_type == "gqa":
        return attention.gqa_init_cache(cfg, batch, seq_len, dtype, device,
                                        window=window)
    if cfg.attn_type == "mla":
        return attention.mla_init_cache(cfg, batch, seq_len, dtype, device)
    if cfg.attn_type == "hymba":
        return {"kv": attention.gqa_init_cache(cfg, batch, seq_len, dtype,
                                               device, window=window),
                "mamba": ssm.mamba_init_cache(cfg, batch, dtype, device)}
    if cfg.attn_type == "rwkv6":
        return ssm.rwkv6_init_state(cfg, batch, dtype, device)
    raise ValueError(cfg.attn_type)


def _stack_caches(one, n):
    return pytree.tree_map(lambda t: t[None].expand((n,) + t.shape).clone(),
                           one)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device=None):
    """Stacked (L, ...) cache tree (+ per-lead-layer caches), on ``device``
    (``None`` = the CUDA device; raises if there is none).

    Sliding-window layers get RING caches sized min(seq_len, window).
    Global-attention layers (hymba) keep full-length caches in a separate
    ``global`` list aligned with the execution segments; deepseek-v2's dense
    lead layers keep theirs in a ``lead`` list.

    ``pos`` is a (batch,) per-slot cursor so a continuous-batching server
    can prefill one slot while others decode; aligned decode simply keeps
    all lanes equal."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    n_lead = _n_lead(cfg)
    n_stack = cfg.n_layers - n_lead
    win = cfg.sliding_window
    n_globals = sum(1 for k, _, _ in segments(cfg) if k == "global")
    cache: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    one = init_layer_cache(cfg, batch, seq_len, dtype, device, window=win)
    cache["layers"] = _stack_caches(one, n_stack - n_globals)
    if n_globals:
        cache["global"] = [init_layer_cache(cfg, batch, seq_len, dtype,
                                            device)
                           for _ in range(n_globals)]
    if n_lead:
        cache["lead"] = [init_layer_cache(cfg, batch, seq_len, dtype, device)
                         for _ in range(n_lead)]
    return cache


def cache_axes(cache):
    """The logical axes of every leaf of a GQA ``init_cache`` tree: the
    cursors ``("batch",)``, each key / value cache ``(batch, kv_heads,
    cache_seq, None)`` behind its stack axes. On a mesh the act rules lay
    the cache out over ``kv_heads`` (the model axis), as the attention's
    keys and values are (``gqa_forward``'s constraints)."""
    def axes(key, t):
        if isinstance(t, dict):
            return {k: axes(k, v) for k, v in t.items()}
        if isinstance(t, list):
            return [axes(key, v) for v in t]
        if key in ("k", "v"):
            return (None,) * (t.ndim - 4) + ("batch", "kv_heads",
                                             "cache_seq", None)
        if key == "pos":
            return ("batch",)
        raise NotImplementedError(f"cache leaf {key!r}: only the GQA "
                                  "caches are laid out on a mesh")
    return axes(None, cache)


def decode_step(params, cache, tokens, cfg: ArchConfig, embeds=None):
    """One decode step. tokens: (B,) int32 (or embeds (B,1,d) for stub
    frontends). Returns ``(logits (B, vocab), new cache)``; the input cache
    is left unchanged."""
    dtype = torch_dtype(cfg.dtype)
    pos = cache["pos"]
    if cfg.input_mode == "embeds" and embeds is not None:
        x = embeds.to(dtype)
    else:
        with scope("embed"):
            x = lookup(params["embed"].to(dtype), tokens)[:, None]
    x = constrain(x, "batch", "seq", "embed")

    new_pos = pos + 1
    new_lead = []
    if _n_lead(cfg):
        for i in range(_n_lead(cfg)):
            with scope(f"lead_layer{i}"):
                x, st = layer_forward(cfg, params["lead_layers"][i], x, None,
                                      "dense_lead", is_global=None,
                                      mix_state=cache["lead"][i],
                                      decode=True, pos=pos)
            new_lead.append(st)

    stack, kind = params["layers"], _stack_kind(cfg)

    def layer(i, x, cache_l, is_global, loop=False):
        with scope("layer", loop=loop):
            return layer_forward(cfg, _tree_index(stack, i), x, None, kind,
                                 is_global=is_global, mix_state=cache_l,
                                 decode=True, pos=pos)

    outs, new_globals = [], []
    if cfg.scan_layers:
        c_off = 0          # cursor into the compacted ring-cache stack
        for n, (seg, lo, hi) in enumerate(segments(cfg)):
            # each segment is a scan of its own body, each global layer
            # inlined code: sites of their own
            with loop_body(f"segment{n}", once=True):
                if seg == "scan":
                    for i in range(lo, hi):
                        x, st = layer(i, x,
                                      _tree_index(cache["layers"], c_off),
                                      False, loop=True)
                        outs.append(st)
                        c_off += 1
                else:
                    x, st = layer(lo, x, cache["global"][len(new_globals)],
                                  True)
                    new_globals.append(st)
    else:
        globals_set = {i - _n_lead(cfg) for i in cfg.global_layers}
        c_off = 0
        for i in range(cfg.n_layers - _n_lead(cfg)):
            with loop_body(f"layer{i}", once=True):     # inlined layers
                if i in globals_set and "global" in cache:
                    x, st = layer(i, x, cache["global"][len(new_globals)],
                                  True)
                    new_globals.append(st)
                    continue
                x, st = layer(i, x, _tree_index(cache["layers"], c_off),
                              i in globals_set)
            outs.append(st)
            c_off += 1
    # the keys in init_cache's order: the cache's input signature (which
    # the wrappers key their caches on) stays the same from step to step
    new_cache: Dict[str, Any] = {
        "pos": new_pos,
        "layers": pytree.tree_map(lambda *ts: torch.stack(ts), *outs)}
    if new_globals:
        new_cache["global"] = new_globals
    if new_lead:
        new_cache["lead"] = new_lead

    with scope("final_norm"):
        x = apply_norm(params["final_norm"], x, cfg)
    with scope("logits"):
        head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
        logits = x[:, 0].to(torch.float32) @ head.to(torch.float32)
        logits = constrain(logits, "batch", "vocab")
    return logits, new_cache
