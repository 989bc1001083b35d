"""Shared model building blocks: param definitions, norms, RoPE family.

Norms and activations are written from the same elementary ops as the
reference package's (square, sum, divide, ``rsqrt``, multiply; ``x *
sigmoid(x)``), not from fused library calls, so that the profiler's quantize
sites fall where the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.interpreter import _formulas_walk, scope, shared_body
from repro_torch.distributed.sharding import (
    _is_dtensor, einsum_layout, local_einsum, replicate_like,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: entry points never pick the CPU on their
    own. Raises when no CUDA device is there and none was asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# --------------------------------------------------------------------------
# parameter definitions: one source of truth for shape + logical axes + init
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == rank
    init: str = "normal"              # normal | zeros | ones
    scale: float = 0.02

    def initializer(self, generator, dtype, device):
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        t = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (t * self.scale).to(dtype)


def map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef of a nested dict/list of them."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: map_defs(fn, v) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return [map_defs(fn, v) for v in defs]
    raise TypeError(f"not a ParamDef tree: {type(defs).__name__}")


def init_tree(defs, generator: torch.Generator, dtype, device):
    """Initialize a tree of ParamDef into tensors on ``device``, drawing
    from ``generator`` (which must live on that device) in tree order, so a
    seed fixes every parameter."""
    return map_defs(lambda d: d.initializer(generator, dtype, device), defs)


def abstract_tree(defs, dtype):
    """Tensors on the ``meta`` device (shape and dtype, no storage) in
    place of every ParamDef: the dry-run's parameters."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def axes_tree(defs):
    """The logical axis names of every ParamDef."""
    return map_defs(lambda d: d.axes, defs)


def count_params(defs) -> int:
    total = 0

    def add(d):
        nonlocal total
        total += math.prod(d.shape)

    map_defs(add, defs)
    return total


def einsum(spec: str, a, b):
    """``torch.einsum`` under a scope named after its subscripts: the
    reference's ``jnp.einsum`` puts its contraction under exactly that name
    (``layer/attn/mix/bhgqd,bhkd->bhgqk``), and policies may address it.
    DTensor operands split over its batch labels only (heads, experts)
    run on each rank's shards (``sharding.local_einsum``); others are laid
    out for it by ``sharding.einsum_layout``."""
    with scope(spec):
        if _is_dtensor(a) or _is_dtensor(b):
            out = local_einsum(spec, a, b)
            if out is not None:
                return out
            a, b, lay_out = einsum_layout(spec, a, b)
            return lay_out(torch.einsum(spec, a, b))
        return torch.einsum(spec, a, b)


# --------------------------------------------------------------------------
# norms (f32 internal math regardless of activation dtype)
# --------------------------------------------------------------------------

def _mean_last(x):
    # sum then divide, the two operations the reference's mean is made of
    return x.sum(dim=-1, keepdim=True) / x.shape[-1]


def rmsnorm(x, scale, eps: float = 1e-5):
    with scope("rmsnorm"):
        xf = x.to(torch.float32)
        var = _mean_last(xf * xf)
        y = xf * torch.rsqrt(var + eps)
        return (y * scale.to(torch.float32)).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    with scope("layernorm"):
        xf = x.to(torch.float32)
        mu = _mean_last(xf)
        var = _var_last(xf)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * scale.to(torch.float32)
                + bias.to(torch.float32)).to(x.dtype)


def _var_last(x):
    """``jnp.var(x, axis=-1, keepdims=True)`` step for step, as the
    reference's jitted ``_var`` computes it: the mean, the squared
    deviations, ``n - ddof`` in the float type, and the NaN of its
    ``where(n - ddof > 0, ...)``."""
    with shared_body("_var", x) as (x,):
        sq = torch.square(x - _mean_last(x))
        ddof = torch.zeros((), dtype=torch.int32, device=x.device)
        denom = float(x.shape[-1]) - ddof.to(x.dtype)
        var = sq.sum(dim=-1, keepdim=True) / denom
        positive = denom > 0
        with shared_body("_where", positive, var) as (positive, var):
            nan = torch.full((), math.nan, dtype=x.dtype, device=x.device)
            return torch.where(positive, var, nan.to(x.dtype, copy=True))


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def silu(x):
    with shared_body("silu", x) as (x,):
        return x * torch.sigmoid(x)


def sigmoid(x):
    return torch.sigmoid(x)


def relu(x):
    return torch.relu(x)


def square(x):
    # ``pow(x, 2)``: the interpreter names it ``square``, as the reference's
    # ``jnp.square`` is
    return torch.square(x)


def _logaddexp0(x):
    amax = torch.clamp_min(x, 0.0)
    delta = x - 0.0
    is_nan = delta != delta
    total = x + 0.0
    tail = torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(is_nan, total, amax + tail)


def _finite_or_zero(t):
    return torch.where(t == math.inf, 0.0, t)


class _Softplus(torch.autograd.Function):
    """``logaddexp(x, 0)`` differentiated by the reference's custom JVP:
    the forward also computes the residual ``exp(x - out)`` and the zero
    operand's ``0 * exp(0 - out)`` (sub, exp, sub, exp, mul: sites of the
    forward), and the backward is the cotangent's one product with the
    residual. autograd's own formula goes through ``log1p``'s and ``abs``'s
    derivatives (a ``div`` and ``add_any`` sites the reference does not
    have)."""

    @staticmethod
    def forward(ctx, x):
        out = _logaddexp0(x)
        c = torch.exp(_finite_or_zero(x) - _finite_or_zero(out))
        0.0 * torch.exp(0.0 - _finite_or_zero(out))
        ctx.save_for_backward(c)
        return out

    @staticmethod
    def backward(ctx, g):
        (c,) = ctx.saved_tensors
        return g * c


def softplus(x):
    """The reference's ``logaddexp(x, 0)``, step for step: max, sub, add,
    abs, neg, exp, log1p, add, select. Differentiated in a walk that
    follows the reference's derivative formulas, by its JVP
    (``_Softplus``); a plain run keeps autograd's."""
    with shared_body("softplus", x) as (x,):
        if x.requires_grad and torch.is_grad_enabled() and _formulas_walk():
            return _Softplus.apply(x)
        return _logaddexp0(x)


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        t = torch.tanh(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        if not _formulas_walk():
            return torch.ops.aten.tanh_backward(g, t)
        e = g * (1 - t)
        return e + e * t


def tanh(x):
    """``jnp.tanh``. In a walk that follows the reference's derivative
    formulas its derivative is the reference's JVP: ``1 - t``, the
    cotangent's product with it, that product times ``t``, and their sum
    (``add_any``), each a site of the backward frame; autograd's, which a
    plain run keeps, is one fused op."""
    return _Tanh.apply(x)


def softmax(x, dim: int = -1):
    """The reference's ``jax.nn.softmax``: max, sub, exp, sum, div; the
    shift by the maximum carries no gradient (``stop_gradient`` there)."""
    unnormalized = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return unnormalized / unnormalized.sum(dim=dim, keepdim=True)


def swiglu(gate_up):
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return silu(gate) * up


def gelu(x):
    """tanh-approximated GELU, term for term the reference's."""
    inner = math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)
    return x * (0.5 * (1.0 + tanh(inner)))


ACTIVATIONS = {
    "swiglu": swiglu,                    # expects fused (…, 2*d_ff)
    "gelu": gelu,
    "relu": relu,
}


# --------------------------------------------------------------------------
# RoPE family: standard, partial, and M-RoPE (Qwen2-VL)
# --------------------------------------------------------------------------

def rope_freqs(rotary_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=device) / rotary_dim
    return torch.reciprocal(theta ** exponent)


def _rotate(x, sin, cos):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, *, theta: float = 1e4, fraction: float = 1.0):
    """x: (B, H, S, D); positions: (B, S) int. Rotary applied to the first
    ``fraction`` of D (GLM-4 uses 0.5)."""
    d = x.shape[-1]
    rd = int(d * fraction)
    rd -= rd % 2
    if rd == 0:
        return x
    # the rotary tables: every rank's whole, beside a sharded x
    inv = replicate_like(x, rope_freqs(rd, theta, x.device))       # (rd/2,)
    positions = replicate_like(x, positions)
    ang = positions.to(torch.float32)[:, None, :, None] * inv  # (B,1,S,rd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    xr, xp = x[..., :rd], x[..., rd:]
    xr = _rotate(xr.to(torch.float32), sin, cos).to(x.dtype)
    return torch.cat([xr, xp], dim=-1) if rd < d else xr


def apply_mrope(x, positions, *, theta: float, sections: Sequence[int]):
    """Multimodal RoPE (Qwen2-VL): ``positions`` is (3, B, S) for the
    temporal/height/width indices; ``sections`` split the rd/2 frequency
    channels among the three position streams (channel block i takes its
    angle from stream i)."""
    d = x.shape[-1]
    rd = 2 * sum(sections)
    assert rd <= d, (rd, d)
    inv = rope_freqs(rd, theta, x.device)                          # (rd/2,)
    ang_thw = positions.to(torch.float32)[:, :, None, :, None] * inv
    bounds = [0]
    for n in sections:
        bounds.append(bounds[-1] + n)
    ang = torch.cat([ang_thw[i, ..., bounds[i]:bounds[i + 1]]
                     for i in range(3)], dim=-1)              # (B,1,S,rd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    xr, xp = x[..., :rd], x[..., rd:]
    xr = _rotate(xr.to(torch.float32), sin, cos).to(x.dtype)
    return torch.cat([xr, xp], dim=-1) if rd < d else xr
