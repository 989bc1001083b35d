"""Train-step factory: microbatch gradient accumulation, an optional RAPTOR
truncation policy, gradient compression, AdamW (``repro.train.trainer``).

``make_train_step`` returns a function

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

The RAPTOR integration point is the *differentiated* loss: with
``TrainConfig.policy`` set, the function that computes the loss and its
gradients (``value_and_grad``, ``torch.autograd.grad`` inside) is wrapped
by ``truncate``, so the forward and the backward pass are rounded op by op,
every backward op under the scope of the forward op it differentiates --
the reference's ``truncate(jax.value_and_grad(loss))``. Layers and
attention chunks are recomputed in the backward pass as the reference's
``jax.checkpoint`` bodies are (``core.interpreter.remat``).

``make_hotswap_train_step`` makes the policy a runtime argument: one
``truncate_sweep`` enumeration of the differentiated loss, and each step
takes a ``(num_sites, 4)`` int32 format table. Deploying another policy is
a new table value: no new enumeration (``train_step.sweep.n_traces`` stays
1).

Nothing in a step reads a value back to the host: the step counter, the
learning rate, the clip scale and the metrics stay on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.api import truncate, truncate_sweep
from repro_torch.distributed import sharding as _shd
from repro_torch.core.policy import TruncationPolicy
from repro_torch.models.common import resolve_device
from repro_torch.optim import adamw, compression
from repro_torch.optim import tree as T
from repro_torch.optim.adamw import AdamWConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_accum: int = 1
    policy: Optional[TruncationPolicy] = None       # RAPTOR truncation
    policy_impl: str = "auto"
    grad_compression: Optional[str] = None          # None | "bf16" | "int8"
    lr_schedule: Optional[Callable] = None          # step -> lr


def _split_micro_fn(accum: int):
    def split_micro(batch, i):
        def slice_one(x):
            if x.ndim == 0:
                return x
            # leading batch dim except (3,B,S) mrope positions
            if x.ndim >= 2 and x.shape[0] == 3 and x.shape[1] % accum == 0:
                b = x.shape[1] // accum
                return x[:, i * b:(i + 1) * b]
            b = x.shape[0] // accum
            return x[i * b:(i + 1) * b]
        return {k: slice_one(v) for k, v in batch.items()}
    return split_micro


def value_and_grad(loss_fn):
    """``(params, batch) -> (loss, grads)``, the gradients a tree like
    ``params`` (zeros for a parameter the loss does not use, as JAX
    gives). The tape is recorded and replayed inside the call, so a
    ``truncate`` or ``truncate_sweep`` of the result sees both passes.
    On DTensor parameters the loss is the global program's (its partial
    sums over the ranks reduced before the backward pass starts) and each
    gradient comes back laid out as its parameter."""
    def grad_fn(params, batch):
        leaves = T.leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss = _shd.settled(loss_fn(T.unflatten(params, live), batch))
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
        grads = [_shd.redistribute_as(g, p) if _shd._is_dtensor(p) else g
                 for g, p in zip(grads, leaves)]
        return _shd.gather(loss.detach()), T.unflatten(params, grads)
    return grad_fn


def _device_scalar(x, dtype, device) -> torch.Tensor:
    """``x`` as a 0-d tensor on ``device``; a Python number is filled in on
    the device (no copy from the host, so no host synchronisation)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _build_train_step(tc: TrainConfig, grad_fn, grad_shardings=None):
    """The shared step body: microbatch accumulation, gradient compression, the optimizer update. ``grad_fn(params,
    micro_batch, *extra) -> (loss, grads)``; ``*extra`` step arguments (the
    hot-swap format table) go to every microbatch call."""
    accum = max(tc.grad_accum, 1)
    split_micro = _split_micro_fn(accum)

    def constrain_grads(g):
        if grad_shardings is None:
            return g
        from repro_torch.distributed.sharding import place_tree
        return place_tree(g, grad_shardings)

    def train_step(params, opt_state, batch, step, *extra):
        device = T.leaves(params)[0].device
        if accum == 1:
            loss, grads = grad_fn(params, batch, *extra)
        else:
            acc = T.tree_map(lambda p: adamw._zeros_as(p, torch.float32),
                             params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum):
                loss_i, g_i = grad_fn(params, split_micro(batch, i), *extra)
                acc = T.tree_map(lambda a, g: a + g.to(torch.float32),
                                 acc, g_i)
                loss = loss + loss_i
            grads = T.tree_map(lambda g: g / accum, acc)
            loss = loss / accum
        grads = constrain_grads(grads)

        if tc.grad_compression == "bf16":
            grads, err = compression.compress_bf16(grads, opt_state["err"])
            opt_state = dict(opt_state, err=err)
        elif tc.grad_compression == "int8":
            q, err = compression.compress_int8(grads, opt_state["err"])
            grads = compression.decompress_int8(q)
            opt_state = dict(opt_state, err=err)

        step = _device_scalar(step, torch.int32, device)
        lr = (tc.lr_schedule(step) if tc.lr_schedule
              else _device_scalar(tc.optimizer.lr, torch.float32, device))
        inner = {k: opt_state[k] for k in ("step", "m", "v", "master")}
        params, inner, om = adamw.apply_updates(params, grads, inner,
                                                tc.optimizer, lr)
        new_state = dict(opt_state, **inner)
        # the health flag the guardrail monitor reads: the grad norm reduces
        # every gradient leaf, so loss and norm cover the backward pass
        healthy = torch.isfinite(loss) & torch.isfinite(om["grad_norm"])
        metrics = {"loss": loss, "lr": lr, "nonfinite": ~healthy, **om}
        return params, new_state, metrics

    return train_step


def make_train_step(model, tc: TrainConfig, grad_shardings=None):
    """The train step of ``model`` under ``tc``; with ``tc.policy`` the
    differentiated loss runs under ``truncate(..., impl=tc.policy_impl)``
    (``train_step.grad_fn`` is that wrapper, with its ``n_traces``).

    ``grad_shardings``: a tree of ``distributed.sharding.NamedSharding``
    (the parameters' structure or a prefix): each gradient is laid out as
    its parameter is -- a DTensor gradient is redistributed to the
    placements, a plain one (the global value every rank holds) keeps its
    layout, as a sharding constraint changes no value."""
    grad_fn = value_and_grad(model.loss)
    if tc.policy is not None:
        grad_fn = truncate(grad_fn, tc.policy, impl=tc.policy_impl)
    step = _build_train_step(tc, grad_fn, grad_shardings)
    step.grad_fn = grad_fn
    return step


def make_hotswap_train_step(model, tc: TrainConfig, site_policy,
                            example_params, example_batch,
                            grad_shardings=None):
    """A train step whose truncation policy is a runtime argument.

    Every ``site_policy``-matched site of the differentiated loss, forward
    and backward, is enumerated once, on ``example_params`` and
    ``example_batch`` (its first microbatch under grad accumulation), into
    the rows of a ``(num_sites, 4)`` int32 format table:

        step_fn, sites = make_hotswap_train_step(model, tc, site_policy,
                                                 params, batch)
        table = step_fn.device_table(sites.table_for(artifact.policy))
        params, opt, m = step_fn(params, opt, batch, step, table)
        table = step_fn.device_table(sites.table_for(other.policy))
        params, opt, m = step_fn(params, opt, batch, step, table)  # no
                                                    # new enumeration

    Returns ``(train_step, site_index)``: ``train_step(params, opt_state,
    batch, step, table)``, and the ``SiteIndex`` that lowers any policy
    whose matched set is a subset of ``site_policy``'s to its table. A
    table given as a numpy array is copied to the device at each call
    (a host synchronisation); ``train_step.device_table`` makes the device
    copy once. ``train_step.sweep`` is the ``truncate_sweep`` wrapper
    (``n_traces`` counts enumerations). ``grad_shardings`` as for
    :func:`make_train_step`."""
    accum = max(tc.grad_accum, 1)
    micro = (example_batch if accum == 1
             else _split_micro_fn(accum)(example_batch, 0))
    sweep = truncate_sweep(value_and_grad(model.loss), site_policy,
                           impl=tc.policy_impl)
    handle = sweep(example_params, micro)
    index, device = handle.index, handle.device
    del handle                      # it holds the example's tensors

    def grad_fn(params, micro_batch, table):
        return sweep(params, micro_batch)(table)

    step = _build_train_step(tc, grad_fn, grad_shardings)
    step.sweep = sweep
    step.device_table = lambda table: torch.as_tensor(
        table, device=device).to(torch.int32)
    return step, index


def init_opt_state(model, params, tc: TrainConfig, *, device=None):
    """AdamW state for ``params`` (plus the error-feedback buffer under
    gradient compression) on ``device``: ``None`` is the card, and raises
    without one; the parameters must already be there."""
    device = resolve_device(device)
    leaf = T.leaves(params)[0]
    if leaf.device.type != device.type:
        raise ValueError(f"params are on {leaf.device}, the state would be "
                         f"on {device}; move them first")
    state = adamw.init_state(params, tc.optimizer)
    if tc.grad_compression:
        state["err"] = compression.init_error_buffer(params)
    return state
