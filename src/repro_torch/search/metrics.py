"""Pluggable error metrics for the precision search.

A metric is any ``metric(ref_out, cand_out) -> float`` where smaller is
better and the search threshold bounds it. ``ref_out``/``cand_out`` are the
full pytree outputs of the profiled function (full-precision vs candidate
policy). ``autosearch`` hands them over as **numpy pytrees on the host**
(the reference package's ``jax.device_get`` gives the same), so a metric
written for one package works unchanged in the other; tensors are accepted
too and are copied to the host leaf by leaf.

``autosearch`` (and the app oracle layer) resolve their ``metric`` argument
through :func:`resolve_metric`, so a metric may be supplied as

  * ``None``                  — the default (max elementwise relative error),
  * a registered name         — ``"max_rel"``, ``"mean_rel"``, ``"rel_l2"``,
                                ``"loss"``,
  * any callable              — e.g. a mini-app's solver-level
                                ``error_metric`` over observables, or
  * :func:`from_observables`  — lift an observable map over raw outputs.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

_EPS = 1e-12


def tree_leaves(tree) -> list:
    """Leaves of a pytree in the reference package's order: dict entries by
    sorted key, tuples and lists in order, ``None`` has no leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over every leaf, keeping the pytree's structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, x) for x in tree]
        if hasattr(tree, "_fields"):                  # namedtuple
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree)


def host_array(x) -> np.ndarray:
    """One leaf as a numpy array on the host (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _leaves(tree):
    return [host_array(x) for x in tree_leaves(tree)]


def rel_error(ref_out, cand_out) -> float:
    """Max relative deviation over all output leaves and elements.

    NaN/Inf appearing in the candidate where the reference is finite counts
    as infinite error — a policy that overflows must never be admissible."""
    worst = 0.0
    for r, c in zip(_leaves(ref_out), _leaves(cand_out)):
        r = r.astype(np.float64, copy=False)
        c = c.astype(np.float64, copy=False)
        ok = np.isfinite(r)
        if not np.all(np.isfinite(c[ok] if r.shape else c)):
            return float("inf")
        if r.size == 0:
            continue
        d = np.abs(c - r) / (np.abs(r) + _EPS)
        d = d[ok] if r.shape else d
        if d.size:
            worst = max(worst, float(np.max(d)))
    return worst


def loss_degradation(ref_out, cand_out) -> float:
    """|Δloss| / |loss| for scalar(-first) outputs — the metric of the
    paper's application studies ('accept if the figure of merit moves less
    than the budget')."""
    r = _leaves(ref_out)[0].astype(np.float64).ravel()
    c = _leaves(cand_out)[0].astype(np.float64).ravel()
    if not np.all(np.isfinite(c)):
        return float("inf")
    return float(np.abs(c[0] - r[0]) / max(np.abs(r[0]), _EPS))


def rel_l2_error(ref_out, cand_out) -> float:
    """Worst per-leaf relative L2 deviation ||c - r||_2 / ||r||_2 — the
    field-level metric of the PDE mini-apps (a solution profile is judged as
    a whole, not by its worst cell). Scalar leaves degrade to the plain
    relative error; a non-finite candidate where the reference is finite is
    infinitely wrong."""
    worst = 0.0
    for r, c in zip(_leaves(ref_out), _leaves(cand_out)):
        r = r.astype(np.float64, copy=False)
        c = c.astype(np.float64, copy=False)
        if r.size == 0:
            continue
        if np.all(np.isfinite(r)) and not np.all(np.isfinite(c)):
            return float("inf")
        num = float(np.linalg.norm((c - r).ravel()))
        den = float(np.linalg.norm(r.ravel()))
        worst = max(worst, num / (den + _EPS))
    return worst


def mean_rel_error(ref_out, cand_out) -> float:
    """Mean (not max) relative deviation — a softer target for noisy
    workloads where a handful of tiny denominators shouldn't veto."""
    num = 0.0
    den = 0
    for r, c in zip(_leaves(ref_out), _leaves(cand_out)):
        r = r.astype(np.float64, copy=False)
        c = c.astype(np.float64, copy=False)
        if not np.all(np.isfinite(c[np.isfinite(r)] if r.shape else c)):
            return float("inf")
        d = np.abs(c - r) / (np.abs(r) + _EPS)
        num += float(np.sum(d))
        den += d.size
    return num / max(den, 1)


default_metric = rel_error

# names accepted anywhere a metric argument is resolved (autosearch, the
# app oracle layer); "max_rel" documents what the default was before
# metrics became user-suppliable
NAMED_METRICS = {
    "max_rel": rel_error,
    "rel": rel_error,
    "mean_rel": mean_rel_error,
    "rel_l2": rel_l2_error,
    "loss": loss_degradation,
}

MetricSpec = Union[None, str, Callable]


def resolve_metric(metric: MetricSpec = None) -> Callable:
    """Resolve a user-supplied metric spec to a callable.

    ``None`` keeps the historical behavior (max elementwise relative error);
    a string looks up :data:`NAMED_METRICS`; a callable — e.g. a mini-app's
    ``error_metric`` over solver observables — passes through unchanged."""
    if metric is None:
        return default_metric
    if callable(metric):
        return metric
    if isinstance(metric, str):
        try:
            return NAMED_METRICS[metric]
        except KeyError:
            raise ValueError(
                f"unknown metric name {metric!r}; "
                f"known: {sorted(NAMED_METRICS)}") from None
    raise TypeError(
        f"metric must be None, a name, or a callable, got {type(metric)}")


def from_observables(observables_fn: Callable,
                     metric: MetricSpec = None) -> Callable:
    """Lift a ``state -> observables`` map into a search metric over raw
    profiled-function outputs: both outputs are mapped to their solver-level
    observables and compared there. This is how an app whose profiled
    function returns raw state (instead of observables) still searches
    against physically meaningful quantities."""
    inner = resolve_metric(metric)

    def obs_metric(ref_out, cand_out) -> float:
        return inner(observables_fn(ref_out), observables_fn(cand_out))

    obs_metric.__name__ = f"from_observables({getattr(observables_fn, '__name__', '?')})"
    return obs_metric
