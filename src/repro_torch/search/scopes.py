"""Scope discovery: enumerate the ``scope`` subtrees a program runs.

The search driver needs a work-list of regions to try truncating. RAPTOR
gets its region list from the symbol table (every function is a scope); our
analogue is the ``scope`` name stack that models already use to label every
module ("layer/attn/qkv", ...). The reference package walks a jaxpr for
it. The port has no jaxpr: the program runs once, untruncated, under a
counting dispatch mode that charges each aten call's FLOPs (the counters'
``op_flops``, the reference's per-primitive weights) to every prefix of the
scope path it runs under. A Python loop is counted trip by trip, so a body
run N times carries N times its work, as a ``scan`` does there. The tree is
then cut into a *frontier*: the deepest scopes that each still carry a
meaningful fraction of the total work. Those frontier scopes are the search
variables.

Counting what runs differs from the reference's static walk where control
flow depends on values: a Python ``while`` counts every trip (the reference
one trip of a ``while``), a Python ``if`` the branch taken (the reference
the larger branch of a ``cond``). ``ScopeInfo.n_eqns`` counts aten calls as
they ran (a body run N times counts N times), where the reference counts the
equations of the traced program once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.counters import _tensors, op_flops
from repro_torch.core.interpreter import _frames, _fresh_root, prim_name
from repro_torch.core.policy import normalize_stack


@dataclasses.dataclass(frozen=True)
class ScopeInfo:
    """One named-scope subtree: its normalized path, the float FLOPs bound
    to it (including all children), and how many float-producing aten calls
    ran in it."""

    path: str
    flops: float
    n_eqns: int
    fraction: float  # of total float FLOPs in the program


class _ScopeMode(TorchDispatchMode):
    """Runs each aten call unchanged and credits the FLOPs of every
    float-producing one to each prefix of its scope path (and to ``""``,
    the program total)."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = {}
        self.eqns: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = list(_tensors(out if isinstance(out, (tuple, list))
                             else (out,)))
        # only float-producing ops are candidates for truncation; integer
        # work must not drag a scope into the search space
        if not any(o.dtype.is_floating_point for o in outs):
            return out
        prim, _ = prim_name(func, args)
        f = op_flops(prim, func, args, outs)
        if f <= 0.0:
            return out
        acc = ""
        for seg in normalize_stack(_frames()[-1].stack).split("/"):
            if seg:
                acc = f"{acc}/{seg}" if acc else seg
                self.flops[acc] = self.flops.get(acc, 0.0) + f
                self.eqns[acc] = self.eqns.get(acc, 0) + 1
        self.flops[""] = self.flops.get("", 0.0) + f
        self.eqns[""] = self.eqns.get("", 0) + 1
        return out


def _walk(fn, args, kwargs) -> Tuple[Dict[str, float], Dict[str, int]]:
    mode = _ScopeMode()
    with torch.no_grad(), _fresh_root(), mode:
        fn(*args, **(kwargs or {}))
    return mode.flops, mode.eqns


def scope_tree(fn, args=(), kwargs=None) -> Dict[str, float]:
    """All normalized scope paths of one untruncated run of
    ``fn(*args, **kwargs)`` with their float FLOPs. The empty path holds
    the program total."""
    return _walk(fn, args, kwargs)[0]


def discover_scopes(fn, args=(), kwargs=None, *,
                    min_fraction: float = 0.01,
                    max_scopes: Optional[int] = None) -> List[ScopeInfo]:
    """Cut the search frontier through the scope tree of one untruncated
    run of ``fn(*args, **kwargs)``.

    A scope is *refined* into its children when at least one child carries
    ``min_fraction`` of the total work; otherwise it is kept whole. The
    result is a list of disjoint scopes ordered by descending FLOPs (ties in
    the order the scopes first ran) — the per-scope variables the precision
    search will assign formats to.
    """
    flops, eqns = _walk(fn, args, kwargs)
    total = flops.get("", 0.0)
    if total <= 0.0:
        return []

    children: Dict[str, List[str]] = {}
    for path in flops:
        if not path:
            continue
        parent = path.rsplit("/", 1)[0] if "/" in path else ""
        children.setdefault(parent, []).append(path)

    frontier: List[str] = []

    def cut(path: str) -> None:
        kids = children.get(path, [])
        big = [k for k in kids if flops[k] / total >= min_fraction]
        if big:
            for k in big:
                cut(k)
            # siblings below the threshold stay unassigned (full precision)
            return
        if path:
            frontier.append(path)

    cut("")
    out = [ScopeInfo(p, flops[p], eqns[p], flops[p] / total)
           for p in frontier]
    out.sort(key=lambda s: -s.flops)
    if max_scopes is not None:
        out = out[:max_scopes]
    return out
