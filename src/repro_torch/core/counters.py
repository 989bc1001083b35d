"""Operation and byte counters per scope, split truncated vs full precision.

RAPTOR's runtime counts executed FP ops and touched bytes in truncated and
non-truncated regions (the bars in Fig. 7, inputs to the §7.2 co-design
model). The reference package derives the counts statically from a jaxpr.
The port counts what runs: the program executes once, untruncated, under a
dispatch mode (``_CountMode``) that charges every aten call to the
reference primitive it stands for (``interpreter.ATEN_TO_PRIM``) with the
reference's per-primitive FLOP weights. It quantizes nothing.

Counting what runs differs from the reference's static count in three
places, none of them in a straight-line program or a ``scan``-style loop:
a Python ``while`` counts every trip it makes (the reference counts one
trip of a ``while``), a Python ``if`` counts the branch taken (the
reference counts the larger branch of a ``cond``), and an aten op that
stands for several primitives counts once (``addmm`` is ``dot_general`` +
``add`` there). Bytes differ where the reference materialises a broadcast
operand at full shape before an elementwise op and aten passes the small
operand: the port's byte count is the lower of the two.

A backward pass inside the counted function (``value_and_grad`` of a loss)
is counted as op-mode walks it: each backward op under its forward op's
scope, as the reference's transpose keeps the forward's name stack, and
named as the reference's transpose names its primitive (``add`` is
``add_any``). A count is a plain run, so the backward ops are autograd's
derivative formulas, not the reference's transposed JVP rules that a walk
which rounds follows (``interpreter._FORMULAS``). On h2o-danube's smoke
configuration the two differ by 0.15 % of a train step's FLOPs, in named
terms (``tests/test_torch_profile_grad.py``): ``logistic``'s derivative is
one fused op against three, the RMSNorm's and the loss's derivatives take
fewer ops, and ``reduce_max``'s derivative counts its location mask as an
integer sum where the reference converts it to a float first.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.interpreter import (_BACKWARD_PRIM, _DETACH,
                                          _WalkMode, _fresh_root, prim_name)
from repro_torch.core.policy import STRUCTURAL_PRIMS, TruncationPolicy

# primitives that perform `weight` FLOPs per output element
_ELEMENTWISE_WEIGHT = {
    "exp": 4.0, "log": 4.0, "sin": 4.0, "cos": 4.0, "tanh": 4.0,
    "logistic": 4.0, "erf": 4.0, "rsqrt": 2.0, "sqrt": 2.0, "div": 1.0,
    "pow": 4.0, "cbrt": 4.0, "exp2": 4.0, "log1p": 4.0, "expm1": 4.0,
    "atan2": 4.0, "erf_inv": 4.0,
}

_REDUCTIONS = ("reduce_sum", "reduce_prod", "cumsum", "cumprod",
               "cumlogsumexp")
_ONE_PER_OUTPUT = ("add", "sub", "mul", "max", "min", "integer_pow", "neg",
                   "select_n", "convert_element_type")

# aten contraction -> its contraction length K (the reference's
# dot_general: 2 * output elements * K)
_CONTRACTION_K = {
    "mm": lambda a: a[0].shape[-1],
    "bmm": lambda a: a[0].shape[-1],
    "addmm": lambda a: a[1].shape[-1],
    "baddbmm": lambda a: a[1].shape[-1],
    "addbmm": lambda a: a[1].shape[0] * a[1].shape[-1],
    "dot": lambda a: a[0].numel(),
    "mv": lambda a: a[0].shape[-1],
    "addmv": lambda a: a[1].shape[-1],
}

_MEMORY_HEAVY = frozenset({
    "dot_general", "conv_general_dilated", "gather", "scatter", "scatter-add",
    "reduce_sum", "reduce_max", "reduce_min", "dynamic_slice",
    "dynamic_update_slice", "concatenate", "sort",
})


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (e for e in x if isinstance(e, torch.Tensor))


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def op_flops(prim: str, func, args, outs) -> float:
    """FLOPs of one aten call standing for reference primitive ``prim``
    (``counters._eqn_flops`` of the reference, per call)."""
    if prim in STRUCTURAL_PRIMS:
        return 0.0
    out_size = sum(o.numel() for o in outs)
    if prim == "dot_general":
        name = func._schema.name.partition("::")[2].rstrip("_")
        return 2.0 * out_size * _CONTRACTION_K[name](args)
    if prim == "conv_general_dilated":
        return 2.0 * out_size * math.prod(args[1].shape[1:])
    if prim in _REDUCTIONS:
        return float(next(_tensors(args)).numel())
    if prim in _ONE_PER_OUTPUT:
        return float(out_size)
    # default: one flop per output element for any other math primitive
    return _ELEMENTWISE_WEIGHT.get(prim, 1.0) * out_size


@dataclasses.dataclass
class CountReport:
    """Per-format FLOP and byte totals + per-scope breakdown."""

    flops_by_fmt: Dict[str, float]
    bytes_by_fmt: Dict[str, float]
    by_scope: Dict[Tuple[str, str], float]  # (scope, fmt) -> flops

    @property
    def total_flops(self) -> float:
        return sum(self.flops_by_fmt.values())

    @property
    def truncated_fraction(self) -> float:
        t = self.total_flops
        full = self.flops_by_fmt.get("full", 0.0)
        return 0.0 if t == 0 else (t - full) / t

    @staticmethod
    def merge_all(reports) -> "CountReport":
        """Cross-shard/process reduction: FLOP and byte tallies are pure
        sums, so the census of a data-parallel run is the elementwise sum of
        per-shard reports."""
        reports = list(reports)
        if not reports:
            raise ValueError("merge_all needs at least one report")
        out = reports[0]
        for r in reports[1:]:
            out = out.merged(r)
        return out

    def merged(self, other: "CountReport") -> "CountReport":
        r = CountReport(dict(self.flops_by_fmt), dict(self.bytes_by_fmt),
                        dict(self.by_scope))
        for k, v in other.flops_by_fmt.items():
            r.flops_by_fmt[k] = r.flops_by_fmt.get(k, 0.0) + v
        for k, v in other.bytes_by_fmt.items():
            r.bytes_by_fmt[k] = r.bytes_by_fmt.get(k, 0.0) + v
        for k, v in other.by_scope.items():
            r.by_scope[k] = r.by_scope.get(k, 0.0) + v
        return r

    def summary(self) -> str:
        lines = [f"  {'format':>10} {'GFLOPs':>14} {'GBytes':>14}"]
        for fmt in sorted(self.flops_by_fmt):
            lines.append(
                f"  {fmt:>10} {self.flops_by_fmt[fmt] / 1e9:>14.4f} "
                f"{self.bytes_by_fmt.get(fmt, 0.0) / 1e9:>14.4f}")
        lines.append(f"  truncated fraction of FLOPs: "
                     f"{self.truncated_fraction * 100:.2f}%")
        return "\n".join(lines)


class _CountMode(_WalkMode):
    """Runs each aten call unchanged and charges its FLOPs and bytes to the
    format the policy would give its first output (``"full"`` when none)
    and to the top segment of its scope. A backward op is charged as
    op-mode places it (``interpreter._Grads``): under its forward op's
    scope, named as the reference's transpose names it (``add`` is
    ``add_any``). A count is a plain run, so the backward ops are
    autograd's own formulas (module docstring)."""

    formulas = False

    def __init__(self, policy: Optional[TruncationPolicy], fused: bool):
        super().__init__()
        self.policy, self.fused = policy, fused
        self.flops = collections.defaultdict(float)
        self.nbytes = collections.defaultdict(float)
        self.by_scope = collections.defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        frame, _, backward = self.grads.site(func is not _DETACH)
        out = func(*args, **kwargs)
        prim, _ = prim_name(func, args)
        if backward:
            prim = _BACKWARD_PRIM.get(prim, prim)
        outs = list(_tensors(out if isinstance(out, (tuple, list))
                             else (out,)))
        f = op_flops(prim, func, args, outs)
        if f == 0.0:
            return out
        # fused: elementwise chains are producer-consumer fused (outputs
        # counted once, operands free); matmuls, gathers and reductions pay
        # for operands and results
        b = _nbytes(outs)
        if not self.fused or prim in _MEMORY_HEAVY:
            b += _nbytes(_tensors(list(args) + list(kwargs.values())))
        stack = frame.stack
        dtype = outs[0].dtype if outs else torch.float32
        rule = (self.policy.rule_for(stack, prim, dtype)
                if self.policy is not None else None)
        key = rule.fmt.key if rule is not None else "full"
        self.flops[key] += f
        self.nbytes[key] += b
        self.by_scope[(stack.split("/")[0] if stack else "<root>", key)] += f
        return out

    def report(self) -> CountReport:
        return CountReport(dict(self.flops), dict(self.nbytes),
                           dict(self.by_scope))


def count_ops(fn, args, kwargs, policy: Optional[TruncationPolicy],
              fused: bool = False) -> CountReport:
    """Run ``fn(*args, **kwargs)`` once, untruncated, and count its FLOPs and
    bytes per format and per (top scope, format) — the counterpart of the
    reference's ``count_jaxpr``. ``fused=True`` models post-fusion memory
    traffic (elementwise operands free); ``fused=False`` is the raw per-op
    operand + result census."""
    mode = _CountMode(policy, fused)
    with _fresh_root(), mode:
        fn(*args, **kwargs)
    return mode.report()
