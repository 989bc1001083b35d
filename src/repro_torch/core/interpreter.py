"""Op-mode interpreter — the PyTorch analogue of RAPTOR's LLVM pass.

The reference package walks a traced program (a jaxpr) and re-binds every
equation, rounding the result of each matched floating-point primitive onto
the policy's (e,m) grid (compute-in-carrier + correctly-round-result = MPFR
op-mode semantics). PyTorch runs eagerly, so the port needs its own
mechanism. Two were plausible:

  * a ``make_fx`` graph walked node by node, or
  * a ``TorchDispatchMode`` that intercepts every aten call as it happens.

The port takes the **dispatch mode**. Both see the same vocabulary (aten
overloads below autograd, composite ops already decomposed), but the mode
needs no graph: a Python loop over 24 layers stays a loop instead of a
40,000-node unrolled graph to trace, hold and re-interpret; intermediates
are freed by reference counting as in any eager run, so profiling a
full-width model costs the memory of the plain forward plus one tensor per
site; scope names are read off a thread-local stack at the moment an op
runs instead of being stamped into node metadata by a tracer hook; and any
Python the user wrote (data-independent control flow, closures, dicts of
parameters) works unchanged. What a graph would add — a static object to
count and analyse — is not needed by the op-mode path and can be built later
from the same dispatch stream.

Two transforms share the mode machinery, as in the reference:

  * **policy-driven** (``run_quantized`` / ``_PolicyMode``): formats come
    from the policy's rules. Keeps the static fast paths and the full rule
    feature set (masks, dot-input quantization).
  * **table-driven** (``run_sites`` / ``_TableMode``): one enumeration run
    fixes *where* to quantize (the sites matched by a site policy); *what*
    format each site gets is a row of a runtime ``(num_sites, 4)`` int32
    table that lives on the device. A new candidate policy is a new table
    value: no new enumeration, no kernel build, and no host
    synchronisation per site (the kernel reads its row itself).

**Sites.** An op is identified by where it runs, not by a running counter:
its key is ``(scope path, position within that scope entry, output index)``.
Every entry into ``scope(name)`` starts a fresh position count, so a body
that runs N times under one scope (the layer loop of a model, under the
scope ``layer``) yields ONE set of sites shared by all N iterations — what
the reference gets from scanning the layer stack. ``loop_body(tag)`` does the
same for an anonymous loop body (the chunk loops of blockwise attention)
without adding a segment to the policy-visible name stack, which is what the
reference's ``lax.scan`` bodies look like to a policy.

**Vocabulary.** Policies name reference *primitives* (``dot_general``,
``add``, ``exp``; ``ops=`` / ``exclude_ops=`` / ``STRUCTURAL_PRIMS``).
``ATEN_TO_PRIM`` maps every aten op the port's programs meet to the
primitive a policy sees. An aten op with no entry raises with its name:
there is no silent default. A fused aten op that stands for several
primitives is named after the primitive that produces its final value
(``addmm`` -> ``dot_general``, ``mean`` -> ``reduce_sum``,
``_softmax`` -> ``div``); the port's own models are written from elementary
ops so that their sites fall where the reference's do.

**Where site counts differ from the reference on the same model** (measured
by ``tests/test_torch_model.py``, which prints both per scope). The sets of
scopes that hold sites are equal, and on the f32 dense decoder every scope
has the same sites in the same order with ONE exception: under
``layer/attn/mix`` the reference has one more. Its ``jnp.where(mask, s,
NEG_INF)`` materialises the Python constant as a traced, float-valued
``convert_element_type`` equation, which an everywhere-policy matches; torch
passes the scalar straight into ``aten.where`` and no float tensor is born.
Rounding a constant that is already representable changes nothing, so the
extra site moves no value. Differences that other programs can show:

  * a fused aten op stands for several reference primitives (``mean`` is
    ``reduce_sum`` + ``div`` there; the port's own models write it out);
  * constants the reference builds as traced arrays (``iota`` +
    ``convert_element_type``) may be built by a different sequence of aten
    ops, all of them still under the same scope;
  * the reference names the contraction inside ``jnp.einsum`` after its
    subscripts (``.../bhgqd,bhkd->bhgqk``); the port's models do the same
    through ``models.common.einsum``, plain ``torch.einsum`` does not.

None of these moves a site across a scope boundary, so a policy that is
written per scope selects the same arithmetic in both packages.

**Fused kernels.** The port's flash-attention and WKV6 kernels are
``torch.library`` custom ops that a policy sees as the reference's
``pallas_call`` (``kernels/fused.py``). When such an op is called with a
format row wired in and its covered output is a site (``truncate``: a rule
with no mask and no dot-input quantization matches it; ``truncate_sweep``:
the output was enumerated), the walk replaces the row argument with the
site's row -- the rule's format row, made once per plan and device, or
``table[site]``, a view of the device table -- and skips the separate
quantize pass for that output: the kernel's epilogue does it, bit for bit.
Every other output (WKV6's recurrence state) keeps its separate pass, and a
masked rule is never routed, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.policy import (
    TruncationPolicy, TruncationRule, join_stack, normalize_stack,
)
# the module, not its names: the quantizer imports core.formats, so either
# package may be the first one imported
from repro_torch.kernels import fused as _fused
from repro_torch.kernels.quantize_em import ops as _q

# primitives whose *inputs* we optionally quantize to emulate a low-precision
# matrix unit with full-precision accumulation
_DOT_PRIMS = frozenset({"dot_general", "conv_general_dilated", "ragged_dot"})


# --------------------------------------------------------------------------
# aten op -> reference primitive name
# --------------------------------------------------------------------------

def _table(prim_to_aten: Dict[str, str]) -> Dict[str, str]:
    out = {}
    for prim, names in prim_to_aten.items():
        for n in names.split():
            assert n not in out, n
            out[n] = prim
    return out


ATEN_TO_PRIM: Dict[str, str] = _table({
    # ---- arithmetic: results are new floating-point values ----------------
    "dot_general": "mm bmm addmm baddbmm addbmm dot mv addmv",
    "conv_general_dilated": "convolution",
    "add": "add logsumexp",
    "sub": "sub rsub _log_softmax",
    "mul": "mul silu gelu native_dropout",
    "div": "div true_divide reciprocal _softmax",
    "rem": "remainder fmod",
    "pow": "pow",
    "square": "square",
    "sqrt": "sqrt",
    "rsqrt": "rsqrt",
    "exp": "exp",
    "exp2": "exp2",
    "expm1": "expm1",
    "log": "log log2 log10",
    "log1p": "log1p",
    "sin": "sin",
    "cos": "cos",
    "tan": "tan",
    "tanh": "tanh",
    "logistic": "sigmoid",
    "erf": "erf",
    "erf_inv": "erfinv",
    "atan2": "atan2",
    "reduce_sum": "sum mean",
    "reduce_prod": "prod",
    "cumsum": "cumsum",
    "scatter": "scatter scatter_add index_put index_add",
    "convert_element_type": "_to_copy",
    # random draws (the reference's are ``random_bits`` and bit arithmetic)
    "random_bits": ("rand rand_like randn randn_like randint randint_like "
                    "normal uniform bernoulli multinomial randperm"),
    # ---- structural: never produce a new floating-point value -------------
    "reshape": "view _unsafe_view reshape _reshape_alias flatten unflatten",
    "transpose": "permute transpose t",
    "expand_dims": "unsqueeze",
    "squeeze": "squeeze",
    "broadcast_in_dim": ("expand full zeros ones empty full_like zeros_like "
                         "ones_like empty_like scalar_tensor new_full "
                         "new_zeros new_ones new_empty empty_strided "
                         "new_empty_strided"),
    "slice": "slice select narrow unbind diagonal",
    "split": "split split_with_sizes chunk",
    "concatenate": "cat stack repeat roll",
    "gather": "index index_select gather embedding",
    "pad": "constant_pad_nd",
    "rev": "flip",
    "select_n": "where masked_fill tril triu",
    "copy": "clone contiguous copy lift_fresh _local_scalar_dense",
    "stop_gradient": "detach alias",
    "iota": "arange",
    "reduce_max": "amax",
    "reduce_min": "amin",
    "max": "maximum max relu",
    "min": "minimum min",
    "abs": "abs",
    "neg": "neg",
    "sign": "sign sgn",
    "clamp": "clamp clamp_min clamp_max",
    "sort": "sort topk",
    "argmax": "argmax",
    "argmin": "argmin",
    "reduce_and": "all",
    "reduce_or": "any",
    "eq": "eq",
    "ne": "ne",
    "lt": "lt",
    "le": "le",
    "gt": "gt",
    "ge": "ge",
    "and": "logical_and bitwise_and __and__",
    "or": "logical_or bitwise_or __or__",
    "not": "logical_not bitwise_not",
    "xor": "logical_xor bitwise_xor __xor__",
    "is_finite": "isnan isinf isfinite",
    "floor": "floor floor_divide",
    "ceil": "ceil",
    "round": "round trunc",
})

_PRIM_CACHE: Dict[Any, Tuple[str, bool]] = {}


def prim_name(func) -> Tuple[str, bool]:
    """(primitive name a policy sees, whether the op writes in place) for
    one aten overload or one of the port's fused kernels (``pallas_call``,
    as in the reference). Raises ``NotImplementedError`` naming the op when
    it is neither in ``ATEN_TO_PRIM`` nor a fused kernel."""
    hit = _PRIM_CACHE.get(func)
    if hit is not None:
        return hit
    schema = func._schema
    if _fused.fused_outputs(func) is not None:
        hit = (_fused.PRIM, bool(schema.is_mutable))
        _PRIM_CACHE[func] = hit
        return hit
    ns, _, name = schema.name.partition("::")
    base = name
    if base not in ATEN_TO_PRIM and base.endswith("_"):
        base = base[:-1]                       # in-place twin: add_ -> add
    if ns != "aten" or base not in ATEN_TO_PRIM:
        raise NotImplementedError(
            f"op {schema.name} ({func}) has no entry in "
            "repro_torch.core.interpreter.ATEN_TO_PRIM: the interpreter does "
            "not know which primitive name a policy should see for it")
    hit = (ATEN_TO_PRIM[base], bool(schema.is_mutable))
    _PRIM_CACHE[func] = hit
    return hit


# --------------------------------------------------------------------------
# scope stack: where an op runs
# --------------------------------------------------------------------------

class _Frame:
    """One entry into a scope: ``path`` identifies it (hidden loop-body tags
    included), ``stack`` is the policy-visible name stack, ``pos`` counts
    the aten calls made directly inside this entry, ``loop`` says whether
    the entry is one trip of a loop and ``depth`` counts the loop trips it
    lies in, its own included."""

    __slots__ = ("path", "stack", "pos", "loop", "depth")

    def __init__(self, path: str, stack: str, loop: bool = False,
                 depth: int = 0):
        self.path, self.stack, self.pos = path, stack, 0
        self.loop, self.depth = loop, depth


_tls = threading.local()


def _frames() -> List[_Frame]:
    fr = getattr(_tls, "frames", None)
    if fr is None:
        fr = _tls.frames = [_Frame("", "")]
    return fr


@contextlib.contextmanager
def _push(tag: str, visible: bool, loop: bool):
    frames = _frames()
    top = frames[-1]
    frame = _Frame(join_stack(top.path, tag),
                   join_stack(top.stack, tag) if visible else top.stack,
                   loop, top.depth + loop)
    frames.append(frame)
    try:
        yield
    finally:
        frames.pop()
    if loop and frame.depth == 1:
        # one trip of an outermost loop ended: a trajectory step
        hook = getattr(_tls, "on_step", None)
        if hook is not None:
            hook()


@contextlib.contextmanager
def on_step(hook):
    """Call ``hook()`` at the end of every trip of an outermost loop run
    inside (a ``loop_body`` or a ``scope(..., loop=True)`` entry that lies in
    no other loop trip): the trajectory step of mem-mode, what one trip of a
    depth-0 ``scan`` or ``while`` is to the reference."""
    prev = getattr(_tls, "on_step", None)
    _tls.on_step = hook
    try:
        yield
    finally:
        _tls.on_step = prev


def scope(name: str, *, loop: bool = False):
    """Region marker (the ``_raptor_trunc_func_*`` analogue): ops run inside
    carry ``name`` on their scope stack, which policies match by glob. Each
    entry starts a fresh site count, so re-entering the same scope re-uses
    its sites. ``loop=True`` marks each entry as one trip of a loop (a
    Python loop over a stack the reference scans, like a model's layers):
    it changes no site, only where trajectory steps fall (``on_step``)."""
    if not name or "/" in name or name.startswith("#"):
        raise ValueError(f"scope name must be one plain segment, got {name!r}")
    return _push(name, True, loop)


def loop_body(tag: str, *, once: bool = False):
    """Mark the body of a Python loop: every iteration entered through this
    context shares one set of sites, and the policy-visible name stack does
    not change (what a scanned body is to the reference). ``once=True``
    marks a hidden frame of one trip instead: straight-line code that needs
    sites of its own (a scope entered a second time), which is no loop and
    never a trajectory step."""
    return _push("#" + tag, False, not once)


def current_stack() -> str:
    return _frames()[-1].stack


@contextlib.contextmanager
def _fresh_root():
    """A transformed call counts positions from zero, whatever ran before
    it, while keeping the scope it was called under."""
    frames = _frames()
    saved = frames[:]
    top = frames[-1]
    frames[:] = [_Frame(top.path, top.stack)]
    try:
        yield
    finally:
        frames[:] = saved


# --------------------------------------------------------------------------
# the modes
# --------------------------------------------------------------------------

def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dtype.is_floating_point


def _maybe_quantize(val, rule: TruncationRule, impl: str):
    if not _is_float(val):
        return val
    q = _q.quantize(val, rule.fmt, impl=impl)
    if rule.mask is not None:
        q = torch.where(rule.mask(val), q, val)
    return q


def _wired_row(func, prim: str, args) -> Optional[Tuple[int, int]]:
    """(row argument index, covered output index) of a fused op called with
    a format row wired in, else ``None`` (every aten op, and a fused op
    called without a row: it has no epilogue to route into)."""
    if prim != _fused.PRIM:          # one string compare for every aten op
        return None
    ri = _fused.row_argument(func)
    if len(args) <= ri or args[ri] is None:
        return None
    (fi,) = _fused.fused_outputs(func)   # each fused op covers one output
    return ri, fi


def _with_row(args, ri: int, row):
    return args[:ri] + (row,) + args[ri + 1:]


class _WalkMode(TorchDispatchMode):
    """Shared walk: name the op, run it, hand each output to ``on_output``.
    Inside ``__torch_dispatch__`` the mode is off, so the quantizer's own
    tensor ops (and a fused kernel's plain version) are not intercepted
    again. ``on_inputs`` may route a site's row into a fused op; the outputs
    it names as routed skip ``on_output``. ``run`` runs the op (mem-mode
    runs it on a second lane too)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        frame = _frames()[-1]
        pos = frame.pos
        frame.pos = pos + 1
        prim, mutates = prim_name(func)
        kwargs = kwargs or {}
        args, kwargs, routed = self.on_inputs(frame, pos, prim, func, args,
                                              kwargs)
        out = self.run(func, args, kwargs, mutates)
        if isinstance(out, torch.Tensor):
            if 0 in routed:
                return out
            new = self.on_output(frame, pos, 0, prim, out)
            if new is not out:
                if mutates:          # keep the aliasing the caller expects
                    out.copy_(new)
                else:
                    out = new
            return out
        if isinstance(out, (tuple, list)):
            res = []
            for i, o in enumerate(out):
                if isinstance(o, torch.Tensor) and i not in routed:
                    new = self.on_output(frame, pos, i, prim, o)
                    if new is not o and mutates:
                        o.copy_(new)
                        new = o
                    o = new
                res.append(o)
            return type(out)(res) if isinstance(out, tuple) else res
        return out

    def on_inputs(self, frame, pos, prim, func, args, kwargs):
        """Returns ``(args, kwargs, routed output indices)``."""
        return args, kwargs, ()

    def run(self, func, args, kwargs, mutates):
        return func(*args, **kwargs)

    def on_output(self, frame, pos, out_idx, prim, val):
        return val


_MISS = object()


class _PolicyMode(_WalkMode):
    """Formats fixed by the policy: the original op-mode transform. ``plan``
    memoises the rule decided for every (site key) of one input signature,
    so matching runs once per signature."""

    def __init__(self, policy: TruncationPolicy, impl: str, plan: Dict):
        super().__init__()
        self.policy, self.impl, self.plan = policy, impl, plan
        # fast path: a policy with no rules can never match
        self.live = bool(policy.rules)

    def _rule(self, frame, pos, out_idx, prim, dtype):
        key = (frame.path, pos, out_idx)
        rule = self.plan.get(key, _MISS)
        if rule is _MISS:
            rule = self.policy.rule_for(frame.stack, prim, dtype)
            self.plan[key] = rule
        return rule

    def on_inputs(self, frame, pos, prim, func, args, kwargs):
        if not self.live:
            return args, kwargs, ()
        if prim in _DOT_PRIMS:
            dt = next((a.dtype for a in args if _is_float(a)), None)
            if dt is not None:
                rule0 = self._rule(frame, pos, -1, prim, dt)
                if rule0 is not None and rule0.quantize_dot_inputs:
                    args = tuple(_maybe_quantize(a, rule0, self.impl)
                                 for a in args)
            return args, kwargs, ()
        wired = _wired_row(func, prim, args)
        if wired is None:
            return args, kwargs, ()
        ri, fi = wired
        rule = self._rule(frame, pos, fi, prim,
                          _fused.covered_dtype(func, args))
        if rule is None or rule.mask is not None or rule.quantize_dot_inputs:
            return args, kwargs, ()
        # the rule's format row replaces the wired one; made once per plan
        # and device, so a call makes no host-to-device copy after the first
        device = args[ri].device
        key = ("fused_row", tuple(_q.format_row(rule.fmt)), device)
        row = self.plan.get(key)
        if row is None:
            row = self.plan[key] = torch.tensor(
                key[1], dtype=torch.int32, device=device)
        return _with_row(args, ri, row), kwargs, (fi,)

    def on_output(self, frame, pos, out_idx, prim, val):
        if not self.live or not val.dtype.is_floating_point:
            return val
        rule = self._rule(frame, pos, out_idx, prim, val.dtype)
        if rule is None or (rule.quantize_dot_inputs and prim in _DOT_PRIMS):
            return val
        return _maybe_quantize(val, rule, self.impl)


class _TableMode(_WalkMode):
    """Runtime-table formats: matching was pre-resolved into a SiteIndex, so
    a run only carries static row indices into ``table``.

    For a tensor on the card the site's row is read by the dynamic kernel
    from the table in device memory. For a tensor on the CPU the site goes
    through the prepared-table path: the format-field derivation runs once
    for the whole table and each site slices its row."""

    def __init__(self, table: torch.Tensor, index: "SiteIndex", impl: str):
        super().__init__()
        self.index, self.impl = index, impl
        self._tables = {table.device: table}
        self._prep32: Dict[torch.device, dict] = {}

    def _table_on(self, device):
        t = self._tables.get(device)
        if t is None:
            # a value on another device than the table (rare: a CPU scalar
            # in a CUDA program); one copy per run and device
            src = next(iter(self._tables.values()))
            t = self._tables[device] = src.to(device)
        return t

    def on_inputs(self, frame, pos, prim, func, args, kwargs):
        wired = _wired_row(func, prim, args)
        if wired is None:
            return args, kwargs, ()
        ri, fi = wired
        site = self.index.lookup(frame.path, pos, fi)
        if site is None:
            return args, kwargs, ()
        # the site's row of the device table goes into the kernel's epilogue
        row = self._table_on(args[ri].device)[site]
        return _with_row(args, ri, row), kwargs, (fi,)

    def on_output(self, frame, pos, out_idx, prim, val):
        site = self.index.lookup(frame.path, pos, out_idx)
        if site is None or not val.dtype.is_floating_point:
            return val
        table = self._table_on(val.device)
        on_card = val.is_cuda and self.impl != "ref"
        if on_card or val.dtype == torch.float64 or self.impl == "cuda":
            return _q.quantize_dynamic(val, (table, site), impl=self.impl)
        prep = self._prep32.get(val.device)
        if prep is None:
            prep = self._prep32[val.device] = _q.prepare_dynamic(table)
        return _q.quantize_prepared(val, prep, site)


# --------------------------------------------------------------------------
# quantize-site enumeration (runtime-parameterized formats)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizeSite:
    """One policy-matched (op, output) position in the program.

    ``stack`` is the policy-visible name stack exactly as the walk sees it,
    so re-matching a candidate policy against the site reproduces the
    policy-driven transform's decision bit for bit."""

    index: int
    stack: str
    prim: str
    dtype: Any

    @property
    def scope(self) -> str:
        return normalize_stack(self.stack)


class SiteIndex:
    """Order-stable site enumeration for one program and input signature.

    Maps (scope path, position within the scope entry, output index) -> row
    of the runtime format table. The path includes hidden loop-body tags, so
    two loops under one scope keep separate sites while the iterations of
    each loop share theirs."""

    def __init__(self, sites: List[QuantizeSite], by_key: Dict):
        self.sites = sites
        self._by_key = by_key

    def __len__(self) -> int:
        return len(self.sites)

    def lookup(self, path: str, pos: int, out_idx: int) -> Optional[int]:
        return self._by_key.get((path, pos, out_idx))

    def identity_table(self) -> np.ndarray:
        """The (num_sites, 4) table that quantizes nothing."""
        return np.tile(_q.IDENTITY_ROW, (len(self.sites), 1))

    def site_keys(self) -> List[Tuple]:
        """Per-site lookup keys, in site order."""
        keys: List = [None] * len(self.sites)
        for k, i in self._by_key.items():
            keys[i] = k
        return keys

    def table_for(self, policy: TruncationPolicy) -> np.ndarray:
        """Lower a candidate policy to its (num_sites, 4) int32 format table.

        Sites the policy does not match get the identity row; matched sites
        get the matching rule's format. Raises for rules the runtime path
        cannot represent (masks, dot-input quantization)."""
        rows = np.tile(_q.IDENTITY_ROW, (len(self.sites), 1))
        for s in self.sites:
            rule = policy.rule_for(s.stack, s.prim, s.dtype)
            if rule is None:
                continue
            if rule.mask is not None or rule.quantize_dot_inputs:
                raise ValueError(
                    "runtime format tables support plain output-quantize "
                    f"rules only (offending rule scope={rule.scope!r})")
            rows[s.index] = _q.format_row(rule.fmt)
        return rows


class _EnumMode(_WalkMode):
    """Runs the program unchanged and records every output the site policy
    matches, in execution order."""

    def __init__(self, site_policy: TruncationPolicy):
        super().__init__()
        self.site_policy = site_policy
        self.sites: List[QuantizeSite] = []
        self.by_key: Dict = {}
        self.executions = 0          # matched outputs met, repeats included

    def on_output(self, frame, pos, out_idx, prim, val):
        if not val.dtype.is_floating_point:
            return val
        key = (frame.path, pos, out_idx)
        if key in self.by_key:
            self.executions += 1
            return val
        if self.site_policy.rule_for(frame.stack, prim, val.dtype) is None:
            return val
        self.executions += 1
        self.by_key[key] = len(self.sites)
        self.sites.append(
            QuantizeSite(len(self.sites), frame.stack, prim, val.dtype))
        return val


def _check_plain_rules(policy: TruncationPolicy, what: str):
    for r in policy.rules:
        if r.mask is not None or r.quantize_dot_inputs:
            raise ValueError(f"{what} support plain output-quantize "
                             "rules only")


def enumerate_sites(fn, args, kwargs,
                    site_policy: TruncationPolicy) -> SiteIndex:
    """One un-quantized run of ``fn(*args, **kwargs)`` enumerating every
    quantize site the ``site_policy`` matches, in the order the evaluator
    meets them.

    The site policy fixes *where* quantization may happen (its formats are
    irrelevant); any candidate policy whose matched set is a subset of the
    site policy's can then be lowered to a table via ``table_for``.
    ``index.executions`` is the number of site executions in one run (a
    site in a body that runs N times counts N)."""
    _check_plain_rules(site_policy, "site policies")
    mode = _EnumMode(site_policy)
    with _fresh_root(), mode:
        fn(*args, **kwargs)
    index = SiteIndex(mode.sites, mode.by_key)
    index.executions = mode.executions
    return index


def run_quantized(fn, args, kwargs, policy: TruncationPolicy,
                  impl: str = "auto", plan: Optional[Dict] = None, *,
                  native_fp8: bool = False):
    """Run ``fn(*args, **kwargs)`` with op-mode truncation under ``policy``.
    ``plan`` carries the per-site rule decisions between runs of one input
    signature."""
    if native_fp8:
        raise NotImplementedError(
            "native_fp8 needs the fp8 dot kernel, which is not ported yet")
    mode = _PolicyMode(policy, impl, {} if plan is None else plan)
    with _fresh_root(), mode:
        return fn(*args, **kwargs)


def run_sites(fn, args, kwargs, table: torch.Tensor, index: SiteIndex,
              impl: str = "auto"):
    """Run ``fn(*args, **kwargs)`` quantizing each enumerated site onto the
    format in its ``table`` row — the runtime-parameterized twin of
    ``run_quantized``. ``table`` is an int32 ``(num_sites, 4)`` tensor on
    the device the program runs on."""
    if table.dtype != torch.int32 or tuple(table.shape) != (len(index), 4):
        raise ValueError(f"table must be int32 of shape ({len(index)}, 4), "
                         f"got {table.dtype} {tuple(table.shape)}")
    with _fresh_root(), _TableMode(table.contiguous(), index, impl):
        return fn(*args, **kwargs)
