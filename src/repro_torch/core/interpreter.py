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
reference's ``lax.scan`` bodies look like to a policy. ``shared_body(name,
*inputs)`` marks a helper the reference wraps in ``jax.jit`` (``silu``,
``softplus``, ``jnp.var``): JAX traces it once per input signature and the
reference's walk visits that body once per visible scope stack, so its
calls with the same signature under the same visible scopes share sites.

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
by ``tests/test_torch_model.py``, which prints both per scope, and for every
family by ``tests/test_torch_families.py``). The sets of scopes that hold
sites are equal, and on every f32 smoke model every scope has the same
sites in the same order with ONE exception: under each scope that runs the
blockwise attention (``layer/attn/mix``, ``.../mla_mix``,
``dec_layer/cross_attn``) the reference has one more. Its ``jnp.where(mask, s,
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
import itertools
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.policy import (
    TruncationPolicy, TruncationRule, join_stack, normalize_stack,
)
# the module, not its names: the quantizer imports core.formats, so either
# package may be the first one imported
from repro_torch.core.formats import parse_format
from repro_torch.distributed import sharding as _shd
from repro_torch.kernels import fp8_dot as _fp8
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
    "mul": "mul silu gelu native_dropout tanh_backward sigmoid_backward",
    "div": "div true_divide reciprocal _softmax",
    "rem": "remainder fmod",
    "pow": "pow",
    "square": "square",
    # the reference's ``lax.top_k`` is arithmetic to a policy (its values
    # are a site), unlike ``sort``
    "top_k": "topk",
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
    "pad": "constant_pad_nd select_backward slice_backward",
    "rev": "flip",
    "select_n": "where masked_fill tril triu threshold_backward",
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
    "sort": "sort",
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
    # the gradient of an embedding lookup (backward formulas are named
    # after the reference VJP's equation that gives their value:
    # ``tanh_backward`` is a ``mul``, ``select_backward`` a ``pad``)
    "scatter-add": "embedding_dense_backward",
})

_PRIM_CACHE: Dict[Any, Tuple[str, bool]] = {}


def prim_name(func, args=()) -> Tuple[str, bool]:
    """(primitive name a policy sees, whether the op writes in place) for
    one aten overload or one of the port's fused kernels (``pallas_call``,
    as in the reference). Raises ``NotImplementedError`` naming the op when
    it is neither in ``ATEN_TO_PRIM`` nor a fused kernel. ``torch.square``
    and ``x ** n`` reach the dispatcher as ``pow(x, n)``: given the call's
    ``args``, an integer exponent is named as the reference names it,
    ``square`` for 2 (``jnp.square``) and ``integer_pow`` otherwise."""
    hit = _PRIM_CACHE.get(func)
    if hit is not None:
        if (func is _POW_SCALAR and len(args) > 1
                and isinstance(args[1], int)):
            # jnp.square and x ** n (lax.integer_pow)
            return ("square" if args[1] == 2 else "integer_pow"), hit[1]
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
    _PRIM_CACHE[func] = (ATEN_TO_PRIM[base], bool(schema.is_mutable))
    return prim_name(func, args)


_POW_SCALAR = torch.ops.aten.pow.Tensor_Scalar
_MASKED_FILL = torch.ops.aten.masked_fill_.Scalar
_DETACH = torch.ops.aten.detach.default
_MISS = object()


# --------------------------------------------------------------------------
# scope stack: where an op runs
# --------------------------------------------------------------------------

class _Frame:
    """One entry into a scope: ``path`` identifies it (hidden loop-body tags
    included), ``stack`` is the policy-visible name stack, ``pos`` counts
    the aten calls made directly inside this entry, ``loop`` says whether
    the entry is one trip of a loop and ``depth`` counts the loop trips it
    lies in, its own included. ``grad`` is the path under which the
    backward and recompute frames of this entry's ops are keyed: ``path``,
    but for the tags of ``loop_body(..., shared_grad=True)``. ``trip``
    numbers the outermost loop trip the entry lies in (``None`` outside
    one); a backward frame keeps its forward op's, and ``origin``, the
    forward op's site key ``(path, position)``."""

    __slots__ = ("path", "stack", "pos", "loop", "depth", "grad", "trip",
                 "origin")

    def __init__(self, path: str, stack: str, loop: bool = False,
                 depth: int = 0, grad: Optional[str] = None, trip=None):
        self.path, self.stack, self.pos = path, stack, 0
        self.loop, self.depth = loop, depth
        self.grad = path if grad is None else grad
        self.trip, self.origin = trip, None


class _Local(threading.local):
    frames: Optional[List[_Frame]] = None
    recompute = False          # inside a ``remat`` region's recompute
    on_step = None
    walks: Tuple = ()          # the ``_Grads`` of the walks entered here


def _absorb_collective():
    """The end of a ``sharding.collective()`` region: its autograd node is
    claimed by no op of the innermost walk on this thread."""
    if _tls.walks:
        _tls.walks[-1].absorb()


_tls = _Local()
_TRIPS = itertools.count()
_shd.after_collective.append(_absorb_collective)


def _frames() -> List[_Frame]:
    fr = _tls.frames
    if fr is None:
        fr = _tls.frames = [_Frame("", "")]
    return fr


def _push(tag: str, visible: bool, loop: bool, shared_grad: bool = False):
    top = _frames()[-1]
    # a hidden loop's body is one traced body to the reference, also inside
    # calls whose forward sites are their own (``shared_grad``)
    base = top.grad if loop and not visible else top.path
    return _enter(_Frame(join_stack(base, tag),
                         join_stack(top.stack, tag) if visible else top.stack,
                         loop, top.depth + loop,
                         top.grad if shared_grad else join_stack(top.grad,
                                                                 tag),
                         next(_TRIPS) if loop and not top.depth else top.trip))


@contextlib.contextmanager
def _enter(frame: _Frame):
    frames = _frames()
    frames.append(frame)
    try:
        yield
    finally:
        frames.pop()
    if frame.loop and frame.depth == 1:
        # one trip of an outermost loop ended: a trajectory step
        hook = _tls.on_step
        if hook is not None:
            hook()


@contextlib.contextmanager
def on_step(hook):
    """Call ``hook()`` at the end of every trip of an outermost loop run
    inside (a ``loop_body`` or a ``scope(..., loop=True)`` entry that lies in
    no other loop trip): the trajectory step of mem-mode, what one trip of a
    depth-0 ``scan`` or ``while`` is to the reference."""
    prev = _tls.on_step
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


def loop_body(tag: str, *, once: bool = False, shared_grad: bool = False):
    """Mark the body of a Python loop: every iteration entered through this
    context shares one set of sites, and the policy-visible name stack does
    not change (what a scanned body is to the reference). ``once=True``
    marks a hidden frame of one trip instead: straight-line code that needs
    sites of its own (a scope entered a second time), which is no loop and
    never a trajectory step. ``shared_grad=True`` keeps those forward sites
    its own but keys its backward and ``remat`` recompute frames as if the
    tag were absent, so every call's backward shares one set of sites (the
    calls of one ``jax.checkpoint``-ed function in the reference: each
    call's forward is its own, their transposed body one)."""
    return _push("#" + tag, False, not once, shared_grad)


@contextlib.contextmanager
def shared_body(name: str, *inputs: torch.Tensor):
    """Mark a call of a function the reference wraps in ``jax.jit``
    (``jax.nn.silu``, ``jax.nn.softplus``, ``jnp.var``'s ``_var``). JAX
    traces such a function once per input signature, and the reference's
    walk visits that one body once per policy-visible scope stack, so every
    call with ``inputs`` of the same shapes and dtypes under the same visible
    scopes shares one set of sites, whatever hidden frames lie between
    (``loop_body`` tags, one-trip frames). The visible stack does not change
    and the frame is never a loop trip.

    Yields ``inputs`` as the body must read them: the reference transposes
    a jitted body as a unit, so the cotangents of an input used more than
    once inside are summed there (``add_any`` sites of the body) and reach
    the caller as one term. Each input that autograd records enters through
    an identity node (``loop_const``'s), in whose input buffer those sums
    happen, each in the frame of the body's op that delivers its term; the
    node's own delivery is the caller's sum, under the body's scopes."""
    sig = ",".join(f"{tuple(t.shape)}{t.dtype}" for t in inputs)
    top = _frames()[-1]
    # a ``remat`` recompute traces the body again, as its JVP (residuals
    # and all): in the reference that is another jaxpr with sites of its own
    tag = ("#remat/" if _tls.recompute else "") + f"#{name}({sig})"
    # the inputs enter in a frame of the caller's, apart from its own
    # positions, so the body's sites do not depend on which inputs autograd
    # records, and each call's delivery is a site of its own
    with _enter(_Frame(join_stack(top.path, "#in" + tag), top.stack, False,
                       top.depth, trip=top.trip)):
        inputs = tuple(loop_const(t) for t in inputs)
    with _enter(_Frame(join_stack(top.stack, tag), top.stack, False,
                       top.depth, trip=top.trip)):
        yield inputs


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
# backward ops: the forward op's scope
# --------------------------------------------------------------------------

_current_node = torch._C._current_autograd_node
_sequence_nr = torch.autograd._get_sequence_nr

# what a primitive of a backward formula is to a policy: the reference's
# transpose accumulates cotangents with ``add_any``, never ``add``
_BACKWARD_PRIM = {"add": "add_any", "scatter": "scatter-add"}

# DTensor's own autograd nodes: data movement between layouts, whose
# backward ops are no op of the program's
_COLLECTIVE_NODES = frozenset({"RedistributeBackward",
                               "_FromTorchTensorBackward",
                               "_ToTorchTensorBackward"})


class _Grads:
    """Where each op of one transformed run lies, backward ops included.

    The reference differentiates a traced program, and every equation of
    its backward keeps the name stack of the forward equation it came from
    (``transpose(jvp(mlp))`` normalises to ``mlp``). PyTorch runs backward
    ops from autograd nodes, after every ``scope`` has exited and, on the
    card, on the autograd engine's own device thread, where this module's
    thread-local frames are not the caller's. So:

      * a forward op claims the autograd node made for it: autograd creates
        the node (and takes its sequence number, per thread) before it
        redispatches to this mode, so the first op that sees a new number
        is the node's op. Numbers from before the run are never claimed;
      * a backward op finds its node with ``torch._C._current_autograd_node``
        and runs in a frame keyed under the claiming op's site,
        ``<forward path>/#grad<forward position>``, with the forward
        stack. Its position counts the ops of that node's run, so it does
        not depend on which thread the engine uses, and the backward of a
        body that ran N times (the layers under ``layer``) shares one set of
        sites, as the forward does. A node some of whose inputs need no
        gradient runs other ops: its frame adds the mask
        (``#grad<position>:01``);
      * a backward op of a node no forward op of the run claimed (a leaf's
        gradient accumulator), and any op on another thread outside a
        node, runs in one ``#grad`` frame under the run's root, in engine
        order; the seed gradient (``ones_like`` in ``torch.autograd.grad``)
        runs on the caller's thread at the root, as the reference's does;
      * the recompute of a ``remat`` region is forward code: it re-enters
        the region's frames (``_recompute``) and claims nothing.
    """

    __slots__ = ("seq0", "last", "root", "fwd", "bwd", "orphan", "node",
                 "claimed", "saved", "pending", "sharded")

    def __init__(self, sharded: bool = True):
        # whether DTensors may reach the run: only then are DTensor's data
        # movement and autograd nodes looked for
        self.sharded = sharded
        self.seq0 = self.last = _sequence_nr()
        self.root = _frames()[0]
        self.fwd: Dict[int, Tuple[_Frame, int]] = {}
        self.bwd: Dict[int, _Frame] = {}
        self.orphan: Optional[_Frame] = None
        self.node = None        # the autograd node of the op being dispatched
        self.claimed = None     # the node number the op claimed, if any
        # forward inputs a derivative formula needs and autograd does not
        # save (``_FORMULAS``), by node number
        self.saved: Dict[int, torch.Tensor] = {}
        # what a formula keeps between the ops of one node's run, by node
        # number
        self.pending: Dict[int, dict] = {}

    def _orphan(self) -> _Frame:
        if self.orphan is None:
            self.orphan = _Frame(join_stack(self.root.path, "#grad"),
                                 self.root.stack)
        return self.orphan

    def site(self, counted: bool = True) -> Tuple[_Frame, int, bool]:
        """(frame, position, whether the op is a backward op) of the op
        being dispatched. An op that is not ``counted`` (``detach``, which
        autograd's saved-tensor hooks issue once per saved tensor: more
        where more inputs need gradients, so it would shift the positions
        of one loop trip against another) gets position -1: it never holds
        a site, and claims no node. An op of DTensor's data movement (in a
        ``sharding.collective()`` region, or in the backward of one of
        DTensor's own nodes) gets no frame: it is no op of the program, and
        a sharded run keeps the unsharded run's sites."""
        recompute = _tls.recompute
        node = self.node = None if recompute else _current_node()
        self.claimed = None
        if self.sharded:
            if _shd.in_collective():
                self.absorb()
                return None, -1, False
            if node is not None and node.name() in _COLLECTIVE_NODES:
                return None, -1, True
        if node is None:
            frames = _frames()
            if frames[0] is not self.root and not recompute:
                # another thread than the run's, outside any node
                return self._next(self._orphan(), counted) + (True,)
            frame = frames[-1]
            if not counted:
                return frame, -1, False
            pos = frame.pos
            frame.pos = pos + 1
            if not recompute:
                seq = _sequence_nr()
                if seq != self.last:        # autograd made a node for it
                    self.last = seq
                    if seq - 1 not in self.fwd:
                        self.fwd[seq - 1] = (frame, pos)
                        self.claimed = seq - 1
            return frame, pos, False
        seq = node._sequence_nr()
        frame = self.bwd.get(seq)
        if frame is None:
            hit = self.fwd.get(seq)
            if hit is None:
                frame = self._orphan()
            else:
                ff, fpos = hit
                # a node some of whose inputs need no gradient runs fewer
                # ops (the first trip of a loop whose carry starts as a
                # constant): it gets a frame of its own
                need = "".join("0" if f is None else "1"
                               for f, _ in node.next_functions)
                tag = f"#grad{fpos}" + (f":{need}" if "0" in need else "")
                frame = _Frame(join_stack(ff.grad, tag), ff.stack, False,
                               ff.depth, trip=ff.trip)
                frame.origin = (ff.path, fpos)
            self.bwd[seq] = frame
        return self._next(frame, counted) + (True,)

    def absorb(self):
        """Autograd nodes made so far on the run's thread are claimed by no
        op (a ``collective()`` region's ``Redistribute`` node, or one
        DTensor's dispatch makes below the walk)."""
        if _frames()[0] is self.root:
            self.last = _sequence_nr()

    @staticmethod
    def _next(frame: _Frame, counted: bool) -> Tuple[_Frame, int]:
        if not counted:
            return frame, -1
        pos = frame.pos
        frame.pos = pos + 1
        return frame, pos


@contextlib.contextmanager
def _recompute(snapshot):
    """The recompute of a ``remat`` region, on whatever thread the engine
    runs it: the region's frames as they stood at the call, a hidden
    one-trip ``#remat`` frame on top (the recomputed ops are sites of their
    own, as the reference's rematerialised equations are), positions from
    zero."""
    frames = [_Frame(*f) for f in snapshot]
    top = frames[-1]
    frames.append(_Frame(join_stack(top.grad, "#remat"), top.stack, False,
                         top.depth, trip=top.trip))
    saved = _tls.frames, _tls.recompute
    _tls.frames, _tls.recompute = frames, True
    try:
        yield
    finally:
        _tls.frames, _tls.recompute = saved


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``jax.checkpoint`` in the reference): ``torch.utils.checkpoint``,
    non-reentrant, when autograd records a tensor of ``args``; a plain call
    otherwise, so a forward without gradients is unchanged. The recompute
    runs under the scopes of the call with sites of its own."""
    if not torch.is_grad_enabled() or not any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in pytree.tree_leaves(args)):
        return fn(*args)
    snapshot = [(f.path, f.stack, f.loop, f.depth, f.grad, f.trip)
                for f in _frames()]

    def contexts():
        return contextlib.nullcontext(), _recompute(snapshot)

    from torch.utils.checkpoint import checkpoint
    # the port's models draw no random numbers, so no generator state is
    # saved and restored around the recompute
    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)


class _LoopConst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def loop_const(x):
    """``x`` as an input of a loop body that is the same on every trip (a
    const of the reference's ``lax.scan``): each trip's cotangent of it
    reaches ``x`` from a node of the body's frame, so their sum is a site
    of the loop body (``add_any``), as in the reference's scan transpose."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _LoopConst.apply(x)


def _formulas_walk() -> bool:
    """Whether a walk that follows the reference's formulas runs on this
    thread (the autograd engine's threads carry the caller's modes)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    mode = _get_current_dispatch_mode()
    return isinstance(mode, _WalkMode) and mode.formulas


class _ZeroCotangents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *xs):
        ctx.like = [(x.shape, x.dtype, x.device,
                     x.device_mesh if _shd._is_dtensor(x) else None)
                    for x in xs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        if not _formulas_walk():
            return (g,) + (None,) * len(ctx.like)
        # on a mesh, the zeros every rank holds whole
        return (g,) + tuple(
            _shd.replicate_on(mesh, torch.zeros(s, dtype=d, device=v))
            for s, d, v, mesh in ctx.like)


def zero_cotangents(out, *xs):
    """``out``, and in the backward pass of a walk that follows the
    reference's formulas a zero cotangent for each of ``xs``, delivered
    before any other (its node runs first: ``out`` is downstream of every
    use of ``xs``). The reference's scan transpose starts the cotangent of
    a final carry, and the sum of a const's cotangents, at zero and adds
    each trip's to it (``add_any``, a site); autograd starts from the first
    that arrives. A plain run delivers none."""
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (out,) + xs)):
        return out
    return _ZeroCotangents.apply(out, *xs)


# --------------------------------------------------------------------------
# derivative formulas: the reference's elementary ops
# --------------------------------------------------------------------------
#
# autograd's formulas are not JAX's JVP rules, and a policy rounds every
# elementary op of a formula. Where the two differ on the models' paths, a
# walk that rounds (a live policy, a table, an enumeration) computes the
# reference's ops instead, each a site of the backward frame in the
# reference's order; a plain run keeps autograd's. Each entry is keyed by
# the autograd node's name and gets the op autograd dispatched; it returns
# the op's value, or ``_MISS`` to run the op as it is.

_RSQRT = torch.ops.aten.rsqrt.default
_SIGMOID_BACKWARD = torch.ops.aten.sigmoid_backward.default
_EXPAND = torch.ops.aten.expand.default
_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def _sigmoid_backward(mode, node, frame, pos, func, args):
    """``logistic``'s JVP: ``1 - s`` and ``s * (1 - s)`` (residuals), then
    the product with the cotangent; autograd's is one fused op."""
    if func is not _SIGMOID_BACKWARD:
        return _MISS
    g, s = args
    e = mode.on_output(frame, pos, 0, "sub", 1 - s)
    c = mode.on_output(frame, _Grads._next(frame, True)[1], 0, "mul", s * e)
    return mode.on_output(frame, _Grads._next(frame, True)[1], 0, "mul",
                          g * c)


def _rsqrt_backward(mode, node, frame, pos, func, args):
    """``rsqrt``'s JVP residual is ``-0.5 * (rsqrt(x) / x)``, a division
    and a product, and the cotangent's product with it; autograd's formula
    raises the result to the third power and scales the cotangent by -0.5
    (a policy that rounds products but not divisions tells them apart)."""
    if func is _MUL_SCALAR and _state(mode, node).pop("residual", False):
        return args[0]           # the -0.5 is the residual's
    if func is not _POW_SCALAR or args[1] != 3:
        return _MISS
    x = mode.grads.saved.pop(node._sequence_nr(), None)
    if x is None:
        return _MISS
    _state(mode, node)["residual"] = True
    emit = _emitter(mode, frame, pos)
    return emit("mul", emit("div", args[0] / x) * -0.5)


def _pow_backward(mode, node, frame, pos, func, args):
    """``x ** n``'s JVP, ``n * x ** (n - 1)`` times the cotangent: for
    ``n = 2`` (``square``, as the walk names ``x ** 2``) the power is ``x``
    itself, no op; for another integer ``n`` it is the reference's
    ``integer_pow``. autograd raises ``x`` to ``n - 1`` as a float power
    in both cases (a ``pow`` site)."""
    if (func is not _POW_SCALAR or not isinstance(args[1], float)
            or not args[1].is_integer()):
        return _MISS
    if args[1] == 1:
        return args[0]
    return mode.on_output(frame, pos, 0, "integer_pow", func(*args))


def _keepdim_sum_backward(mode, node, frame, pos, func, args):
    """``jnp.sum(..., keepdims=True)`` is ``reduce_sum`` and a
    ``broadcast_in_dim``, whose transpose sums the cotangent over the kept
    singleton axis (a site); autograd only expands it."""
    if func is not _EXPAND or not node._saved_keepdim:
        return _MISS
    g = mode.on_output(frame, pos, 0, "reduce_sum", args[0])
    return func(g, *args[1:])


def _unbroadcast(mode, node, frame, pos, func, args):
    """An operand of lower rank (``x * scale`` of shape ``(D,)``): ``jnp``
    promotes it with a ``broadcast_in_dim`` whose transpose is a second
    ``reduce_sum`` over the added axes; autograd's ``sum_to`` views them
    away."""
    if func not in _VIEWS or len(args[1]) >= args[0].dim():
        return _MISS
    return mode.on_output(frame, pos, 0, "reduce_sum", func(*args))


_SUM_DIM = torch.ops.aten.sum.dim_IntList
_WHERE = torch.ops.aten.where.self
_EQ = torch.ops.aten.eq.Tensor
_GE = torch.ops.aten.ge.Scalar
_DIV = torch.ops.aten.div.Tensor
_DIV_SCALAR = torch.ops.aten.div.Scalar
_NEG = torch.ops.aten.neg.default
_MUL = torch.ops.aten.mul.Tensor
_MUL_SCALAR = torch.ops.aten.mul.Scalar
_SQUEEZE = (torch.ops.aten.squeeze.dim, torch.ops.aten.squeeze.dims)


def _emitter(mode, frame, pos):
    """Sites from ``pos`` on, one position each: ``emit(prim, value)``."""
    at = [pos]

    def emit(prim, val):
        p = at[0] if at[0] is not None else _Grads._next(frame, True)[1]
        at[0] = None
        return mode.on_output(frame, p, 0, prim, val)
    return emit


def _state(mode, node) -> dict:
    return mode.grads.pending.setdefault(node._sequence_nr(), {})


def _needs(node) -> Tuple[bool, ...]:
    """Which of the node's inputs take a gradient."""
    return tuple(f is not None for f, _ in node.next_functions)


def _amax_backward(mode, node, frame, pos, func, args):
    """``reduce_max``'s JVP converts the location mask to the cotangent's
    type (``convert_element_type``) and sums it into the count
    (``reduce_sum``), both sites; autograd sums the boolean mask into an
    integer. The division by the count and the product with the mask are
    the same ops in both."""
    if func is _EQ:
        _state(mode, node)["dtype"] = args[0].dtype
        return _MISS
    if func is not _SUM_DIM or args[0].dtype != torch.bool:
        return _MISS
    emit = _emitter(mode, frame, pos)
    mask = emit("convert_element_type",
                args[0].to(_state(mode, node)["dtype"]))
    return emit("reduce_sum", func(mask, *args[1:]))


def _tie_weight(x, out, other_is_out):
    """``max``'s JVP weight of one operand: 1 where it is the result, over 2
    where the other operand is the result too."""
    return (x == out).to(x.dtype) / torch.where(other_is_out, 2.0, 1.0).to(
        x.dtype)


def _maximum_backward(mode, node, frame, pos, func, args):
    """``max``'s JVP splits a tie in halves through converted masks: each
    operand's weight is a division (a site, both computed once), its
    cotangent the product with the weight (a site). autograd halves the
    cotangent at a tie and selects; its ``grad / 2`` is no site here."""
    if pos < 0:
        return _MISS
    st = _state(mode, node)
    if func is _EQ:
        if "w" not in st:
            x, y = args
            out = torch.maximum(x, y)
            emit = _emitter(mode, frame, pos)
            wx = emit("div", _tie_weight(x, out, y == out))
            wy = emit("div", _tie_weight(y, out, x == out))
            # autograd runs the second operand's branch first
            needs = _needs(node)
            st["w"] = [w for w, need in ((wy, needs[1]), (wx, needs[0]))
                       if need]
        return func(*args)
    if func is _WHERE:
        return mode.on_output(frame, pos, 0, "mul", args[2] * st["w"].pop(0))
    if func is _DIV_SCALAR:
        return func(*args)
    return _MISS


def _clamp_backward(mode, node, frame, pos, func, args):
    """``max(x, c)``'s JVP (``jnp.maximum`` with a constant): the weight
    ``(x == out) / (1 + (c == out))`` is a division and the cotangent its
    product, both sites; autograd selects. A clamp with an upper bound
    keeps autograd's formula (its ``where`` also reads the ``le`` mask)."""
    if pos < 0 or getattr(node, "_saved_max", None) is not None:
        return _MISS
    st = _state(mode, node)
    if func is _GE and "x" not in st:
        st["x"], st["c"] = args
        return func(*args)
    if func is _WHERE and "x" in st:
        x = st["x"]
        out = torch.clamp(x, min=st["c"])
        emit = _emitter(mode, frame, pos)
        w = emit("div", _tie_weight(x, out, out == st["c"]))
        return emit("mul", args[1] * w)
    return _MISS


def _div_backward(mode, node, frame, pos, func, args):
    """``div``'s JVP in the denominator ``y`` is ``g * integer_pow(y, -2) *
    x``, summed over the axes ``y`` was broadcast along, then negated: an
    ``integer_pow``, two products and a ``reduce_sum`` as sites, where
    autograd divides twice. Applies where ``y`` takes a gradient and has
    the numerator's rank; otherwise ``_unbroadcast``.

    autograd runs the denominator's branch first -- ``x / y``, ``/ y``,
    ``-g`` and the product, which is its cotangent -- then ``g / y`` (the
    numerator's, the same in both) if the numerator takes a gradient."""
    needs = _needs(node)
    if pos < 0 or len(needs) != 2 or not needs[1]:
        return _unbroadcast(mode, node, frame, pos, func, args)
    st = _state(mode, node)
    if st.get("fallback"):
        return _unbroadcast(mode, node, frame, pos, func, args)
    if func is _DIV:
        n = st["divs"] = st.get("divs", 0) + 1
        if n == 1:
            x, y = args
            if x.dim() != y.dim():
                st["fallback"] = True
                return _MISS
            st["x"], st["y"] = x, y
        return func(*args) if n <= 2 else _MISS
    if func is _NEG and "x" in st and "dy" not in st:
        g, x, y = args[0], st["x"], st["y"]
        emit = _emitter(mode, frame, pos)
        t = emit("mul", g * emit("integer_pow", 1.0 / (y * y)))
        t = emit("mul", t * x)
        dims = [i for i in range(t.dim()) if y.shape[i] == 1 != t.shape[i]]
        if dims:
            t = emit("reduce_sum", t.sum(dims, keepdim=True))
        st["dy"] = -t
        return func(*args)
    if func is _MUL and "dy" in st:
        return st.pop("dy")
    return _MISS


def _unsqueeze_backward(mode, node, frame, pos, func, args):
    """``x[..., None]`` is a ``broadcast_in_dim`` to the reference, whose
    transpose is a ``reduce_sum`` over the new axis (a site); autograd
    squeezes it away."""
    if func not in _SQUEEZE or "->" in frame.stack.rpartition("/")[2]:
        # torch.einsum's own unsqueezes: the reference's einsum is a
        # dot_general, with no broadcast to transpose
        return _MISS
    return mode.on_output(frame, pos, 0, "reduce_sum", func(*args))


def _abs_backward(mode, node, frame, pos, func, args):
    """``abs``'s transpose selects the cotangent or its negation and adds
    the two branches (``add_any``, a site); autograd multiplies by the
    sign."""
    if func is not _MUL:
        return _MISS
    g, sign = args
    return mode.on_output(frame, pos, 0, "add_any",
                          torch.where(sign >= 0, g, -g))


_FORMULAS = {
    "SigmoidBackward0": _sigmoid_backward,
    "RsqrtBackward0": _rsqrt_backward,
    "PowBackward0": _pow_backward,
    "SumBackward1": _keepdim_sum_backward,
    **{f"{op}Backward0": _unbroadcast for op in ("Mul", "Add", "Sub")},
    "DivBackward0": _div_backward,
    "AmaxBackward0": _amax_backward,
    "MaximumBackward0": _maximum_backward,
    "ClampBackward1": _clamp_backward,
    "ClampMinBackward0": _clamp_backward,
    "UnsqueezeBackward0": _unsqueeze_backward,
    "AbsBackward0": _abs_backward,
}


# --------------------------------------------------------------------------
# the modes
# --------------------------------------------------------------------------

def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dtype.is_floating_point


def _maybe_quantize(val, rule: TruncationRule, impl: str):
    if not _is_float(val):
        return val
    return _shd.map_local(lambda v: _quantize_rule(v, rule, impl), val)


def _quantize_rule(val, rule: TruncationRule, impl: str):
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
    runs it on a second lane too). Where an op runs is ``_Grads.site``'s
    answer: a forward op's frame, or the backward frame of the forward op
    whose autograd node it belongs to."""

    # whether backward ops follow the reference's formulas (``_FORMULAS``):
    # every walk that rounds or enumerates
    formulas = True

    def __enter__(self):
        # a DTensor needs a process group: without one the walk skips
        # DTensor's bookkeeping
        self.sharded = _shd.dtensors_possible()
        self.grads = _Grads(self.sharded)
        _tls.walks += (self.grads,)
        return super().__enter__()

    def __exit__(self, *exc):
        _tls.walks = _tls.walks[:-1]
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.sharded:
            return self._dispatch(func, args, kwargs)
        seq = _sequence_nr()
        try:
            return self._dispatch(func, args, kwargs)
        finally:
            # DTensor's dispatch of an op (a redistribution, ``from_local``)
            # may make autograd nodes of its own below the walk: no later
            # op claims them
            if _sequence_nr() != seq:
                self.grads.absorb()

    def _dispatch(self, func, args, kwargs):
        grads = self.grads
        frame, pos, backward = grads.site(func is not _DETACH)
        kwargs = kwargs or {}
        if frame is None:              # DTensor's data movement: no site
            return func(*args, **kwargs)
        prim, mutates = prim_name(func, args)
        if backward:
            prim = _BACKWARD_PRIM.get(prim, prim)
            node = grads.node
            formula = (_FORMULAS.get(node.name())
                       if self.formulas and node is not None and not kwargs
                       else None)
            if formula is not None:
                with self.formula_lanes():
                    out = formula(self, node, frame, pos, func, args)
                if out is not _MISS:
                    return out
        elif func is _RSQRT and grads.claimed is not None and self.formulas:
            grads.saved[grads.claimed] = args[0]
        args, kwargs, routed = self.on_inputs(frame, pos, prim, func, args,
                                              kwargs)
        if (func is _MASKED_FILL and self.sharded and args[2] == 0
                and _shd.is_partial(args[0])):
            out = _shd.masked_zero_(args[0], args[1])
        else:
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

    def formula_lanes(self):
        """The context a derivative formula (``_FORMULAS``) runs its ops in
        (mem-mode runs them on both lanes)."""
        return contextlib.nullcontext()

    def run(self, func, args, kwargs, mutates):
        return func(*args, **kwargs)

    def on_output(self, frame, pos, out_idx, prim, val):
        return val


class _PolicyMode(_WalkMode):
    """Formats fixed by the policy: the original op-mode transform. ``plan``
    memoises the rule decided for every (site key) of one input signature,
    so matching runs once per signature.

    ``native_fp8``: a ``quantize_dot_inputs`` dot site whose rule takes the
    native path (``_native_fp8_rule``) runs as ``fp8_dot.fp8_aten_dot``
    (operands stored as float8_e4m3fn, f32 sums) instead of the op on
    operands rounded in their carrier dtype."""

    def __init__(self, policy: TruncationPolicy, impl: str, plan: Dict,
                 native_fp8: bool = False):
        super().__init__()
        self.policy, self.impl, self.plan = policy, impl, plan
        # fast path: a policy with no rules can never match (and leaves
        # autograd's formulas as a plain run has them)
        self.live = self.formulas = bool(policy.rules)
        self.native_fp8 = native_fp8
        self._fp8 = None            # the native format of the op about to run

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
                    self._fp8 = self._native_fp8_rule(rule0, func, args,
                                                      kwargs)
                    if self._fp8 is None:
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

    def _native_fp8_rule(self, rule, func, args, kwargs):
        """The parsed format when this dot should take the native fp8 path
        (an e4m3-storable format, no mask, a plain two-operand dot --
        ``mm`` or ``bmm`` -- with a floating output), else ``None``: the
        emulated input quantize. The reference's rule."""
        if (not self.native_fp8 or func not in _fp8.ATEN_DOTS or kwargs
                or rule.mask is not None or len(args) != 2
                or not all(_is_float(a) for a in args)):
            return None
        fmt = parse_format(rule.fmt)
        if not _fp8.is_native_fp8_format(fmt):
            return None
        if any(_shd._is_dtensor(a) for a in args):
            raise NotImplementedError(
                "native_fp8 on DTensor operands is not ported: the fp8 dot "
                "kernel takes whole tensors (gather the parameters, or "
                "truncate without native_fp8)")
        return fmt

    def run(self, func, args, kwargs, mutates):
        fmt, self._fp8 = self._fp8, None
        if fmt is not None:
            return _fp8.fp8_aten_dot(func, args, saturate=fmt.saturate,
                                     impl=self.impl)
        return func(*args, **kwargs)

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
        return _shd.map_local(lambda v: self._round(v, site), val)

    def _round(self, val, site: int):
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
        self.counts: List[int] = []  # executions of each site

    def on_output(self, frame, pos, out_idx, prim, val):
        if not val.dtype.is_floating_point:
            return val
        key = (frame.path, pos, out_idx)
        i = self.by_key.get(key)
        if i is None:
            if self.site_policy.rule_for(frame.stack, prim, val.dtype) is None:
                return val
            i = self.by_key[key] = len(self.sites)
            self.sites.append(QuantizeSite(i, frame.stack, prim, val.dtype))
            self.counts.append(0)
        self.counts[i] += 1
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
    site in a body that runs N times counts N), ``index.counts`` the
    executions of each site."""
    _check_plain_rules(site_policy, "site policies")
    mode = _EnumMode(site_policy)
    with _fresh_root(), mode:
        fn(*args, **kwargs)
    index = SiteIndex(mode.sites, mode.by_key)
    index.counts = mode.counts
    index.executions = sum(mode.counts)
    return index


def run_quantized(fn, args, kwargs, policy: TruncationPolicy,
                  impl: str = "auto", plan: Optional[Dict] = None, *,
                  native_fp8: bool = False):
    """Run ``fn(*args, **kwargs)`` with op-mode truncation under ``policy``.
    ``plan`` carries the per-site rule decisions between runs of one input
    signature. ``native_fp8`` runs ``quantize_dot_inputs`` dot sites whose
    format maps onto float8_e4m3fn on fp8 storage (``_PolicyMode``)."""
    mode = _PolicyMode(policy, impl, {} if plan is None else plan,
                       native_fp8)
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
