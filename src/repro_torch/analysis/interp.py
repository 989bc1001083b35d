"""Abstract interpretation of one run of a program over the :mod:`domain`
lattice (the port's counterpart of the reference's ``analysis/interp.py``).

The reference walks a closed jaxpr. The port has no graph: ``analyze``
runs the program once under a walk mode (``interpreter._WalkMode``, as
``enumerate_sites`` does), rounding nothing and launching no quantizer,
and follows the dispatch stream. Every op gets its position exactly as the
enumeration gives it, so a record's key ``(frame path, position, output
index)`` is the key ``SiteIndex.site_keys()`` holds for the same site;
backward ops take their forward op's frame through ``_Grads.site``.

  * **Values.** Every live tensor carries an :class:`AbsVal` (a weak map);
    each op's outputs get :func:`domain.transfer` of its operands' values,
    and each float output's record is the join over the site's
    executions. The program's tensor arguments take ``calib`` (an
    ``AbsVal`` or a concrete array per tensor leaf of ``(args, kwargs)``,
    ``from_concrete`` of an array), or their dtype's top when ``calib`` is
    ``None``. A tensor that reaches an op without a value (a closed-over
    parameter, a buffer) is a constant: ``from_concrete``, as the
    reference's ``abs_const`` does for consts. Constants an op builds from
    Python numbers (``full``, ``arange``, a scalar operand) take the
    number's exact facts; integer and boolean outputs take transfers or
    their dtype's top, so the run makes no host transfer for them.
  * **Loops.** Python loops arrive trip by trip. Inside a ``loop_body`` /
    ``scope(loop=True)`` trip, a site's output flows as the join of its
    record so far (the reference's ``acc ⊔ body(acc)``); after
    ``warm_iters`` executions in which that join still grew, the site is
    widened to its carrier top and counted in ``n_widened``.
  * **Data-dependent control flow.** An op that reads a tensor on the host
    (``_local_scalar_dense``: ``item()``, ``bool(t)``) makes its frame the
    port's ``while`` or ``cond``: no site under that frame is critical and
    criticality does not pass through its ops, as the reference's while
    bodies and cond branches yield none. A branch the run did not take has
    no sites at all (ROADMAP Queue C).
  * **Criticality.** A backward pass over the tape of (operands, outputs,
    record keys) with the reference's preserving positions: a record is
    critical when a non-finite at its output provably reaches a program
    output. The reference's scan-body least fixpoint becomes one pass over
    the unrolled trips: a site is critical when one of its executions is,
    and its record's ``lo`` (a join: the least over the trips) holds at
    every execution.

Where the port's facts differ from the reference's: unrolled trips join
only the values the trips had (tighter than a widened fixpoint until
``warm_iters`` growing trips widen them), a derivative formula's
intermediate values (``interpreter._FORMULAS``) take their carrier top,
and an aten op that stands for several primitives (``silu``, ``_softmax``,
``mean``) takes the top of its output's carrier.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.domain import (
    AbsVal, Aval, Call, from_concrete, join, leq, top_for_dtype, transfer,
)
from repro_torch.core import interpreter as _interp

RecordKey = Tuple[str, int, int]

_DOT_PRIMS = frozenset({"dot_general", "conv_general_dilated", "ragged_dot"})


@dataclasses.dataclass
class DotInputs:
    """Abstract operands of a dot-like site (for accumulator-risk lint)."""
    lhs: AbsVal
    rhs: AbsVal
    n: int  # contraction size


@dataclasses.dataclass
class AnalysisResult:
    records: Dict[RecordKey, AbsVal]
    critical: Dict[RecordKey, bool]
    dot_inputs: Dict[RecordKey, DotInputs]
    out_vals: List[AbsVal]
    n_widened: int

    @property
    def outputs_finite(self) -> bool:
        return all(v.finite for v in self.out_vals)

    def value_at(self, key: RecordKey) -> Optional[AbsVal]:
        return self.records.get(key)

    def critical_at(self, key: RecordKey) -> bool:
        return self.critical.get(key, False)


# --------------------------------------------------------------------------
# what an aten call's operands are to the reference's primitive
# --------------------------------------------------------------------------

# aten ops that stand for several primitives, or for another function than
# the one their primitive name gives: their output takes its carrier top
_FUSED = frozenset({
    "silu", "gelu", "native_dropout", "tanh_backward", "sigmoid_backward",
    "logsumexp", "_log_softmax", "_softmax", "reciprocal", "mean",
})
# factories of a constant: (index of the fill value in args, else the value)
_FILLS = {"full": 1, "full_like": 1, "new_full": 2, "scalar_tensor": 0,
          "zeros": 0.0, "zeros_like": 0.0, "new_zeros": 0.0,
          "ones": 1.0, "ones_like": 1.0, "new_ones": 1.0}
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "dot": (0, 1), "mv": (0, 1),
         "addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2),
         "addmv": (1, 2)}
_SCATTER_ADDS = frozenset({"scatter_add", "index_add",
                           "embedding_dense_backward"})
# what ``item()`` and ``bool(t)`` reach the walk as
_HOST_READ = "_local_scalar_dense"

# primitives whose every operand's non-finites survive into the output,
# and those whose first operand's do (the reference's tables)
_PRESERVE_ALL = frozenset({
    "add", "sub", "mul", "dot_general", "conv_general_dilated",
    "ragged_dot", "concatenate",
})
_PRESERVE_FIRST = frozenset({
    "neg", "abs", "log", "sqrt", "reduce_sum", "reduce_prod", "cumsum",
    "reshape", "transpose", "broadcast_in_dim", "broadcast", "rev",
    "squeeze", "expand_dims", "copy", "stop_gradient", "real",
    "device_put", "optimization_barrier", "sharding_constraint",
})


def _base_name(func) -> str:
    name = func._schema.name.partition("::")[2]
    return name[:-1] if name.endswith("_") and name != "_" else name


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _reduced(shape, dims) -> int:
    """Elements each output of a reduction over ``dims`` sums."""
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return max(_numel(shape), 1)
    if isinstance(dims, int):
        dims = [dims]
    n = 1
    for d in dims:
        n *= int(shape[d]) if shape else 1
    return max(n, 1)


def _layout(name: str, prim: str, func, args, kwargs):
    """``(primitive, operands, params)`` of one aten call as the reference's
    equation would have them, or ``None`` when the call takes its
    output's top. Operands are tensors, Python numbers or ``None`` (an
    integer index operand the transfer does not read)."""
    ov = func._overloadname
    if name in _FUSED or prim == "random_bits":
        return None
    if name in _DOTS:
        i, j = _DOTS[name]
        if kwargs.get("alpha", 1) != 1 or kwargs.get("beta", 1) != 1:
            return None
        a = args[i]
        return "dot_general", [args[i], args[j]], {
            "n": int(a.shape[0] if name == "dot" else a.shape[-1]),
            "bias": args[0] if i else None}
    if name == "convolution":
        return "conv_general_dilated", [args[0], args[1]], {}
    if name in _SCATTER_ADDS:
        if name == "embedding_dense_backward":
            return "scatter-add", [0.0, None, args[0]], {}
        return "scatter-add", [args[0], None, args[3]], {}
    if name == "index_put":
        acc = len(args) > 3 and args[3]
        return ("scatter-add" if acc else "scatter"), \
            [args[0], None, args[2]], {}
    if name == "scatter":
        return "scatter", [args[0], None, args[3]], {}
    if name in ("add", "sub") and kwargs.get("alpha", 1) != 1:
        return None
    if name == "rsub":
        return "sub", [args[1], args[0]], {}
    if name in ("max", "min") and ov != "other":
        red = "reduce_max" if name == "max" else "reduce_min"
        return red, [args[0]], {}
    if name == "relu":
        return "max", [args[0], 0.0], {}
    if name == "pow":
        if ov == "Tensor_Scalar" and isinstance(args[1], int):
            return prim, [args[0]], {"y": int(args[1])}
        return None
    if name in ("sum", "prod"):
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        return prim, [args[0]], {"n_reduced": _reduced(args[0].shape, dims)}
    if name == "cumsum":
        return prim, [args[0]], {
            "n_reduced": int(args[0].shape[args[1]]) if args[0].dim() else 1}
    if name in ("cat", "stack"):
        return "concatenate", list(args[0]), {}
    if name == "constant_pad_nd":
        return "pad", [args[0], args[2] if len(args) > 2 else 0.0], {
            "crop": any(p < 0 for p in args[1])}
    if name in ("select_backward", "slice_backward"):
        return "pad", [args[0], 0.0], {}
    if name == "where":
        return "select_n", [args[0], args[1], args[2]], {}
    if name == "masked_fill":
        return "select_n", [args[1], args[0], args[2]], {}
    if name in ("tril", "triu"):
        return "select_n", [None, args[0], 0.0], {}
    if name == "threshold_backward":
        return "select_n", [None, args[0], 0.0], {}
    if name in ("clamp", "clamp_min", "clamp_max"):
        bounds = [a for a in args[1:3] if a is not None]
        bounds += [v for k, v in kwargs.items()
                   if k in ("min", "max") and v is not None]
        return "clamp", [args[0]] + bounds, {}
    if name == "copy":
        return "copy", [args[1]], {}
    if prim in ("add", "sub", "mul", "div", "max", "min", "rem", "atan2",
                "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "xor",
                "add_any"):
        return prim, [args[0], args[1]], {}
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors:
        return None
    return prim, [tensors[0]], {}


def _preserve_positions(prim: str, params: dict, n_in: int,
                        in_float: bool) -> List[int]:
    """Operand positions whose non-finite elements provably survive into
    the (single, floating) output."""
    if prim in _PRESERVE_ALL:
        return list(range(n_in))
    if prim in _PRESERVE_FIRST or prim == "div":
        return [0]
    if prim == "integer_pow":
        return [0] if int(params.get("y", 0)) > 0 else []
    if prim == "convert_element_type":
        return [0] if in_float else []
    if prim == "pad":
        return [] if params.get("crop") else [0]
    if prim == "scatter-add":
        return [0]
    return []


# --------------------------------------------------------------------------
# the walk
# --------------------------------------------------------------------------

class _AnalyzeMode(_interp._WalkMode):
    """Runs the program unchanged and follows each tensor's abstract
    value; rounds nothing."""

    def __init__(self, warm_iters: int):
        super().__init__()
        self.warm_iters = warm_iters
        self.vals = WeakIdKeyDictionary()      # tensor -> (AbsVal, value id)
        self.records: Dict[RecordKey, AbsVal] = {}
        self.dot_inputs: Dict[RecordKey, DotInputs] = {}
        self.grew: Dict[RecordKey, int] = {}
        self.widened: set = set()
        # (operand ids, output ids, record keys, preserving positions,
        # frame path) of every op, in program order
        self.tape: List[tuple] = []
        self.dynamic: set = set()              # frame paths with host reads
        self._next = 0
        self._consts: Dict[tuple, AbsVal] = {}
        self._pending: Dict[int, tuple] = {}

    # ---- values -----------------------------------------------------------
    def _vid(self) -> int:
        self._next += 1
        return self._next

    def bind(self, t: torch.Tensor, v: AbsVal) -> int:
        vid = self._vid()
        self.vals[t] = (v, vid)
        return vid

    def value(self, t: torch.Tensor) -> Tuple[AbsVal, int]:
        hit = self.vals.get(t)
        if hit is None:
            # a constant: a closed-over parameter, a buffer
            v = from_concrete(t)
            hit = (v, self.bind(t, v))
        return hit

    def _number(self, x, dtype) -> AbsVal:
        key = (x, type(x), dtype)
        v = self._consts.get(key)
        if v is None:
            v = self._consts[key] = from_concrete(torch.tensor(x,
                                                               dtype=dtype))
        return v

    # ---- the op -----------------------------------------------------------
    def on_inputs(self, frame, pos, prim, func, args, kwargs):
        self._call = (frame, prim, func, args, kwargs)
        return args, kwargs, ()

    def run(self, func, args, kwargs, mutates):
        out = func(*args, **kwargs)
        frame, prim, func, args, kwargs = self._call
        name = _base_name(func)
        if name == _HOST_READ:
            self.dynamic.add(frame.path)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        tensors = [o for o in outs if isinstance(o, torch.Tensor)]
        self._pending = {}
        if not tensors:
            return out
        vals, in_ids, pres = self._abstract(name, prim, func, args, kwargs,
                                            tensors)
        out_ids = []
        for o, v in zip(tensors, vals):
            vid = self._vid()
            self._pending[id(o)] = (v, vid)
            out_ids.append(vid)
        self.tape.append([in_ids, out_ids, [None] * len(tensors), pres,
                          frame.path])
        return out

    def _abstract(self, name, prim, func, args, kwargs, outs):
        """(output values, operand ids, preserving positions)."""
        out_avals = tuple(Aval(tuple(o.shape), o.dtype) for o in outs)
        tops = [top_for_dtype(o.dtype) for o in outs]
        if name in _FILLS or name == "arange":
            return self._factory(name, args, kwargs, outs), [], []
        if name.startswith("empty"):
            return tops, [], []
        lay = _layout(name, prim, func, args, kwargs)
        if lay is None:
            return tops, [], []
        tprim, operands, params = lay
        fdt = next((o.dtype for o in outs if o.dtype.is_floating_point),
                   None)
        if fdt is None:
            fdt = next((a.dtype for a in operands
                        if isinstance(a, torch.Tensor)
                        and a.dtype.is_floating_point), torch.float32)
        ins, in_avals, in_ids = [], [], []
        for a in operands:
            if isinstance(a, torch.Tensor):
                v, vid = self.value(a)
                ins.append(v)
                in_avals.append(Aval(tuple(a.shape), a.dtype))
                in_ids.append(vid)
            elif isinstance(a, (bool, int, float)):
                ins.append(self._number(a, fdt))
                in_avals.append(Aval((), fdt))
                in_ids.append(None)
            else:
                ins.append(top_for_dtype(torch.int64))
                in_avals.append(Aval((), torch.int64))
                in_ids.append(None)
        bias = params.pop("bias", None)
        if tprim == "select_n" and ins and in_ids[0] is None:
            ins[0] = top_for_dtype(torch.bool)
        vals = transfer(Call(tprim, params, tuple(in_avals), out_avals), ins)
        if bias is not None:
            # addmm and the like: the product, then the bias added
            bv, bid = self.value(bias)
            vals = transfer(Call("add", {}, (out_avals[0], Aval(
                tuple(bias.shape), bias.dtype)), out_avals), [vals[0], bv])
            in_ids = in_ids + [bid]
        if tprim in _DOT_PRIMS and len(ins) >= 2:
            self._dot = DotInputs(ins[0], ins[1], int(params.get("n", 1)))
        else:
            self._dot = None
        pres = []
        if len(outs) == 1 and outs[0].dtype.is_floating_point:
            in_float = bool(in_avals) and in_avals[0].dtype.is_floating_point
            pres = _preserve_positions(tprim, params, len(in_ids), in_float)
        return vals, in_ids, pres

    def _factory(self, name, args, kwargs, outs):
        dt = outs[0].dtype
        if name == "arange":
            nums = [a for a in args if isinstance(a, (int, float))]
            start, end, step = 0, nums[0], 1
            if len(nums) >= 2:
                start, end = nums[0], nums[1]
            if len(nums) >= 3:
                step = nums[2]
            return [from_concrete(torch.arange(start, end, step, dtype=dt))]
        fill = _FILLS[name]
        if isinstance(fill, int) and not isinstance(fill, bool):
            fill = args[fill] if len(args) > fill else kwargs.get(
                "fill_value", 0)
        return [self._number(fill, dt)]

    def on_output(self, frame, pos, out_idx, prim, val):
        hit = self._pending.pop(id(val), None)
        if hit is None:
            # a derivative formula's value (``interpreter._FORMULAS``): the
            # walk sees the op's result, not its operands
            v, vid = top_for_dtype(val.dtype), self._vid()
            self.tape.append([[], [vid], [None], [], frame.path])
            entry = self.tape[-1]
            idx = 0
        else:
            v, vid = hit
            entry = self.tape[-1]
            idx = entry[1].index(vid)
        if val.dtype.is_floating_point:
            key = (frame.path, pos, out_idx)
            prev = self.records.get(key)
            if frame.depth > 0:
                # one trip of a loop: the site's value is the join of every
                # trip so far, widened after warm_iters growing trips
                if key in self.widened:
                    v = prev
                elif prev is not None:
                    new = join(prev, v)
                    if not leq(new, prev):
                        self.grew[key] = self.grew.get(key, 0) + 1
                        if self.grew[key] >= self.warm_iters:
                            self.widened.add(key)
                            new = top_for_dtype(val.dtype)
                    v = new
                self.records[key] = v
            else:
                self.records[key] = v if prev is None else join(prev, v)
            entry[2][idx] = key
            if prim in _DOT_PRIMS and out_idx == 0 and hit is not None \
                    and self._dot is not None:
                d, old = self._dot, self.dot_inputs.get(key)
                self.dot_inputs[key] = d if old is None else DotInputs(
                    join(old.lhs, d.lhs), join(old.rhs, d.rhs),
                    max(old.n, d.n))
        self.vals[val] = (v, vid)
        return val

    # ---- criticality ------------------------------------------------------
    def mark(self, out_ids: Sequence[int]) -> Dict[RecordKey, bool]:
        dyn = tuple(self.dynamic)

        def dynamic(path: str) -> bool:
            return any(path == p or path.startswith(p + "/") or p == ""
                       for p in dyn)

        crit = set(out_ids)
        critical: Dict[RecordKey, bool] = {}
        for in_ids, o_ids, keys, pres, path in reversed(self.tape):
            ocrit = [o in crit for o in o_ids]
            if not any(ocrit) or dynamic(path):
                continue
            for key, c in zip(keys, ocrit):
                if c and key is not None:
                    critical[key] = True
            for i in pres:
                if i < len(in_ids) and in_ids[i] is not None:
                    crit.add(in_ids[i])
        return critical


def analyze(fn, args: Sequence = (), kwargs: Optional[dict] = None,
            calib: Optional[Sequence[Any]] = None, *,
            warm_iters: int = 3) -> AnalysisResult:
    """Run ``fn(*args, **kwargs)`` once under the abstract walk and return
    its per-site records, criticality and output envelopes.

    ``calib``: one entry per tensor leaf of ``(args, kwargs)`` — an
    :class:`AbsVal`, or a concrete array to abstract exactly
    (``from_concrete``). ``None`` starts every leaf at its dtype's top
    (range facts then come only from constants and structure). The run
    rounds nothing and launches no quantizer; its keys line up with the
    ``SiteIndex`` an enumeration of the same call under the same grad mode
    gives."""
    kwargs = dict(kwargs or {})
    mode = _AnalyzeMode(warm_iters)
    leaves = [x for x in pytree.tree_leaves((tuple(args), kwargs))
              if isinstance(x, torch.Tensor)]
    if calib is not None:
        calib = list(calib)
        if len(calib) != len(leaves):
            raise ValueError(f"analyze: got {len(calib)} calibration "
                             f"entries for {len(leaves)} tensor inputs")
    for i, t in enumerate(leaves):
        if calib is None:
            v = top_for_dtype(t.dtype)
        else:
            c = calib[i]
            v = c if isinstance(c, AbsVal) else from_concrete(c)
        mode.bind(t, v)
    with _interp._fresh_root(), mode:
        out = fn(*args, **kwargs)
    outs = [o for o in pytree.tree_leaves(out) if isinstance(o, torch.Tensor)]
    out_vals, out_ids = [], []
    for o in outs:
        v, vid = mode.value(o)
        out_vals.append(v)
        out_ids.append(vid)
    return AnalysisResult(records=mode.records, critical=mode.mark(out_ids),
                          dot_inputs=mode.dot_inputs, out_vals=out_vals,
                          n_widened=len(mode.widened))
