"""Truncation policies: *where* and *what* to truncate.

Mirrors RAPTOR's configuration surface:
  * program scope      -> rule with scope="**"
  * function/module    -> scope glob over the ``repro_torch.core.scope`` name
                          stack (the models name every module:
                          "layer/attn/qkv", ...)
  * width-conditional  -> ``from_width`` (RAPTOR's "64_to_5_14;32_to_3_8")
  * granular           -> ``ops`` / ``exclude_ops`` primitive filters
  * fenced-off regions -> policy-level ``excludes`` (paper §6.3 module
                          exclusion flow: "exclude Recon, re-run")
  * dynamic truncation -> ``mask`` rule field: truncate only elements where a
                          runtime predicate holds (the AMR M-l analogue)

Rules name operations by the reference package's *primitive* vocabulary
(``dot_general``, ``add``, ``exp``, ...), so a policy written for either
package — and its JSON — means the same in both. The interpreter maps every
aten overload it meets onto that vocabulary (``core/interpreter.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import re
import weakref
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch.core.formats import FPFormat, parse_format

# --------------------------------------------------------------------------
# scope glob matching over name stacks ("a/b/c"), '**' crosses '/' boundaries
# --------------------------------------------------------------------------


def _translate(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i:i + 2] == "**":
                out.append(".*")
                i += 2
                if i < len(pattern) and pattern[i] == "/":
                    i += 1  # '**/' also matches zero segments
            else:
                out.append("[^/]*")
                i += 1
        elif c == "?":
            out.append("[^/]")
            i += 1
        else:
            out.append(re.escape(c))
            i += 1
    return "".join(out)


def compile_scope(pattern: str):
    """Compile a scope glob. A pattern matches if it matches the full name
    stack or any of its prefixes at '/' boundaries (so ``layer/attn`` matches
    eqns whose stack is ``layer/attn/qkv/...`` — RAPTOR's "truncate the whole
    call tree below the marked function")."""
    rx = re.compile(_translate(pattern) + r"(/.*)?$")
    return rx


def scope_matches(rx, name_stack: str) -> bool:
    return rx.match(name_stack) is not None


_WRAPPER_RE = re.compile(
    r"^(?:jvp|transpose|vmap|pmap|remat|checkpoint|custom_jvp|custom_vjp)"
    r"\((.*)\)$")
_DROP_SEGMENTS = frozenset({"", "rematted_computation", "checkpoint"})


def normalize_stack(name_stack: str) -> str:
    """Strip transform decorations from a name stack:
    "transpose(jvp(mlp))/dot" -> "mlp/dot". The port's own scope stacks
    carry none, but stacks recorded by the reference package (in policy
    artifacts, in site lists) do, and must normalize identically."""
    out = []
    for seg in name_stack.split("/"):
        while True:
            m = _WRAPPER_RE.match(seg)
            if not m:
                break
            seg = m.group(1)
        if seg not in _DROP_SEGMENTS:
            out.append(seg)
    return "/".join(out)


def join_stack(prefix: str, name_stack: str) -> str:
    """Join an outer HOP scope prefix with an inner (relative) name stack —
    eqns inside scan/cond/jit bodies carry stacks relative to the HOP eqn."""
    if prefix and name_stack:
        return f"{prefix}/{name_stack}"
    return prefix or name_stack


# --------------------------------------------------------------------------
# dynamic (state-dependent) truncation masks — paper's "dynamic truncation"
# --------------------------------------------------------------------------

MaskFn = Callable[[torch.Tensor], torch.Tensor]


def magnitude_below(threshold: float) -> MaskFn:
    """Truncate only elements with |x| < threshold — the transformer analogue
    of 'truncate AMR blocks where the solution is smooth'."""
    def fn(x):
        return x.abs() < threshold
    fn.__name__ = f"magnitude_below_{threshold}"
    return fn


def magnitude_above(threshold: float) -> MaskFn:
    def fn(x):
        return x.abs() > threshold
    fn.__name__ = f"magnitude_above_{threshold}"
    return fn


# process-unique, never-reused tokens for mask callables. ``id(mask)`` is NOT
# a stable identity: CPython reuses addresses as soon as the object is
# collected, so a cache key built on a dead mask's id would alias a later,
# different mask and poison every trace cache keyed on policies (the cached
# executable quantizes with the *old* predicate). Tokens are handed out once
# per live object and the WeakKeyDictionary forgets them only when the mask
# itself dies — after which the token number is never issued again.
_MASK_TOKENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_MASK_PINS: Dict[int, Tuple[object, int]] = {}   # non-weakrefable fallback
_mask_counter = itertools.count()


def _mask_token(mask) -> int:
    try:
        tok = _MASK_TOKENS.get(mask)
        if tok is None:
            tok = next(_mask_counter)
            _MASK_TOKENS[mask] = tok
        return tok
    except TypeError:
        # callable instance without __weakref__ support: pin it for the
        # process lifetime so its id can never be recycled, and re-check
        # identity in case a pin-table hit is a different object (cannot
        # happen while pinned, but cheap to assert)
        ent = _MASK_PINS.get(id(mask))
        if ent is None or ent[0] is not mask:
            ent = (mask, next(_mask_counter))
            _MASK_PINS[id(mask)] = ent
        return ent[1]


class NotSerializableError(TypeError):
    """A policy carries state that cannot round-trip through JSON — today
    that means a rule with a ``mask`` callable (dynamic truncation
    predicates are arbitrary Python closures). Raised loudly instead of
    silently dropping the rule: a persisted artifact must reproduce the
    policy bit-for-bit or refuse to exist."""


# --------------------------------------------------------------------------
# rules & policy
# --------------------------------------------------------------------------

# structural primitives never produce new FP values — skipping them is
# exact and keeps op-mode overhead at one quantize per *arithmetic* op.
STRUCTURAL_PRIMS = frozenset({
    "reshape", "transpose", "broadcast_in_dim", "slice", "dynamic_slice",
    "dynamic_update_slice", "concatenate", "gather", "pad", "rev", "squeeze",
    "select_n", "copy", "stop_gradient", "iota", "split",
    "reduce_max", "reduce_min", "max", "min", "abs", "neg", "sign",
    "expand_dims", "real", "imag", "device_put", "broadcast",
    "clamp", "sort", "argmax", "argmin", "reduce_and", "reduce_or",
    "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "not", "xor",
    "is_finite", "floor", "ceil", "round", "sharding_constraint",
    "optimization_barrier", "layout_constraint",
})


@dataclasses.dataclass(frozen=True)
class TruncationRule:
    """One truncation instruction: ops in ``scope`` whose output dtype width
    matches ``from_width`` are rounded onto ``fmt``'s grid."""

    fmt: FPFormat
    scope: str = "**"
    from_width: Optional[int] = None          # 16/32/64; None = any float
    ops: Optional[Tuple[str, ...]] = None     # whitelist of primitive names
    exclude_ops: Tuple[str, ...] = ()
    quantize_dot_inputs: bool = False         # emulate low-precision MXU inputs
    mask: Optional[MaskFn] = None             # dynamic truncation predicate

    # set per-instance in __post_init__ via object.__setattr__; ClassVar so
    # the dataclass machinery (fields/eq/hash/asdict) never sees it
    _rx: ClassVar[Any]

    def __post_init__(self):
        object.__setattr__(self, "fmt", parse_format(self.fmt))
        object.__setattr__(self, "_rx", compile_scope(self.scope))

    def cache_key(self) -> tuple:
        """Stable hashable identity for trace caches. Mask functions are
        identified by (__name__, registry token): two policies sharing the
        same mask object alias, distinct closures never do — and unlike a
        raw ``id()`` the token is never reused after the mask is collected
        (see ``_mask_token``)."""
        mask_id = (None if self.mask is None
                   else (getattr(self.mask, "__name__", "<mask>"),
                         _mask_token(self.mask)))
        return (self.fmt.cache_key, self.scope, self.from_width, self.ops,
                self.exclude_ops, self.quantize_dot_inputs, mask_id)

    def to_json(self) -> dict:
        """Lossless JSON form. Mask-bearing rules raise
        :class:`NotSerializableError` — a runtime predicate is a closure,
        not data, and silently dropping it would persist a *different*
        policy than the one in memory."""
        if self.mask is not None:
            raise NotSerializableError(
                f"rule (scope={self.scope!r}) carries a dynamic mask fn "
                f"{getattr(self.mask, '__name__', self.mask)!r}; mask "
                "predicates are Python callables and cannot be serialized "
                "into a policy artifact")
        return {
            "fmt": self.fmt.to_json(),
            "scope": self.scope,
            "from_width": self.from_width,
            "ops": list(self.ops) if self.ops is not None else None,
            "exclude_ops": list(self.exclude_ops),
            "quantize_dot_inputs": self.quantize_dot_inputs,
        }

    @staticmethod
    def from_json(data: dict) -> "TruncationRule":
        ops = data.get("ops")
        return TruncationRule(
            fmt=FPFormat.from_json(data["fmt"]),
            scope=data["scope"],
            from_width=data.get("from_width"),
            ops=tuple(ops) if ops is not None else None,
            exclude_ops=tuple(data.get("exclude_ops", ())),
            quantize_dot_inputs=bool(data.get("quantize_dot_inputs", False)))

    def matches(self, name_stack: str, prim_name: str, out_dtype) -> bool:
        if prim_name in STRUCTURAL_PRIMS:
            return False
        if self.ops is not None and prim_name not in self.ops:
            return False
        if prim_name in self.exclude_ops:
            return False
        if not out_dtype.is_floating_point:
            return False
        if self.from_width is not None:
            if out_dtype.itemsize * 8 != self.from_width:
                return False
        return scope_matches(self._rx, name_stack)


# module-level census of *uncached* matcher evaluations: every rule_for call
# that actually ran normalization + regex matching (memo hits and the
# empty-policy short circuit in the interpreter don't count). Tests assert on
# deltas of this counter to pin the fast paths down.
MATCHER_EVALS = 0

_MEMO_MISS = object()


@dataclasses.dataclass(frozen=True)
class TruncationPolicy:
    """An ordered rule list plus fenced-off scopes. The *first* matching rule
    wins; ``excludes`` override everything (paper's iterative exclusion)."""

    rules: Tuple[TruncationRule, ...]
    excludes: Tuple[str, ...] = ()

    # set per-instance in __post_init__ via object.__setattr__ (ClassVar:
    # excluded from fields/eq/hash, see the memo comment below)
    _ex_rx: ClassVar[Tuple[Any, ...]]
    _match_memo: ClassVar[Dict[Any, Optional[TruncationRule]]]

    def __post_init__(self):
        if isinstance(self.rules, TruncationRule):
            object.__setattr__(self, "rules", (self.rules,))
        object.__setattr__(self, "rules", tuple(self.rules))
        object.__setattr__(self, "excludes", tuple(self.excludes))
        object.__setattr__(
            self, "_ex_rx", tuple(compile_scope(p) for p in self.excludes))
        # per-policy matcher memo: programs repeat (name_stack, prim, dtype)
        # triples heavily (every op of a layer shares a stack), so the
        # precompiled-regex walk runs once per distinct triple, not once
        # per op output. Not a dataclass field: excluded from eq/hash.
        object.__setattr__(self, "_match_memo", {})

    def cache_key(self) -> tuple:
        return (tuple(r.cache_key() for r in self.rules), self.excludes)

    def rule_for(self, name_stack: str, prim_name: str, out_dtype
                 ) -> Optional[TruncationRule]:
        key = (name_stack, prim_name, out_dtype)
        hit = self._match_memo.get(key, _MEMO_MISS)
        if hit is not _MEMO_MISS:
            return hit
        global MATCHER_EVALS
        MATCHER_EVALS += 1
        rule = self._rule_for_uncached(name_stack, prim_name, out_dtype)
        self._match_memo[key] = rule
        return rule

    def _rule_for_uncached(self, name_stack: str, prim_name: str, out_dtype
                           ) -> Optional[TruncationRule]:
        name_stack = normalize_stack(name_stack)
        for rx in self._ex_rx:
            if scope_matches(rx, name_stack):
                return None
        for rule in self.rules:
            if rule.matches(name_stack, prim_name, out_dtype):
                return rule
        return None

    def excluding(self, *scopes: str) -> "TruncationPolicy":
        return dataclasses.replace(self, excludes=self.excludes + tuple(scopes))

    # ---- lossless JSON round trip -----------------------------------------
    def to_json(self) -> dict:
        """Serialize the full rule list + excludes. Raises
        :class:`NotSerializableError` for mask-bearing rules (see
        :meth:`TruncationRule.to_json`)."""
        return {"rules": [r.to_json() for r in self.rules],
                "excludes": list(self.excludes)}

    @staticmethod
    def from_json(data: dict) -> "TruncationPolicy":
        return TruncationPolicy(
            rules=tuple(TruncationRule.from_json(r) for r in data["rules"]),
            excludes=tuple(data.get("excludes", ())))

    # ---- constructors -----------------------------------------------------
    @staticmethod
    def everywhere(fmt, **kw) -> "TruncationPolicy":
        """Program-scope truncation (RAPTOR --raptor-truncate-all)."""
        return TruncationPolicy(rules=(TruncationRule(fmt=fmt, **kw),))

    @staticmethod
    def scoped(scope: str, fmt, **kw) -> "TruncationPolicy":
        return TruncationPolicy(rules=(TruncationRule(fmt=fmt, scope=scope, **kw),))

    @staticmethod
    def from_flag(flag: str) -> "TruncationPolicy":
        """Parse RAPTOR's flag syntax, e.g. ``"64_to_5_14;32_to_3_8"``."""
        rules = []
        for part in flag.split(";"):
            part = part.strip()
            if not part:
                continue
            width, _, em = part.partition("_to_")
            e, m = em.split("_")
            rules.append(TruncationRule(
                fmt=FPFormat(int(e), int(m)), from_width=int(width)))
        return TruncationPolicy(rules=tuple(rules))


def parse_policy(spec) -> Optional["TruncationPolicy"]:
    """Parse a CLI policy spec into a :class:`TruncationPolicy`.

    The one flag grammar shared by every launch entrypoint (train, serve):
      * ``None`` / ``""``          -> ``None`` (no truncation)
      * ``"scope:**/mlp=e5m7"``    -> scoped single-rule policy
      * ``"64_to_5_14;32_to_3_8"`` -> RAPTOR width-conditional rules
    Already-constructed policies pass through unchanged.
    """
    if not spec:
        return None
    if isinstance(spec, TruncationPolicy):
        return spec
    if spec.startswith("scope:"):
        scope, fmt = spec[len("scope:"):].split("=")
        return TruncationPolicy.scoped(scope, fmt)
    return TruncationPolicy.from_flag(spec)


# --------------------------------------------------------------------------
# shared policy resolution — the one profile→policy→deploy entrypoint
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """What :func:`resolve_policy` hands every consumer: the runnable policy,
    plus the deployed artifact (and its registry ref) when one was named —
    serving threads the artifact through to provenance logging, the trainer
    records its ref in checkpoint manifests."""

    policy: Optional[TruncationPolicy] = None
    artifact: Optional[object] = None      # a PolicyArtifact
    ref: Optional[object] = None           # an ArtifactRef


def _looks_like_ref(spec: str) -> bool:
    """Registry refs (``"name"`` / ``"name@v3"``) vs flag grammar: every flag
    spelling carries ``scope:``, ``_to_`` or ``=``; a bare identifier is a
    registry name."""
    return (not spec.startswith("scope:") and "_to_" not in spec
            and "=" not in spec)


def resolve_policy(spec=None, artifact_ref=None, *,
                   registry=None) -> ResolvedPolicy:
    """Resolve *anything callers deploy a policy as* into one shape.

    ``spec`` accepts a :class:`TruncationPolicy`, a policy artifact (any
    object with a ``policy`` attribute) or a flag string
    (``"scope:**/mlp=e5m7"`` / ``"64_to_5_14"``). Registry refs
    (``"bench_model"`` / ``"bench_model@v3"``, or ``artifact_ref=``) need the
    artifact registry, which is not ported yet: they raise
    ``NotImplementedError`` instead of resolving to something else.
    """
    if isinstance(spec, str) and not spec:
        spec = None
    if spec is not None and artifact_ref:
        raise ValueError("--policy and --policy-artifact are exclusive")
    if spec is None and not artifact_ref:
        return ResolvedPolicy()

    if spec is not None and not isinstance(spec, str):
        if isinstance(spec, TruncationPolicy):
            return ResolvedPolicy(policy=spec)
        policy = getattr(spec, "policy", None)
        if policy is not None:  # a PolicyArtifact (duck-typed: no import)
            return ResolvedPolicy(policy=policy, artifact=spec)
        raise TypeError(f"cannot resolve a policy from {type(spec).__name__}")

    if isinstance(spec, str) and not _looks_like_ref(spec):
        return ResolvedPolicy(policy=parse_policy(spec))

    ref = artifact_ref or spec
    if not ref:
        return ResolvedPolicy()
    raise NotImplementedError(
        f"policy ref {ref!r}: the artifact registry is not ported yet; pass "
        "a TruncationPolicy, a flag string, or TruncationPolicy.from_json "
        "of the artifact's 'policy' entry")
