"""Continuous-batching serving engine with sampled shadow profiling.

A compact production shape: fixed-size decode batch, slot-based request
table, per-slot position cursors in the cache (``cache["pos"]`` is (B,)),
so a new request prefills into any free slot *while other slots keep
decoding* — no all-slots-free barrier, no equal-prompt-length waves.
Quarantined slots are immediately reusable (admission zeroes exactly that
slot's cache lanes). Every tick is one call of one decode step whose input
signature never changes; :meth:`Engine.assert_zero_recompile` checks that
the step's signature cache stays at one entry.

PyTorch has no executable cache to count. What the step keeps per input
signature is the truncate / memtrace wrapper's (policy decisions, location
table), and a plain step's signatures are counted the same way, so
``cache_sizes()`` reports those; the slot reset is plain tensor code with
nothing kept per signature, reported as ``None``.

**Decode rows.** The decode step runs at ``Engine.rows`` rows, at least
:data:`DECODE_ROWS` whatever the engine's ``batch_size``: rows past the
slots idle as an empty slot does. On the card a matrix product or a
reduction may take another summation order at another row count, so a
batch-1 engine and a 4-slot one would decode one request to other logits;
at one row count every row is computed alike and a request's tokens do not
depend on the engine or the slot that serves it (the reference's isolation
contract). An engine of more than :data:`DECODE_ROWS` slots decodes at a
multiple of it.

Each tick makes one host synchronisation, the read-back of the logits (as
the reference's ``np.asarray(logits)``); the step itself makes none: the
tokens go up through a pinned buffer without a synchronisation, and the
cursors live on the device.

Shadow profiling rides on top: a sampled fraction of requests decode
through the ``memtrace``-shadowed step against the deployed policy (see
:mod:`repro_torch.serving.shadow`) — the served tokens stay bit-identical,
the paired lane feeds per-request and rolling RaptorReports, and drift
against the deployed artifact's accepted error budget pages a re-search
hook.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from collections import deque
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import api
from repro_torch.core.api import truncate
from repro_torch.distributed import sharding as _shd
from repro_torch.core.policy import resolve_policy
from repro_torch.serving.shadow import ShadowConfig, ShadowProfiler

# the decode step's least row count (see the module docstring)
DECODE_ROWS = 8


def decode_rows(batch_size: int) -> int:
    """Rows of the decode step of an engine of ``batch_size`` slots: the
    least multiple of :data:`DECODE_ROWS` that holds them."""
    return -(-max(batch_size, 1) // DECODE_ROWS) * DECODE_ROWS


@dataclasses.dataclass
class Request:
    """The handle :meth:`Engine.submit` returns; fields fill in as the
    request moves through the batch. ``report`` is the merged per-request
    RaptorReport when the request was shadow-sampled."""

    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "ok"              # "ok" | "error_nonfinite"
    error: str = ""
    shadowed: bool = False
    report: Optional[object] = None  # merged RaptorReport (shadowed only)
    _fed: int = 0                    # prompt tokens already fed (prefill cursor)


def _signatures_counted(fn):
    """``fn`` with the truncate wrappers' per-signature bookkeeping, so a
    plain step reports ``cache_size()`` (distinct input signatures seen) like
    a truncated one."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        api._per_signature(wrapped, True, ("plain",), args, kwargs, dict)
        return fn(*args, **kwargs)
    return api._attach_cache(wrapped)


class Engine:
    """``policy`` deploys the engine under a RAPTOR truncation policy —
    anything :func:`repro_torch.core.policy.resolve_policy` accepts: a
    :class:`~repro_torch.core.TruncationPolicy`, a flag string, a
    :class:`~repro_torch.artifacts.PolicyArtifact`, or a registry ref like
    ``"bench_model@v3"``. The decode step is truncated once at
    construction.

    ``shadow`` (a :class:`~repro_torch.serving.shadow.ShadowConfig`) enables
    sampled shadow profiling of live requests; the engine then exposes
    ``serving_report`` (rolling merged RaptorReport), ``drift_events``,
    and threads fired drift detections into ``self.artifact`` provenance.

    The cache lives on the device of ``params``; it and the decode step
    have ``rows`` = :func:`decode_rows` lanes, of which the first
    ``batch_size`` serve requests. On sharded (DTensor) parameters the
    cache is laid out on their mesh (``Model.place_cache``: over
    ``kv_heads``) and a tick's read-back gathers the logits.
    """

    def __init__(self, model, params, batch_size: int = 8,
                 max_seq_len: int = 512, greedy: bool = True, policy=None,
                 shadow: Optional[ShadowConfig] = None, registry=None):
        self.model = model
        self.params = params
        self.B = batch_size
        self.rows = decode_rows(batch_size)
        self.S = max_seq_len
        self.greedy = greedy
        res = resolve_policy(policy, registry=registry)
        self.policy = res.policy
        self.artifact = res.artifact
        leaf = pytree.tree_leaves(params)[0]
        self.device = leaf.device
        self.cache = model.init_cache(self.rows, max_seq_len,
                                      device=self.device)
        if _shd._is_dtensor(leaf):
            self.cache = model.place_cache(self.cache, leaf.device_mesh)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.lengths = np.zeros(batch_size, np.int32)
        raw_step = model.decode_step
        # per-engine wrappers: each keeps its own signature cache
        self._decode = (truncate(raw_step, self.policy)
                        if self.policy is not None
                        else _signatures_counted(raw_step))
        self._shadow: Optional[ShadowProfiler] = None
        if shadow is not None and _shd._is_dtensor(leaf):
            raise NotImplementedError(
                "shadow profiling of a sharded engine: memtrace runs the "
                "global program on gathered parameters; serve it on one "
                "rank")
        if shadow is not None:
            self._shadow = ShadowProfiler(raw_step, self.policy, shadow,
                                          artifact=self.artifact)
        # the tokens of a tick go up through one pinned buffer, copied
        # without a host synchronisation (the previous tick's read-back has
        # finished every copy out of it)
        self._tok_host = torch.zeros(
            (self.rows,), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        self._queue: deque = deque()
        self._done: Dict[int, Request] = {}
        self._finished: deque = deque()
        self._next_rid = 0
        self._tick = 0

    # ---- request management ------------------------------------------------
    def submit(self, prompt=None, _legacy_prompt=None, *,
               max_new_tokens: int = 32, rid: Optional[int] = None
               ) -> Request:
        """Queue a request; returns its :class:`Request` handle. Request ids
        are auto-assigned; passing one explicitly (or the legacy positional
        ``submit(rid, prompt, ...)`` form) still works but is deprecated."""
        if _legacy_prompt is not None:
            # legacy positional form: submit(rid, prompt, max_new_tokens=...)
            warnings.warn(
                "Engine.submit(rid, prompt) is deprecated; call "
                "submit(prompt) and use the returned Request handle "
                "(explicit ids: submit(prompt, rid=...))",
                DeprecationWarning, stacklevel=2)
            rid, prompt = int(prompt), _legacy_prompt
        if rid is None:
            rid = self._next_rid
        prompt = np.asarray(prompt, np.int32)
        # validate at the API boundary: a prompt that can never fit the
        # fixed cache is rejected here, not requests later in admission
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"request {rid}: prompt must be a non-empty 1-D token "
                f"array, got shape {prompt.shape}")
        if prompt.size > self.S - 1:
            raise ValueError(
                f"request {rid}: prompt of {prompt.size} tokens does not "
                f"fit max_seq_len={self.S} (at most {self.S - 1} prompt "
                "tokens leave room to decode at least one token)")
        if max_new_tokens < 1:
            raise ValueError(
                f"request {rid}: max_new_tokens must be >= 1, "
                f"got {max_new_tokens}")
        req = Request(rid, prompt, max_new_tokens)
        if self._shadow is not None:
            req.shadowed = self._shadow.sample()
        self._next_rid = max(self._next_rid, rid + 1)
        self._queue.append(req)
        return req

    @staticmethod
    def _slot_reset(cache, slot: int):
        """Zero exactly one batch lane of every cache leaf, in place (the
        engine owns its cache). Stacked ``layers`` / encdec cross leaves
        carry batch at axis 1, everything else (pos, lead, global,
        recurrent states) at axis 0."""
        for key, sub in cache.items():
            axis = 1 if key in ("layers", "cross_k", "cross_v") else 0
            for t in pytree.tree_leaves(sub):
                if _shd._is_dtensor(t):
                    # the batch axis is whole on every rank: its lane of
                    # the local shard
                    if any(p.is_shard(axis) for p in t.placements):
                        raise NotImplementedError(
                            f"a cache laid out over its batch axis "
                            f"({t.placements}): its lanes are on other "
                            "ranks")
                    t = _shd.local_parts(t)[0]
                t.select(axis, slot).zero_()
        return cache

    def _admit(self):
        """Admit queued requests into free slots — continuously: any free
        (including just-quarantined) slot takes the next request while the
        other slots keep decoding. The slot's cache lanes are zeroed so the
        new request starts from a fresh cursor."""
        free = [s for s in range(self.B) if self.slots[s] is None]
        for s in free:
            if not self._queue:
                break
            req = self._queue.popleft()
            self.cache = self._slot_reset(self.cache, s)
            self.slots[s] = req
            self.lengths[s] = 0
            req._fed = 0

    def _finish(self, slot: int, req: Request):
        req.done = True
        self._done[req.rid] = req
        self._finished.append(req)
        self.slots[slot] = None
        self.lengths[slot] = 0

    def _tokens(self, tok: np.ndarray) -> torch.Tensor:
        if self.device.type == "cpu":
            return torch.from_numpy(tok)
        self._tok_host.copy_(torch.from_numpy(tok))
        return self._tok_host.to(self.device, non_blocking=True)

    # ---- decode loop -------------------------------------------------------
    def step(self) -> bool:
        """One tick: admit into free slots, then one token of work for every
        live slot — prompt tokens for slots still prefilling, the previous
        output token for decoding slots — through a single batched decode
        call. A slot emits its next output token on the tick that feeds its
        final prompt token (masked prefill and decode interleave freely)."""
        self._admit()
        live = [s for s in range(self.B) if self.slots[s] is not None]
        if not live:
            return False
        tok = np.zeros((self.rows,), np.int32)
        emitting = []
        for s in live:
            req = self.slots[s]
            if req._fed < len(req.prompt):
                tok[s] = req.prompt[req._fed]
                if req._fed == len(req.prompt) - 1:
                    emitting.append(s)
            else:
                tok[s] = req.out_tokens[-1]
                emitting.append(s)
        tokens = self._tokens(tok)

        shadow_live = [s for s in live if self.slots[s].shadowed]
        if self._shadow is not None and shadow_live:
            logits, self.cache, report = self._shadow.step(
                self.params, self.cache, tokens)
            self._shadow.observe(report,
                                 [self.slots[s] for s in shadow_live],
                                 self._tick)
            event = self._shadow.check(self._tick)
            if event is not None and self.artifact is not None:
                self.artifact = self._shadow.log.attach(self.artifact)
        else:
            logits, self.cache = self._decode(self.params, self.cache,
                                              tokens)
        self.assert_zero_recompile()

        for s in live:
            req = self.slots[s]
            if req._fed < len(req.prompt):
                req._fed += 1
            self.lengths[s] += 1

        # the tick's host sync (gathering sharded logits first)
        logits_np = _shd.gather(logits).float().cpu().numpy()
        nxt = np.argmax(logits_np, axis=-1)
        # quarantine non-finite decode: a slot whose logits went NaN/Inf
        # fails THAT request with a clear status and frees the slot for the
        # next admission, instead of emitting argmax-of-NaN token 0
        finite = np.isfinite(logits_np).all(axis=-1)
        for s in emitting:
            req = self.slots[s]
            if not finite[s]:
                req.status = "error_nonfinite"
                req.error = (f"non-finite logits while decoding token "
                             f"{len(req.out_tokens) + 1} (slot {s}); "
                             "request quarantined")
                self._finish(s, req)
                continue
            req.out_tokens.append(int(nxt[s]))
            if (len(req.out_tokens) >= req.max_new_tokens
                    or self.lengths[s] >= self.S - 1):
                self._finish(s, req)
        self._tick += 1
        return True

    @property
    def ticks(self) -> int:
        """Decode ticks run so far."""
        return self._tick

    def run(self) -> Dict[int, Request]:
        while self._queue or any(s is not None for s in self.slots):
            self.step()
        return self._done

    def stream(self) -> Iterator[Request]:
        """Yield requests as they finish (completion order), instead of
        polling :meth:`run`'s dict."""
        while self._queue or any(s is not None for s in self.slots):
            self.step()
            while self._finished:
                yield self._finished.popleft()

    # ---- zero-recompile discipline ----------------------------------------
    def cache_sizes(self) -> Dict[str, Optional[int]]:
        """Entries of each serving path's per-signature cache (None before
        first use, and for the slot reset, which keeps none)."""
        def size(fn):
            n = int(fn.cache_size())
            return n if n else None
        out = {"decode": size(self._decode), "reset": None}
        if self._shadow is not None:
            n = self._shadow.cache_size()
            out["shadow"] = n if n else None
        return out

    def assert_zero_recompile(self):
        """The serving invariant: every serving path saw exactly one input
        signature. Per-slot cursors keep the decode signature static across
        ragged admission, so any growth here is a bug."""
        for name, n in self.cache_sizes().items():
            if n is not None and n > 1:
                raise AssertionError(
                    f"serving {name} step retraced: {n} signature cache "
                    "entries (expected 1) — the decode signature must not "
                    "depend on admission state")

    # ---- shadow-profiling surface ------------------------------------------
    @property
    def serving_report(self):
        """Rolling serving-side RaptorReport merged over every shadowed
        tick (None when shadow profiling is off / nothing sampled yet)."""
        return None if self._shadow is None else self._shadow.report

    @property
    def drift_events(self):
        return [] if self._shadow is None else list(self._shadow.events)

    @property
    def guardrail_log(self):
        return None if self._shadow is None else self._shadow.log
