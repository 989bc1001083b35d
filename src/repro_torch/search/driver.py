"""Automated mixed-precision search (the paper's §6.3 loop, closed).

RAPTOR's workflow is manual: truncate a scope, look at the figure of merit,
exclude the scopes that break, re-run. ``autosearch`` automates it on top of
the runtime-parameterized quantize path (``api.truncate_sweep``):

  1. **Enumerate once.** The profiled function's quantize sites (every op
     output a frontier scope matches) are enumerated a single time into one
     ``SweepHandle``; candidate policies are just values of its runtime
     ``(num_sites, 4)`` format table. The whole search runs through that
     one handle and the one dynamic quantizer kernel — no per-candidate
     enumeration, no per-candidate kernel build.
  2. **Scope discovery.** ``scope`` subtrees are enumerated by one counted
     run and cut into a disjoint frontier of regions ordered by FLOPs.
  3. **Per-scope ladder probe.** For each region *in isolation*, the whole
     mantissa-width ladder is evaluated in one dispatch and the narrowest
     format whose error metric stays under the threshold is assigned — the
     region's measured sensitivity, the quantitative form of the paper's
     per-module truncation experiments. With ``warm_start`` hints the
     exhaustive ladder is replaced by a hint-seeded bisection of each
     scope's pass/fail boundary, batched across scopes per round.
  4. **Greedy-exclusion refinement.** If the joint policy misses the
     threshold, every single-scope exclusion candidate is evaluated (again
     through the same handle) and the most error-reducing one is excluded;
     repeat until the metric fits or the budget runs out.

Every candidate evaluation is counted against ``budget``; the search
degrades gracefully — regions it never reached simply stay full precision.

**Dispatches.** The reference package evaluates a dispatch's candidates as
one ``vmap`` over a ``(K, num_sites, 4)`` table stack padded with identity
rows to a fixed width K. Eagerly, each row is a full evaluation of the
program, so the port evaluates only a dispatch's real rows, one after the
other, and never the padding. The chunking is the reference's, so
``n_dispatches``, ``probe_batch`` and ``max_dispatch_rows`` are the same
numbers, and the first dispatch carries the identity row whose outputs are
the reference outputs. On the card a dispatch's tables go up in one
asynchronous copy, its rows run with any host synchronisation an error
(``torch.cuda.set_sync_debug_mode``), and its outputs come down to numpy
for the metric after one synchronisation.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core.formats import FPFormat
from repro_torch.core.policy import TruncationPolicy, TruncationRule
from repro_torch.search import metrics as _metrics
from repro_torch.search.scopes import ScopeInfo, discover_scopes

# mantissa-width ladder, finest first; 23 at e8 is fp32 = identity
DEFAULT_WIDTHS: Tuple[int, ...] = (23, 15, 10, 7, 5, 3, 2)

_UNHINTED = object()


def _frontier_hints(warm_start, scopes) -> Dict[str, Optional[int]]:
    """Project user/profile warm-start hints onto the search frontier.

    Hint keys are scope paths (site scopes, or coarser user-written
    prefixes); a frontier scope collects every hint at, below, or above it
    in the scope tree. Conflicts resolve conservatively: a pinned-high
    (``None``) hint dominates, otherwise the FINEST predicted width wins (a
    too-coarse prediction can only skip probes a sibling site needs)."""
    if warm_start is None:
        return {}
    if not hasattr(warm_start, "items"):
        raise TypeError(
            "warm_start must be a mapping of scope path -> predicted "
            "mantissa width (None = pin to full precision); trajectory "
            "reports lowered by ladder_hints (ROADMAP Queue A item 4) and "
            "policy artifacts (item 6) are not ported yet, "
            f"got {type(warm_start).__name__}")
    out: Dict[str, Optional[int]] = {}
    for si in scopes:
        applicable = [
            pred for path, pred in warm_start.items()
            if path == si.path or path.startswith(si.path + "/")
            or si.path.startswith(path + "/")]
        if not applicable:
            continue
        if any(p is None for p in applicable):
            out[si.path] = None
        else:
            out[si.path] = max(int(p) for p in applicable)
    return out


@dataclasses.dataclass
class ScopeAssignment:
    scope: ScopeInfo
    man_bits: int                  # assigned mantissa width
    error_at_accept: float         # metric when this width was accepted
    excluded: bool = False         # knocked back to full by refinement

    def fmt(self, exp_bits: int) -> Optional[FPFormat]:
        """The format this assignment truncates to; None = full precision."""
        if self.excluded or self.man_bits >= 23:
            return None
        return FPFormat(exp_bits, self.man_bits)


@dataclasses.dataclass
class SearchResult:
    """Per-scope format assignment + the audit trail of the search."""

    assignments: Dict[str, ScopeAssignment]
    exp_bits: int
    threshold: float
    budget: int
    evals_used: int
    final_error: float
    converged: bool
    history: List[Tuple[str, float]]  # (event, metric value)
    # distinct (K, num_sites, 4) table-stack signatures the search
    # dispatched — what the reference counts as compilations of its batched
    # executable; K is fixed, so 1 whenever anything was dispatched
    n_compiles: int = 0
    n_sites: int = 0                  # runtime-table rows (quantize sites)
    n_dispatches: int = 0             # dispatches of candidate rows
    n_warm_hints: int = 0             # frontier scopes with a warm-start hint
    probe_batch: int = 0              # K: table rows per dispatch (padded)
    max_dispatch_rows: int = 0        # most REAL rows (ref + candidates)
                                      # any single dispatch carried —
                                      # identity padding never counted
    n_devices: int = 1                # probe-axis shards (1 = unsharded)
    # static-analysis pruning is not ported yet: always None / 0
    static_verdicts: Optional[Dict[str, Dict[str, str]]] = None
    n_pruned: int = 0
    # enumerations of the search's one sweep handle (1 whenever anything
    # was searched; 0 when nothing was)
    n_traces: int = 0

    @property
    def probes_per_dispatch_per_device(self) -> float:
        """Real rows (reference + candidates) of the busiest dispatch per
        probe-axis shard."""
        if self.n_devices <= 0:
            return 0.0
        return self.max_dispatch_rows / self.n_devices

    def policy(self) -> TruncationPolicy:
        rules = tuple(
            TruncationRule(fmt=a.fmt(self.exp_bits), scope=path)
            for path, a in self.assignments.items()
            if a.fmt(self.exp_bits) is not None)
        return TruncationPolicy(rules=rules)

    def hints(self) -> Dict[str, Optional[int]]:
        """This search's verdicts as warm-start hints for a later
        ``autosearch(warm_start=...)``: truncated scopes predict their
        assigned width; excluded or full-precision scopes pin high
        (``None``), seeding the next bisection at the finest rung."""
        return {path: (None if a.excluded or a.man_bits >= 23
                       else a.man_bits)
                for path, a in self.assignments.items()}

    def to_artifact(self, name: str, *, hints=None, oracle=None,
                    bench=None):
        """Package the search into a versioned policy artifact."""
        raise NotImplementedError(
            "SearchResult.to_artifact needs policy artifacts "
            "(ROADMAP Queue A item 6: artifacts), which are not ported yet")

    def table(self) -> str:
        """Per-scope format table — the textual analogue of the paper's
        per-region heatmap."""
        lines = [f"  {'scope':<32} {'flops%':>7} {'format':>8} "
                 f"{'err@accept':>11}  status"]
        for path, a in self.assignments.items():
            fmt = a.fmt(self.exp_bits)
            status = ("excluded" if a.excluded
                      else ("full" if fmt is None else "truncated"))
            lines.append(
                f"  {path:<32} {a.scope.fraction * 100:>6.1f}% "
                f"{(fmt.key if fmt else 'fp32'):>8} "
                f"{a.error_at_accept:>11.3e}  {status}")
        lines.append(
            f"  -- metric {self.final_error:.3e} (threshold "
            f"{self.threshold:.1e}) in {self.evals_used}/{self.budget} evals; "
            f"{'converged' if self.converged else 'NOT converged'}")
        return "\n".join(lines)


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On the card, any host synchronisation inside is an error."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _upload(stacked: np.ndarray, device: torch.device) -> torch.Tensor:
    """A dispatch's tables on the program's device; on the card one
    asynchronous copy from pinned memory (no host synchronisation)."""
    t = torch.from_numpy(stacked)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(outs: list, device: torch.device) -> list:
    """Each row's outputs as a numpy pytree; on the card every leaf goes to
    pinned memory asynchronously, then one synchronisation for all."""
    if device.type != "cuda":
        return [_metrics.tree_map(_metrics.host_array, o) for o in outs]

    def stage(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return h.copy_(x, non_blocking=True)

    staged = [_metrics.tree_map(stage, o) for o in outs]
    torch.cuda.current_stream(device).synchronize()
    return [_metrics.tree_map(_metrics.host_array, s) for s in staged]


def autosearch(fn: Callable, args: Sequence = (),
               metric: _metrics.MetricSpec = None, budget: int = 64, *,
               kwargs: Optional[dict] = None, threshold: float = 1e-3,
               widths: Sequence[int] = DEFAULT_WIDTHS, exp_bits: int = 8,
               scopes: Optional[Sequence[ScopeInfo]] = None,
               min_fraction: float = 0.01, max_scopes: Optional[int] = None,
               memflag_threshold: Optional[float] = None,
               impl: str = "auto", refine: bool = True,
               warm_start: Optional[Dict[str, Optional[int]]] = None,
               static_prune: object = False,
               mesh=None, batch_axis: str = "probe", in_shardings=None,
               verbose: bool = False) -> SearchResult:
    """Search a per-scope mixed-precision assignment for ``fn(*args)``.

    Returns a :class:`SearchResult`; ``result.policy()`` is directly usable
    with ``api.truncate``. ``metric`` is resolved via
    ``metrics.resolve_metric``: ``None`` (max relative output deviation),
    a registered name (``"max_rel"``, ``"mean_rel"``, ``"rel_l2"``,
    ``"loss"``), or any ``metric(ref_out, cand_out) -> float`` callable over
    numpy pytrees — e.g. a mini-app's solver-level ``error_metric`` over
    observables. ``budget`` caps the total number of candidate evaluations.
    The search runs on the device of its inputs: every candidate goes
    through one ``truncate_sweep`` handle (one enumeration, a new table per
    candidate), so no candidate enumerates sites or builds a kernel again.

    ``warm_start`` maps scope paths to a predicted mantissa width (``None``
    = predicted inadmissible at every candidate width, i.e. pinned to full
    precision). Hints reshape the *probe schedule*: instead of exhaustively
    probing every ladder rung per scope, each scope binary-searches the
    pass/fail boundary of its solo ladder, seeded at the hinted width, and
    every round batches all unresolved scopes into shared dispatches. The
    bisection trusts that a scope's solo error is monotone in mantissa width;
    a non-monotone ladder can make the guided pick differ (it is still a
    measured-admissible width, never an unvalidated one).

    Not ported yet, and raising ``NotImplementedError``: ``static_prune``
    (the static analysis, ROADMAP Queue A item 10) and ``mesh`` /
    ``in_shardings`` (distribution, item 11). ``memflag_threshold`` is
    accepted for signature parity and unused, as in the reference.
    """
    del memflag_threshold, batch_axis  # legacy knob; one device, no axis
    if static_prune is not False and static_prune is not None:
        raise NotImplementedError(
            "autosearch(static_prune=...) needs the static analysis "
            "(ROADMAP Queue A item 10), which is not ported yet")
    if mesh is not None or in_shardings is not None:
        raise NotImplementedError(
            "autosearch(mesh=..., in_shardings=...) needs distribution "
            "(ROADMAP Queue A item 11), which is not ported yet")
    metric = _metrics.resolve_metric(metric)
    kwargs = dict(kwargs or {})
    # index 0 of the ladder must always be full precision: scopes the search
    # never validates (budget exhaustion, all-rejected probes) are assigned
    # widths[0] with error 0.0, which is only honest for identity.
    widths = tuple(sorted({int(w) for w in widths}, reverse=True))
    if not widths or widths[0] < 23:
        widths = (23,) + widths

    evals = 0
    history: List[Tuple[str, float]] = []
    dispatches = 0
    max_rows = 0
    n_traces = 0

    def log(msg: str) -> None:
        if verbose:
            print(f"[autosearch] {msg}", flush=True)

    if scopes is None:
        scopes = discover_scopes(fn, tuple(args), kwargs,
                                 min_fraction=min_fraction,
                                 max_scopes=max_scopes)
    scopes = list(scopes)

    hints = _frontier_hints(warm_start, scopes)

    def result(assignments, final_err):
        return SearchResult(
            assignments=assignments, exp_bits=exp_bits, threshold=threshold,
            budget=budget, evals_used=evals, final_error=final_err,
            converged=final_err <= threshold, history=history,
            n_compiles=min(dispatches, 1), n_sites=n_sites,
            n_dispatches=dispatches,
            n_warm_hints=len(hints), probe_batch=K,
            max_dispatch_rows=max_rows, n_devices=1, n_traces=n_traces)

    cand_widths = [w for w in widths if w < 23]
    n_sites = 0
    K = 0
    if not scopes or not cand_widths or budget < 2:
        # nothing searchable (or budget can't cover one probe + the joint
        # check): everything stays full precision, which is trivially exact
        assignments = {s.path: ScopeAssignment(s, widths[0], 0.0)
                       for s in scopes}
        history.append(("joint", 0.0))
        return result(assignments, 0.0)

    # ---- the one enumeration every candidate runs through ------------------
    # The site policy's matched set is the union of all candidate scopes;
    # its format is irrelevant (tables carry the formats at runtime).
    site_policy = TruncationPolicy(rules=tuple(
        TruncationRule(fmt=FPFormat(exp_bits, 0), scope=s.path)
        for s in scopes))
    sweep = api.truncate_sweep(fn, site_policy, impl=impl)
    with torch.no_grad():
        handle = sweep(*args, **kwargs)
    n_traces = sweep.n_traces
    n_sites = handle.num_sites
    device = handle.device
    # fixed batch width: a full per-scope ladder plus the reference row of
    # the very first dispatch. Every dispatch stands for one
    # (K, num_sites, 4) stack, the reference's single compiled signature.
    K = len(cand_widths) + 1
    identity = handle.identity_table()

    ref_host: List[Optional[object]] = [None]  # full-precision outputs (np)

    def dispatch(rows: List[np.ndarray]) -> list:
        """Evaluate the real rows of one dispatch; numpy outputs per row."""
        tables = _upload(np.stack(rows).astype(np.int32), device)
        with torch.no_grad(), _no_host_sync(device):
            outs = [handle(tables[k]) for k in range(len(rows))]
        return _to_host(outs, device)

    def eval_candidates(cands: List[Tuple[str, TruncationPolicy]]
                        ) -> List[float]:
        """Evaluate candidate policies, chunked to the fixed width K;
        returns metric values and charges one budget eval per candidate."""
        nonlocal evals, dispatches, max_rows
        errs: List[float] = []
        pos = 0
        while pos < len(cands) or ref_host[0] is None:
            chunk = []
            rows = []
            if ref_host[0] is None:
                rows.append(identity)
            take = K - len(rows)
            for tag, pol in cands[pos:pos + take]:
                chunk.append(tag)
                rows.append(handle.table(pol))
            pos += len(chunk)
            max_rows = max(max_rows, len(rows))  # real rows, pre-padding
            dispatches += 1
            host = dispatch(rows)
            base = 0
            if ref_host[0] is None:
                ref_host[0] = host[0]
                base = 1
            for j, tag in enumerate(chunk):
                err = metric(ref_host[0], host[base + j])
                history.append((tag, err))
                evals += 1
                errs.append(err)
        return errs

    def policy_of(assign: Dict[str, ScopeAssignment],
                  extra: Optional[Tuple[str, int]] = None,
                  minus: Optional[str] = None) -> TruncationPolicy:
        rules = []
        pending = dict(assign)
        if extra is not None:
            path, m = extra
            pending[path] = ScopeAssignment(
                scope=next(s for s in scopes if s.path == path),
                man_bits=m, error_at_accept=0.0)
        for path, a in pending.items():
            if path == minus:
                continue
            f = a.fmt(exp_bits)
            if f is not None:
                rules.append(TruncationRule(fmt=f, scope=path))
        return TruncationPolicy(rules=tuple(rules))

    # ---- phase 1: solo per-scope ladder probe, widest work first -----------
    # Each candidate truncates ONE region; the narrowest admissible width is
    # that region's measured sensitivity. Composition errors are phase 2's
    # job. One evaluation stays reserved for the joint check so evals_used
    # can never exceed the budget.
    reserve = 1
    assignments: Dict[str, ScopeAssignment] = {}

    def accept(si, w_pick, err_pick):
        assignments[si.path] = ScopeAssignment(si, w_pick, err_pick)
        log(f"{si.path} ({si.fraction * 100:.1f}% flops) -> "
            f"m{w_pick} (err {err_pick:.3e}, {evals} evals)")

    if hints:
        # ---- error-guided warm start (see the warm_start doc above) --------
        # Solo ladder error is monotone in mantissa width for rounding-
        # dominated workloads, so the narrowest admissible width is the
        # boundary of a pass-prefix of the finest-first ladder. Round 1
        # probes every scope's hinted rung plus its next-narrower neighbour
        # (pinned-high scopes seed at the finest rung, so one failing probe
        # confirms "nothing passes"); round 2 probes whatever interval round
        # 1 left undecided. Both rounds pack ALL scopes into shared
        # dispatches.
        nw = len(cand_widths)
        lo = {si.path: -1 for si in scopes}   # largest index known passing
        hi = {si.path: nw for si in scopes}   # smallest index known failing
        err_at: Dict[Tuple[str, int], float] = {}

        def seed(si) -> int:
            pred = hints.get(si.path, _UNHINTED)
            if pred is _UNHINTED:
                return (nw - 1) // 2          # no information: start mid
            if pred is None:
                return 0                       # pinned high: finest rung
            if any(w >= pred for w in cand_widths):
                # narrowest candidate at/above the predicted width
                return max(i for i, w in enumerate(cand_widths) if w >= pred)
            return 0

        def probe_round(plan) -> None:
            batch: List[Tuple[ScopeInfo, int]] = []
            planned = 0
            for si in scopes:
                afford = budget - evals - reserve - planned
                if afford <= 0:
                    break
                idxs = [i for i in plan(si)
                        if lo[si.path] < i < hi[si.path]][:afford]
                planned += len(idxs)
                batch.extend((si, i) for i in idxs)
            if not batch:
                return
            errs = eval_candidates([
                (f"ladder:{si.path}:m{cand_widths[i]}",
                 policy_of({}, (si.path, cand_widths[i])))
                for si, i in batch])
            for (si, i), e in zip(batch, errs):
                err_at[(si.path, i)] = e
                if e <= threshold:
                    lo[si.path] = max(lo[si.path], i)
                else:
                    hi[si.path] = min(hi[si.path], i)

        def seed_plan(si):
            s = seed(si)
            if hints.get(si.path, _UNHINTED) is None:
                return [s]   # pinned high: the failing finest-rung probe
                             # alone confirms "nothing passes"
            return [i for i in (s, s + 1) if i < nw]

        probe_round(seed_plan)
        probe_round(lambda si: range(lo[si.path] + 1, hi[si.path]))
        for si in scopes:
            b = lo[si.path]
            if b >= 0:
                # narrowest width measured admissible (== the full-ladder
                # pick whenever solo error is monotone in width)
                accept(si, cand_widths[b], err_at[(si.path, b)])
            else:
                accept(si, widths[0], 0.0)     # nothing admissible: full
    else:
        for si in scopes:
            afford = budget - evals - reserve
            if afford <= 0:
                assignments[si.path] = ScopeAssignment(si, widths[0], 0.0)
                continue
            # under a tight budget probe the finest widths (most likely to
            # be admissible, so the scope still gets some truncation)
            probe = cand_widths[:afford]
            errs = eval_candidates([
                (f"ladder:{si.path}:m{w}", policy_of({}, (si.path, w)))
                for w in probe])
            passing = [(w, e) for w, e in zip(probe, errs) if e <= threshold]
            if passing:
                accept(si, *min(passing))    # narrowest admissible width
            else:
                assignments[si.path] = ScopeAssignment(si, widths[0], 0.0)

    # ---- phase 2: joint check + greedy-exclusion refinement ----------------
    if policy_of(assignments).rules:
        final_err = eval_candidates([("joint", policy_of(assignments))])[0]
    else:
        final_err = 0.0  # nothing truncated -> trivially exact, no eval owed
        history.append(("joint", 0.0))
    log(f"joint policy err {final_err:.3e}")

    while refine and final_err > threshold and evals < budget:
        live = [p for p, a in assignments.items()
                if not a.excluded and a.fmt(exp_bits) is not None]
        if not live:
            break
        # most fragile first: the scope whose solo error was worst is the
        # likeliest culprit, so it is tried even under a clipped budget
        live.sort(key=lambda p: -assignments[p].error_at_accept)
        live = live[:budget - evals]
        errs = eval_candidates([
            (f"exclude?:{p}", policy_of(assignments, minus=p))
            for p in live])
        best = int(np.argmin(errs))
        victim = live[best]
        assignments[victim].excluded = True
        final_err = errs[best]
        history.append((f"exclude:{victim}", final_err))
        log(f"exclude {victim} (paper §6.3) -> err {final_err:.3e}")

    return result(assignments, final_err)
