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
from torch.utils import _pytree as pytree

from repro_torch.core import api
from repro_torch.core.memmode import upload
from repro_torch.core.formats import FPFormat
from repro_torch.core.policy import TruncationPolicy, TruncationRule
from repro_torch.search import metrics as _metrics
from repro_torch.search.scopes import ScopeInfo, discover_scopes

# mantissa-width ladder, finest first; 23 at e8 is fp32 = identity
DEFAULT_WIDTHS: Tuple[int, ...] = (23, 15, 10, 7, 5, 3, 2)

_UNHINTED = object()


def _frontier_hints(warm_start, scopes) -> Dict[str, Optional[int]]:
    """Project user/profile warm-start hints onto the search frontier.

    Hint keys are scope paths (site scopes from ``profile.ladder_hints``,
    or coarser user-written prefixes); a frontier scope collects every hint
    at, below, or above it in the scope tree. Conflicts resolve
    conservatively: a pinned-high (``None``) hint dominates, otherwise the
    FINEST predicted width wins (a too-coarse prediction can only skip
    probes a sibling site needs)."""
    if warm_start is None:
        return {}
    if not hasattr(warm_start, "items") and hasattr(warm_start, "hints"):
        # a PolicyArtifact (or anything carrying persisted hints): the
        # blame-seeded warm start survives the process that computed it
        warm_start = warm_start.hints
    if not hasattr(warm_start, "items"):
        raise TypeError(
            "warm_start must be a mapping of scope path -> predicted "
            "mantissa width (None = pin to full precision), or a "
            "PolicyArtifact carrying such hints; lower a "
            "TrajectoryReport with repro_torch.profile.ladder_hints first, "
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
        """Package the search into a versioned, serializable
        :class:`repro_torch.artifacts.PolicyArtifact`.

        ``hints`` defaults to :meth:`hints` (the measured assignments); pass
        the ``ladder_hints``/``MiniApp.warm_hints`` mapping that seeded this
        search to persist the trajectory-blame predictions instead.
        ``oracle`` takes an ``apps.oracle.OracleVerdict``; ``bench`` a BENCH
        row dict. Raises ``NotSerializableError`` if the policy carries
        mask-fn rules. Every number is made a Python ``int`` / ``float`` /
        ``bool`` first, so the artifact serialises as the reference's does
        (``n_eqns`` counts aten calls as they ran, not traced equations:
        ``search/scopes.py``)."""
        from repro_torch.artifacts import PolicyArtifact, ScopeRow
        rows = {
            path: ScopeRow(
                man_bits=int(a.man_bits),
                error_at_accept=float(a.error_at_accept),
                excluded=bool(a.excluded),
                flops=float(a.scope.flops),
                fraction=float(a.scope.fraction),
                n_eqns=int(a.scope.n_eqns))
            for path, a in self.assignments.items()}
        prov = {
            "threshold": float(self.threshold),
            "budget": int(self.budget),
            "evals_used": int(self.evals_used),
            "final_error": float(self.final_error),
            "converged": bool(self.converged),
            "exp_bits": int(self.exp_bits),
            "n_compiles": int(self.n_compiles),
            "n_sites": int(self.n_sites),
            "n_dispatches": int(self.n_dispatches),
            "n_warm_hints": int(self.n_warm_hints),
            "probe_batch": int(self.probe_batch),
            "max_dispatch_rows": int(self.max_dispatch_rows),
            "n_devices": int(self.n_devices),
            "history": [[tag, float(v)] for tag, v in self.history],
        }
        if self.static_verdicts is not None:
            prov["static_pruned"] = int(self.n_pruned)
            prov["static_verdicts"] = {
                path: dict(rungs)
                for path, rungs in self.static_verdicts.items()}
        use_hints = dict(hints) if hints is not None else self.hints()
        art = PolicyArtifact(name=name, policy=self.policy(),
                             assignments=rows, provenance=prov,
                             hints=use_hints)
        if oracle is not None:
            art = art.with_oracle(oracle)
        if bench is not None:
            art = art.with_bench(bench)
        return art

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
    measured-admissible width, never an unvalidated one). Hints come from
    ``profile.ladder_hints`` / ``MiniApp.warm_hints``, a ``SearchResult``'s
    ``hints()``, or a ``PolicyArtifact``, which may be passed itself.

    ``static_prune`` turns on the abstract-interpretation pre-pass
    (``repro_torch.analysis``): ``True`` calibrates input ranges from the
    concrete tensor leaves of ``args`` / ``kwargs``; a sequence supplies one
    ``analysis.AbsVal`` (or concrete array) per tensor leaf. The analysis is
    one more run of the program, rounding nothing and launching no
    quantizer. Ladder rungs it proves ``EXACT`` (solo run bit-identical to
    the reference, so the probe would measure ``metric(ref, ref)``) or
    ``OVERFLOW_CERTAIN`` (a non-finite provably reaches an output) are
    decided without a dispatch; ``UNKNOWN`` rungs keep dynamic probing.
    Budget accounting mirrors the unpruned schedule, so the assignments
    and ``final_error`` are bit-identical to ``static_prune=False`` with
    fewer ``evals_used`` and dispatches whenever anything was decided (the
    reference's contract, metric assumptions included: a deterministic
    metric of the two observable trees that rejects a non-finite
    candidate). With ``warm_start`` hints the verdicts pre-seed the
    bisection brackets, which requires ``metric(ref, ref) == 0.0`` exactly
    and raises otherwise. Verdicts land in ``SearchResult.static_verdicts``
    and artifact provenance.

    Not ported yet, and raising ``NotImplementedError``: ``mesh`` /
    ``in_shardings`` (distribution, ROADMAP Queue A item 11).
    ``memflag_threshold`` is accepted for signature parity and unused, as
    in the reference.
    """
    del memflag_threshold, batch_axis  # legacy knob; one device, no axis
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
    sv = None      # analysis.StaticVerdicts when static_prune is active
    _V = None      # the Verdict enum, bound alongside sv
    virtual = 0    # unpruned-schedule budget charges (mirrors `evals`)

    def result(assignments, final_err):
        return SearchResult(
            assignments=assignments, exp_bits=exp_bits, threshold=threshold,
            budget=budget, evals_used=evals, final_error=final_err,
            converged=final_err <= threshold, history=history,
            n_compiles=min(dispatches, 1), n_sites=n_sites,
            n_dispatches=dispatches,
            n_warm_hints=len(hints), probe_batch=K,
            max_dispatch_rows=max_rows, n_devices=1, n_traces=n_traces,
            static_verdicts=sv.to_json() if sv is not None else None,
            n_pruned=sv.n_decided if sv is not None else 0)

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

    if static_prune is not False and static_prune is not None:
        from repro_torch.analysis import analyze, scope_rung_verdicts
        from repro_torch.analysis.verdicts import Verdict as _V
        leaves = [x for x in pytree.tree_leaves((tuple(args), kwargs))
                  if isinstance(x, torch.Tensor)]
        calib = leaves if static_prune is True else list(static_prune)
        # the enumeration's grad mode, so the records' keys are its sites'
        with torch.no_grad():
            analysis = analyze(fn, args, kwargs, calib)
        sv = scope_rung_verdicts(analysis, handle.index,
                                 [s.path for s in scopes], cand_widths,
                                 exp_bits)
        log(f"static analysis: {sv.n_decided} rungs decided, "
            f"{analysis.n_widened} sites widened, outputs "
            f"{'finite' if sv.outputs_finite else 'NOT provably finite'}")

    ref_host: List[Optional[object]] = [None]  # full-precision outputs (np)
    self_err: List[Optional[float]] = [None]   # metric(ref, ref), with ref

    def dispatch(rows: List[np.ndarray]) -> list:
        """Evaluate the real rows of one dispatch; numpy outputs per row."""
        # one asynchronous copy of the dispatch's tables
        tables = upload(np.stack(rows).astype(np.int32), device)
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
                if sv is not None:
                    # an EXACT rung's outputs are bit-identical to the
                    # reference's, so the measured metric(ref, ref) is what
                    # its probe would return (not always 0.0: poisson grades
                    # the reference against its own tolerance)
                    self_err[0] = metric(ref_host[0], ref_host[0])
                    if hints and not self_err[0] == 0.0:  # '==' vs NaN too
                        raise ValueError(
                            "static_prune with warm_start requires "
                            "metric(ref, ref) to be exactly 0.0, got "
                            f"{self_err[0]!r}: the warm bisection "
                            "pre-seeds EXACT rungs as passing before the "
                            "reference exists to measure — rerun with "
                            "warm_start=None or static_prune=False")
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

        if sv is not None:
            # EXACT rungs are known passing at exactly 0.0 (checked against
            # the measured metric(ref, ref) at the first dispatch),
            # OVERFLOW_CERTAIN rungs known failing: neither probes
            for si in scopes:
                for i, w in enumerate(cand_widths):
                    v = sv.get(si.path, w)
                    if v == _V.EXACT:
                        err_at[(si.path, i)] = 0.0
                        lo[si.path] = max(lo[si.path], i)
                    elif v == _V.OVERFLOW_CERTAIN:
                        hi[si.path] = min(hi[si.path], i)

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
    elif sv is not None:
        # ---- statically pruned exhaustive ladder ---------------------------
        # Budget windows mirror the unpruned schedule (`virtual` charges
        # what the unpruned search would have), so each scope sees the same
        # probe window and accepts the same width; only UNKNOWN rungs
        # dispatch, all of them through one chunked eval_candidates call.
        plan: List[Tuple[ScopeInfo, Optional[List[int]], List[int]]] = []
        for si in scopes:
            afford = budget - virtual - reserve
            if afford <= 0:
                plan.append((si, None, []))   # window exhausted: full prec
                continue
            probe = cand_widths[:afford]
            virtual += len(probe)
            live = [w for w in probe if sv.get(si.path, w) == _V.UNKNOWN]
            exact = [w for w in probe if sv.get(si.path, w) == _V.EXACT]
            plan.append((si, live, exact))
        flat = [(si, w) for si, live, _ in plan if live for w in live]
        flat_errs = eval_candidates([
            (f"ladder:{si.path}:m{w}", policy_of({}, (si.path, w)))
            for si, w in flat]) if flat else []
        if ref_host[0] is None and any(exact for _, _, exact in plan):
            # every probe was decided, but an EXACT rung needs the measured
            # metric(ref, ref): one dispatch the unpruned search pays too
            eval_candidates([])
        z = self_err[0]
        pos = 0
        for si, live, exact in plan:
            if live is None:
                assignments[si.path] = ScopeAssignment(si, widths[0], 0.0)
                continue
            errs = flat_errs[pos:pos + len(live)]
            pos += len(live)
            passing = ([(w, e) for w, e in zip(live, errs) if e <= threshold]
                       + [(w, z) for w in exact if z <= threshold])
            if passing:
                accept(si, *min(passing))    # narrowest admissible width
            else:
                assignments[si.path] = ScopeAssignment(si, widths[0], 0.0)
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
    if sv is not None and hints:
        # hint probes are not window-mirrored; phase 2 mirrors actual spend
        virtual = evals

    def spent() -> int:
        """Budget consumed for control flow: the unpruned schedule's charges
        when static pruning is on (so windows and loop exits match the
        unpruned search decision for decision), actual evals otherwise."""
        return virtual if sv is not None else evals

    if policy_of(assignments).rules:
        if sv is not None and all(
                sv.get(p, a.man_bits) == _V.EXACT
                for p, a in assignments.items()
                if a.fmt(exp_bits) is not None):
            # every truncated scope sits on an EXACT rung: every quantize of
            # the joint policy is the identity, so the joint run would
            # measure metric(ref, ref), with no dispatch
            if ref_host[0] is None:
                eval_candidates([])
            final_err = self_err[0]
            history.append(("joint", final_err))
        else:
            final_err = eval_candidates([("joint",
                                          policy_of(assignments))])[0]
        virtual += 1
    else:
        final_err = 0.0  # nothing truncated -> trivially exact, no eval owed
        history.append(("joint", 0.0))
    log(f"joint policy err {final_err:.3e}")

    while refine and final_err > threshold and spent() < budget:
        live = [p for p, a in assignments.items()
                if not a.excluded and a.fmt(exp_bits) is not None]
        if not live:
            break
        # most fragile first: the scope whose solo error was worst is the
        # likeliest culprit, so it is tried even under a clipped budget
        live.sort(key=lambda p: -assignments[p].error_at_accept)
        live = live[:budget - spent()]
        if sv is not None:
            virtual += len(live)
            # a scope whose format is universally exact (its grid covers the
            # sites' whole carrier dtype) quantizes nothing even inside a
            # perturbed joint policy: excluding it leaves the joint run as
            # it is, so its trial error IS final_err
            measured = [p for p in live
                        if not sv.is_universal(p, assignments[p].man_bits)]
            m_errs = eval_candidates([
                (f"exclude?:{p}", policy_of(assignments, minus=p))
                for p in measured]) if measured else []
            by_scope = dict(zip(measured, m_errs))
            errs = []
            for p in live:
                if p in by_scope:
                    errs.append(by_scope[p])
                else:
                    errs.append(final_err)
                    history.append((f"exclude?:{p}", final_err))
        else:
            errs = eval_candidates([
                (f"exclude?:{p}", policy_of(assignments, minus=p))
                for p in live])
        best = int(np.argmin(errs))
        victim = live[best]
        assignments[victim].excluded = True
        final_err = errs[best]
        history.append((f"exclude:{victim}", final_err))
        log(f"exclude {victim} (paper §6.3) -> err {final_err:.3e}")

    if sv is not None and ref_host[0] is None:
        # every rung decided, the joint run and every exclusion substituted:
        # the reference is still measured, so the metric contract above is
        # checked before reporting
        eval_candidates([])

    return result(assignments, final_err)
