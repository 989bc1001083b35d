# Automated mixed-precision search over named scopes (paper §6.3 closed
# loop) — scope discovery, mantissa bisection, greedy-exclusion refinement.
from repro_torch.search.driver import (
    autosearch, SearchResult, ScopeAssignment, DEFAULT_WIDTHS,
)
from repro_torch.search.scopes import discover_scopes, scope_tree, ScopeInfo
from repro_torch.search.metrics import (
    rel_error, mean_rel_error, rel_l2_error, loss_degradation,
    default_metric, resolve_metric, from_observables, NAMED_METRICS,
)

__all__ = [
    "autosearch", "SearchResult", "ScopeAssignment", "DEFAULT_WIDTHS",
    "discover_scopes", "scope_tree", "ScopeInfo",
    "rel_error", "mean_rel_error", "rel_l2_error", "loss_degradation",
    "default_metric", "resolve_metric", "from_observables", "NAMED_METRICS",
]
