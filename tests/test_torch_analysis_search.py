"""``autosearch(static_prune=...)`` of the port against the reference's
(the search cases of ``tests/test_analysis.py``): on Sod in bf16 the
pruned search returns the unpruned one's assignments and ``final_error``
bit for bit, with the reference's pruned ``evals_used``, ``n_dispatches``
and verdicts (19 -> 9 evaluations, 4 -> 2 dispatches), warm-started too,
and with explicit calibration (an ``AbsVal`` or an array per tensor
input). The reference's slow cases (heat, Poisson) stay slow."""
import functools

import jax.numpy as jnp
import pytest
import torch

import repro_torch.analysis as ta

from test_torch_analysis import tensor_leaves


# --------------------------------------------------------------------------
# autosearch static pruning: bit-identical, strictly cheaper
# --------------------------------------------------------------------------

def _table(result):
    return {p: (a.man_bits, a.excluded)
            for p, a in result.assignments.items()}


@functools.lru_cache(maxsize=None)
def _ref_sod_searches():
    from repro.apps import get_app as jget_app
    from repro.search import driver as jdriver
    app = jget_app("sod")
    state = app.init_state(jnp.bfloat16)

    def run(**kw):
        return jdriver.autosearch(app.run_observables, (state,),
                                  app.error_metric, 64,
                                  threshold=app.search_threshold, **kw)
    base = run()
    return base, run(static_prune=True)


def _sod():
    from repro_torch.apps import get_app
    app = get_app("sod")
    return app, app.init_state(torch.bfloat16, device="cpu")


def _run(**kw):
    from repro_torch.search import driver
    app, state = _sod()
    return driver.autosearch(app.run_observables, (state,),
                             app.error_metric, 64,
                             threshold=app.search_threshold, **kw)


@functools.lru_cache(maxsize=None)
def _base():
    return _run()


def test_autosearch_static_prune_sod_bf16():
    base, run = _base(), _run
    pruned = run(static_prune=True)
    assert _table(pruned) == _table(base)
    assert pruned.final_error == base.final_error
    assert pruned.evals_used < base.evals_used
    assert pruned.n_dispatches < base.n_dispatches
    assert pruned.n_pruned > 0
    assert base.static_verdicts is None and pruned.static_verdicts
    jbase, jpruned = _ref_sod_searches()
    assert (base.evals_used, base.n_dispatches) == (jbase.evals_used,
                                                    jbase.n_dispatches)
    assert (pruned.evals_used, pruned.n_dispatches, pruned.n_pruned) == (
        jpruned.evals_used, jpruned.n_dispatches, jpruned.n_pruned) == (
        9, 2, 9)
    assert pruned.static_verdicts == jpruned.static_verdicts
    assert _table(pruned) == _table(jpruned)

    art = pruned.to_artifact("sod_static")
    assert art.provenance["static_pruned"] == pruned.n_pruned
    assert art.provenance["static_verdicts"] == pruned.static_verdicts
    assert "static_verdicts" not in base.to_artifact(
        "sod_dynamic").provenance

    # warm-started searches prune too, and stay bit-identical
    warm_base = run(warm_start=base.hints())
    warm_pruned = run(warm_start=base.hints(), static_prune=True)
    assert _table(warm_pruned) == _table(warm_base)
    assert warm_pruned.evals_used < warm_base.evals_used
    assert warm_pruned.n_dispatches < warm_base.n_dispatches


def test_static_prune_explicit_calibration():
    """``static_prune`` takes one range per tensor input instead of
    calibrating from the call's own arguments: an ``AbsVal`` or an array
    (a bfloat16 array abstracts as the top, as in the reference)."""
    app, state = _sod()
    leaves = tensor_leaves(((state,), {}))
    calib = [ta.from_concrete(leaves[0])] + [x.float().numpy()
                                             for x in leaves[1:]]
    base = _base()
    pruned = _run(static_prune=calib)
    assert _table(pruned) == _table(base)
    assert pruned.final_error == base.final_error
    assert pruned.evals_used < base.evals_used


# --------------------------------------------------------------------------
# the reference's slow acceptance cases
# --------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("app_name", ["heat", "poisson"])
def test_autosearch_static_prune_pde_apps_bf16(app_name):
    from repro_torch.apps import get_app
    from repro_torch.search import driver

    app = get_app(app_name)
    state = app.init_state(torch.bfloat16, device="cpu")

    def run(**kw):
        return driver.autosearch(app.run_observables, (state,),
                                 app.error_metric, 64,
                                 threshold=app.search_threshold, **kw)

    base = run()
    pruned = run(static_prune=True)
    assert _table(pruned) == _table(base)
    assert pruned.evals_used < base.evals_used
    assert pruned.n_dispatches < base.n_dispatches
