"""Chaos acceptance tier of the port (@chaos, excluded from tier-1), the
twin of ``tests/test_chaos.py``: inject overflow faults at the top blamed
sites of a live run and hold the guardrail loop end to end --

  * the unguarded run diverges (non-finite or >10x loss),
  * the guarded run detects the fault, escalates the blamed sites in the
    runtime table (one enumeration, ``n_traces`` 1), rolls back to the last
    durable checkpoint, and lands within 10% of the fault-free final loss,
  * every intervention is recorded in a GuardrailLog that round-trips
    through the deployed PolicyArtifact's provenance.

The model is the reference benchmark's ``bench_model`` configuration built
from the port's own ``ArchConfig`` (4 layers, d_model 128, vocab 512), with
the reference test's parameters (``Model.init(PRNGKey(0))`` of the JAX
package, carried over by ``params_from_jax``) and its batch, so both tiers
run one experiment. Every run dumps its GuardrailLog into
$RAPTOR_ARTIFACTS_DIR (default ``chaos-artifacts/``).

    PYTHONPATH=src python -m pytest -m chaos tests/test_torch_chaos.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.apps import get_app
from repro_torch.artifacts import load_artifact_file
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.guardrails import (
    FaultPlan, FaultSpec, GuardedTrainer, GuardrailConfig, GuardrailLog,
    make_guarded_app_loop, sites_for_scope,
)
from repro_torch.guardrails.monitor import probe_blame
from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import (
    TrainConfig, init_opt_state, make_hotswap_train_step,
)

pytestmark = pytest.mark.chaos

REPO = os.path.join(os.path.dirname(__file__), "..")
# 30 steps keeps the comparison in the smooth-descent region of the bench
# loss curve (lr 1e-2, one fixed batch)
N_STEPS, FAULT_STEP = 30, 12
BENCH = dict(name="bench", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, d_ff=512, vocab=512, dtype="float32",
             remat=False)


def _dump_log(name: str, log: GuardrailLog) -> str:
    out = os.environ.get("RAPTOR_ARTIFACTS_DIR", "chaos-artifacts")
    path = os.path.join(out, f"torch_{name}.json")
    log.save(path)
    return path


def _bench():
    import jax
    from repro.configs.base import ArchConfig as JArchConfig
    from repro.models import Model as JModel
    cfg = ArchConfig(**BENCH)
    model = Model(cfg)
    jparams = JModel(JArchConfig(**BENCH, scan_layers=False)).init(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (8, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    return cfg, model, params, batch


def _top_blamed_sites(blame, site_index, top_k=2):
    """Top-``top_k`` blamed scopes -> their table rows, worst first."""
    sites, scopes = [], []
    for b in blame:
        if not b.scope:
            continue
        rows = sites_for_scope(site_index, b.scope)
        if rows:
            scopes.append(b.scope)
            sites.extend(r for r in rows if r not in sites)
        if len(scopes) >= top_k:
            break
    return sites, scopes


def test_bench_model_overflow_fault_guarded_recovery(tmp_path):
    cfg, model, params, batch = _bench()
    art = load_artifact_file(
        os.path.join(REPO, "artifacts", "bench_model.json"))
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-2), policy=art.policy)

    # ---- the blame ranking picks the fault targets -----------------------
    blame, _peak = probe_blame(model.loss, art.policy, (params, batch),
                               threshold=1e-4, n_steps=3)
    step_fn, sites = make_hotswap_train_step(model, tc, art.policy,
                                             params, batch)
    fault_sites, fault_scopes = _top_blamed_sites(blame, sites)
    assert fault_sites, f"blame ranking found no faultable sites: {blame}"

    def plan():
        return FaultPlan([FaultSpec(site=s, step=FAULT_STEP, kind="overflow")
                          for s in fault_sites])

    # ---- unguarded: the same step, faults applied, nobody watching -------
    p, o = params, init_opt_state(model, params, tc, device="cpu")
    table = sites.table_for(art.policy)
    fp = plan()
    unguarded_loss = None
    for step in range(N_STEPS):
        table, _ = fp.apply(table, step)
        p, o, m = step_fn(p, o, batch, step, step_fn.device_table(table))
        unguarded_loss = float(m["loss"])
        if not np.isfinite(unguarded_loss):
            break

    # ---- guarded: the fault-free reference run, then the faulted one ----
    def run(fault_plan, ckdir):
        ck = Checkpointer(str(ckdir), async_save=False)
        gt = GuardedTrainer(model, tc, art, params, lambda step: batch,
                            checkpointer=ck,
                            cfg=GuardrailConfig(save_every=5),
                            fault_plan=fault_plan)
        return gt.run(N_STEPS), gt

    r0, _ = run(None, tmp_path / "ff")
    rg, gt = run(plan(), tmp_path / "guarded")
    _dump_log("bench_model_fault_free", r0.log)
    _dump_log("bench_model_guarded", rg.log)

    diverged = (not np.isfinite(unguarded_loss)
                or unguarded_loss > 10 * abs(r0.final_loss))
    assert diverged, (f"unguarded run did not diverge (loss "
                      f"{unguarded_loss} vs fault-free {r0.final_loss}) -- "
                      f"faulted sites {fault_sites} ({fault_scopes})")
    assert np.isfinite(rg.final_loss)
    assert abs(rg.final_loss - r0.final_loss) <= 0.10 * abs(r0.final_loss), \
        (rg.final_loss, r0.final_loss)
    assert gt.cache_size() == 1               # table-only escalation
    kinds = rg.log.kinds()
    assert kinds["fault_injected"] == len(fault_sites)
    assert kinds.get("alarm", 0) >= 1
    assert kinds.get("escalate_sites", 0) >= 1
    assert rg.rollbacks >= 1 and kinds.get("rollback", 0) == rg.rollbacks
    audited = rg.log.attach(art)
    assert GuardrailLog.from_artifact(audited).to_json() == rg.log.to_json()
    for s in fault_sites:
        assert np.array_equal(rg.table[s], IDENTITY_ROW)


def test_sod_app_overflow_fault_guarded_recovery(tmp_path):
    app = get_app("sod", n_cells=32, t_end=0.2)     # 32 solver steps
    policy = app.uniform_policy("e8m5")

    # blame the app's own trajectory profile to pick the fault targets
    _obs, traj = app.profile_trajectory(app.init_state(device="cpu"),
                                        policy=policy, threshold=1e-6)
    blame = traj.blame(1e-6)

    def build(fault_plan, ckdir):
        ck = Checkpointer(str(ckdir), async_save=False)
        return make_guarded_app_loop(
            app, policy, checkpointer=ck, fault_plan=fault_plan,
            cfg=GuardrailConfig(save_every=5, warmup=4, window=8),
            device="cpu")

    loop0, sweep = build(None, tmp_path / "ff")
    handle0 = sweep(app.init_state(device="cpu"))
    fault_sites, fault_scopes = _top_blamed_sites(blame, handle0)
    if not fault_sites:          # blame may rank harness-only scopes
        fault_sites = [0, 1]

    def plan():
        return FaultPlan([FaultSpec(site=s, step=10, kind="overflow")
                          for s in fault_sites])

    # unguarded: drive the same sweep with the faulted table
    table = np.asarray(handle0.table(policy), np.int32)
    fp = plan()
    state = app.init_state(device="cpu")
    for step in range(app.n_steps):
        table, _ = fp.apply(table, step)
        state = sweep(state)(table)
    unguarded_sig = max(float(leaf.abs().max())
                        for leaf in torch.utils._pytree.tree_leaves(state))
    assert not np.isfinite(unguarded_sig), \
        f"unguarded sod run stayed finite under faults at {fault_sites}"

    res0 = loop0.run(app.n_steps)
    loopg, _ = build(plan(), tmp_path / "guarded")
    resg = loopg.run(app.n_steps)
    _dump_log("sod_fault_free", res0.log)
    _dump_log("sod_guarded", resg.log)

    assert np.isfinite(resg.final_loss)
    err = app.error_metric(app.observables(res0.state),
                           app.observables(resg.state))
    assert err <= 0.10, f"guarded sod deviates {err:.3g} from fault-free"
    kinds = resg.log.kinds()
    assert kinds["fault_injected"] == len(fault_sites)
    assert kinds.get("rollback", 0) >= 1
    for s in fault_sites:
        assert np.array_equal(resg.table[s], IDENTITY_ROW)
