"""The port's runtime guardrails (``repro_torch.guardrails``) held to the
reference package's: the cases of ``tests/test_guardrails.py`` run in both
packages on the same numpy inputs and compared.

* Fault rows, the quantizer's fault channel, fault plans, the ladder's
  suspects and rungs, and the logs are compared bit for bit (numpy tables,
  ``GuardrailLog.to_json``).
* The monitor's verdicts and the trend filter's fits are host arithmetic
  on the same floats: equal.
* ``GuardedLoop`` on the reference's synthetic step: the same final step,
  loss, rollbacks, table and log.
* ``GuardedTrainer`` on the tiny config, with the same parameters in both
  packages (drawn with numpy): the same log (the fault, the alarm, the
  escalated rows, the rollback, at the same steps) and the final loss at
  ``rtol 1e-3``, the tolerance ``test_torch_trainer.py`` holds longer runs
  to; a fault-free run logs nothing and its losses are bit-equal to the
  unguarded hot-swap step's.
* ``launch.train --guardrails --inject-fault`` on the smoke config.

The engine-quarantine and registry-retry cases of the reference's file are
held by ``test_torch_serving.py`` and ``test_torch_artifacts.py``.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core  # noqa: F401  (anchor the kernels<->core import cycle)
from repro import guardrails as jg
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core.policy import TruncationPolicy as JPolicy
from repro.guardrails.faults import OVERFLOW_ROW as J_OVERFLOW_ROW
from repro.kernels.quantize_em.ops import IDENTITY_ROW as J_IDENTITY_ROW
from repro.kernels.quantize_em.ops import quantize_dynamic as j_quantize
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.profile import fit_log2_trend as j_fit
from repro.train.trainer import TrainConfig as JTrainConfig

from repro_torch import guardrails as tg
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.policy import TruncationPolicy
from repro_torch.guardrails.faults import OVERFLOW_ROW
from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW, quantize_dynamic
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.profile import fit_log2_trend
from repro_torch.train import TrainConfig, init_opt_state, \
    make_hotswap_train_step

from test_torch_trainer import both_params, fixed_batch, models

BOTH = [jg, tg]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _port_quantize(x, row) -> np.ndarray:
    return quantize_dynamic(torch.from_numpy(np.asarray(x, np.float32)),
                            row).numpy()


# ---------------------------------------------------------------------------
# fault rows and the quantizer fault channel
# ---------------------------------------------------------------------------

def test_overflow_row_sends_o1_values_to_inf():
    x = np.asarray([0.1, 0.9, 1.0, 1.5, 3.0, -2.0], np.float32)
    np.testing.assert_array_equal(tg.overflow_row(), jg.overflow_row())
    y = _port_quantize(x, tg.overflow_row())
    assert np.isposinf(y[3]) and np.isposinf(y[4]) and np.isneginf(y[5])
    assert np.isfinite(y[:3]).all()
    want = np.asarray(j_quantize(jnp.asarray(x), jg.overflow_row()))
    np.testing.assert_array_equal(_bits(y), _bits(want))


def test_bitflip_row_armed_channel_flips_exponent_bit():
    row = tg.bitflip_row(IDENTITY_ROW, 30)
    np.testing.assert_array_equal(row, jg.bitflip_row(J_IDENTITY_ROW, 30))
    assert row[0] == IDENTITY_ROW[0] and row[1] == IDENTITY_ROW[1]
    y = _port_quantize([1.0, -1.0], row)
    assert np.isposinf(y[0]) and np.isneginf(y[1])
    x2 = np.random.RandomState(0).randn(64).astype(np.float32)
    for r in (row, tg.bitflip_row(np.array([5, 10, 0, 1], np.int32), 7),
              tg.bitflip_row(np.array([8, 7, 1, 0], np.int32), 31)):
        want = np.asarray(j_quantize(jnp.asarray(x2), r))
        np.testing.assert_array_equal(_bits(_port_quantize(x2, r)),
                                      _bits(want))
    # stripping the channel restores bit-exact identity passthrough
    np.testing.assert_array_equal(
        _bits(_port_quantize(x2, tg.clean_row(row))), _bits(x2))


def test_clean_row_strips_fault_channel_only():
    armed = tg.bitflip_row(np.array([5, 10, 0, 1], np.int32), 7)
    assert armed[3] == 1 | ((7 + 1) << 1)
    np.testing.assert_array_equal(
        armed, jg.bitflip_row(np.array([5, 10, 0, 1], np.int32), 7))
    np.testing.assert_array_equal(tg.clean_row(armed),
                                  np.array([5, 10, 0, 1], np.int32))
    for g in BOTH:
        with pytest.raises(ValueError, match=r"\[0, 62\]"):
            g.bitflip_row(IDENTITY_ROW, 63)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def _plan_trace(g):
    table = np.tile(np.array([8, 10, 0, 1], np.int32), (4, 1))
    plan = g.FaultPlan([g.FaultSpec(site=1, step=5, kind="overflow"),
                        g.FaultSpec(site=2, step=9, kind="bitflip", bit=30)])
    out = []
    t = table
    for step in (0, 5, 10, 11):
        t, fired = plan.apply(t, step)
        out.append((t.copy(), [f.site for f in fired]))
    pending = len(plan.pending())
    plan.reset()
    return out, pending, len(plan.pending()), table


def test_fault_plan_fires_once_and_persists():
    (t0, f0), (t5, f5), (t10, f10), (t11, f11) = _plan_trace(tg)[0]
    assert f0 == [] and f5 == [1] and f10 == [2] and f11 == []
    assert np.array_equal(t5[1], OVERFLOW_ROW)
    assert t10[2][3] == 1 | ((30 + 1) << 1)
    port, ref = _plan_trace(tg), _plan_trace(jg)
    assert port[1:3] == ref[1:3] == (0, 2)
    np.testing.assert_array_equal(port[3], np.tile([8, 10, 0, 1], (4, 1)))
    for (pt, pf), (rt, rf) in zip(port[0], ref[0]):
        np.testing.assert_array_equal(pt, rt)
        assert pf == rf


def test_fault_plan_out_of_range_site_raises():
    for g in BOTH:
        plan = g.FaultPlan([g.FaultSpec(site=7, step=0)])
        with pytest.raises(IndexError, match="site 7 out of range for "
                                             "3-site table"):
            plan.apply(np.tile(IDENTITY_ROW, (3, 1)), 0)


@pytest.mark.parametrize("row", ["e2m1", (3, 2, 1, 0)])
def test_swap_row_fault_accepts_format_spec(row):
    tabs = []
    for g in BOTH:
        plan = g.FaultPlan([g.FaultSpec(site=0, step=0, kind="swap_row",
                                        row=row)])
        t, fired = plan.apply(np.tile(IDENTITY_ROW, (1, 1)), 0)
        assert len(fired) == 1
        tabs.append(t)
    np.testing.assert_array_equal(*tabs)
    if row == "e2m1":
        assert tabs[0][0][0] == 2 and tabs[0][0][1] == 1


# ---------------------------------------------------------------------------
# monitor + trend filter
# ---------------------------------------------------------------------------

def _verdicts(g, losses, **kw):
    m = g.StepMonitor(**kw)
    out = []
    for s, (loss, flag) in enumerate(losses):
        if loss is None:
            m.reset()
            continue
        out.append(m.update(s, loss, nonfinite=flag))
    return [(v.ok, v.reason, v.nonfinite, v.z, v.alarm) for v in out]


def test_step_monitor_nonfinite_alarms_immediately():
    seq = [(float("nan"), False), (1.0, True), (float("inf"), False)]
    got = _verdicts(tg, seq)
    assert [v[4] and v[2] for v in got] == [True, True, True]
    assert got == _verdicts(jg, seq)


def test_step_monitor_spike_and_z_after_warmup():
    kw = dict(warmup=4, z_threshold=6.0, spike_factor=10.0)
    seq = ([(1.0 + 0.01 * s, False) for s in range(4)]
           + [(50.0, False), (1.02, False), (1.3, False), (None, False),
              (50.0, False)])
    got = _verdicts(tg, seq, **kw)
    assert all(v[0] for v in got[:4])
    assert got[4][4] and not got[4][2] and "spike" in got[4][1]
    assert got[5][0]                       # the spike was not admitted
    assert got[6][4] and "z-score" in got[6][1]
    assert got[7][0]                       # a fresh window: re-warming
    assert got == _verdicts(jg, seq, **kw)


def _trend(g):
    f = g.TrendFilter(window=8)
    out = [f.predicted_crossing(1e-2)]
    for s in range(6):
        out.append(f.update(s * 10, 1e-6 * 2 ** (0.1 * s * 10)))
    out += [f.slope(), f.predicted_crossing(1e-2),
            f.predicted_crossing(1e-9)]
    f.reset()
    out.append(f.predicted_crossing(1e-2))
    return out


def test_trend_filter_predicts_budget_crossing():
    got = _trend(tg)
    assert got[0] is None and got[-1] is None
    assert got[7] == pytest.approx(0.1, rel=1e-6)
    exact = (np.log2(1e-2) - np.log2(1e-6 * 2 ** 5.0)) / 0.1
    assert got[8] == int(np.ceil(exact)) and got[9] == 0
    assert got == _trend(jg)


def test_fit_log2_trend_slope_and_level():
    steps = np.arange(5) * 2.0
    cases = [(steps, 1e-3 * 2 ** (0.25 * steps)), ([0.0], [0.5]), ([], []),
             (steps, [1.0, np.nan, 0.0, 4.0, 8.0])]
    for s, v in cases:
        assert fit_log2_trend(s, v) == j_fit(s, v)
    slope, level = fit_log2_trend(*cases[0])
    assert slope == pytest.approx(0.25)
    assert level == pytest.approx(np.log2(1e-3) + 0.25 * 8.0)


# ---------------------------------------------------------------------------
# GuardrailLog
# ---------------------------------------------------------------------------

def test_guardrail_log_round_trip_and_attach(tmp_path):
    from repro.artifacts import PolicyArtifact as JArtifact
    from repro_torch.artifacts import PolicyArtifact
    logs = []
    for g in BOTH:
        log = g.GuardrailLog()
        log.record(3, "fault_injected", site=1, fault="overflow")
        log.record(7, "alarm", reason="spike")
        log.record(7, "escalate_sites", sites=[1], rollback=True)
        log.record(7, "rollback", reason="spike")
        with pytest.raises(ValueError, match="unknown intervention"):
            log.record(8, "made_coffee")
        logs.append(log)
    log = logs[1]
    assert log.to_json() == logs[0].to_json()
    path = str(tmp_path / "glog.json")
    log.save(path)
    assert jg.GuardrailLog.load(path).to_json() == log.to_json()
    assert [iv.step for iv in tg.GuardrailLog.load(path).by_kind(
        "rollback")] == [7]
    audited = log.attach(PolicyArtifact(
        name="t", policy=TruncationPolicy.everywhere("e5m7")))
    want = logs[0].attach(JArtifact(name="t",
                                    policy=JPolicy.everywhere("e5m7")))
    assert audited.dumps() == want.dumps()
    assert tg.GuardrailLog.from_artifact(audited).to_json() == log.to_json()
    assert "rollback=1" in log.summary() == logs[0].summary()


# ---------------------------------------------------------------------------
# EscalationLadder
# ---------------------------------------------------------------------------

class _FakeSite:
    def __init__(self, index, scope):
        self.index, self.scope = index, scope


class _FakeIndex:
    def __init__(self, scopes):
        self.sites = [_FakeSite(i, s) for i, s in enumerate(scopes)]


def test_ladder_corrupted_rows_are_prime_suspects():
    base = np.tile(np.array([8, 10, 0, 1], np.int32), (4, 1))
    tab = base.copy()
    tab[2] = OVERFLOW_ROW
    tab[3] = tg.bitflip_row(tab[3], 30)
    got = [g.EscalationLadder(base).suspects(tab) for g in BOTH]
    assert got[1] == got[0] == [2, 3]


def test_ladder_blamed_scopes_then_narrowest_fallback():
    base = np.array([[8, 10, 0, 1], [8, 2, 0, 1], [8, 10, 0, 1],
                     [5, 2, 0, 1]], np.int32)
    idx = _FakeIndex(["layer0/mlp", "layer1/attn", "layer0/mlp",
                      "layer1/attn"])
    got = []
    for g in BOTH:
        ladder = g.EscalationLadder(base, site_index=idx,
                                    cfg=g.GuardrailConfig(top_k=2))
        ladder.suspect_scopes = ["layer0/mlp"]
        blamed = ladder.suspects(base)
        ladder.suspect_scopes = []
        got.append((blamed, ladder.suspects(base)))
    assert got[1] == got[0]
    assert got[1][0] == [0, 2]                   # the blamed scope wins
    assert got[1][1] == [3, 1]                   # narrowest (m=2, e=5) first


def _climb(g):
    base = np.tile(np.array([8, 2, 0, 1], np.int32), (3, 1))
    log = g.GuardrailLog()
    ladder = g.EscalationLadder(base, log=log,
                                cfg=g.GuardrailConfig(top_k=4))
    t1, rb1 = ladder.escalate(base, 10, g.Verdict(False, "spike", z=8.0))
    l1 = ladder.level
    t2, rb2 = ladder.escalate(t1, 20, g.Verdict(False, "spike again"))
    return t1, rb1, l1, t2, rb2, ladder.level, log


def test_ladder_climbs_to_fp32_degrade():
    t1, rb1, l1, t2, rb2, l2, log = _climb(tg)
    assert not rb1 and l1 == 1                   # rung 1: in-place widen
    assert all(np.array_equal(r, IDENTITY_ROW) for r in t1)
    assert rb2 and l2 == 3                       # the final rung
    assert np.array_equal(t2, np.tile(IDENTITY_ROW, (3, 1)))
    assert log.kinds() == {"alarm": 2, "escalate_sites": 1,
                           "degrade_fp32": 1}
    want = _climb(jg)
    for a, b in zip((t1, rb1, l1, t2, rb2, l2), want[:6]):
        np.testing.assert_array_equal(a, b)
    assert log.to_json() == want[6].to_json()


def test_ladder_nonfinite_alarm_goes_straight_to_rollback():
    base = np.tile(np.array([8, 2, 0, 1], np.int32), (2, 1))
    got = []
    for g in BOTH:
        ladder = g.EscalationLadder(base)
        tab, rb = ladder.escalate(base, 5, g.Verdict(False, "nan",
                                                     nonfinite=True))
        got.append((tab, rb, ladder.level, ladder.log.to_json()))
    assert got[1][1] and got[1][2] == 2
    np.testing.assert_array_equal(got[1][0], got[0][0])
    assert got[1][1:] == got[0][1:]


# ---------------------------------------------------------------------------
# GuardedLoop on a synthetic (model-free) step
# ---------------------------------------------------------------------------

def _synthetic_step(overflow_row):
    def step(state, step, table):
        """Loss explodes to inf while any table row sits at the overflow
        row."""
        tab = np.asarray(table, np.int32)
        bad = any(np.array_equal(r, overflow_row) for r in tab)
        loss = float("inf") if bad else 1.0 / (1.0 + float(state["x"]))
        return {"x": state["x"] + 1.0}, loss, not np.isfinite(loss)
    return step


def _summary(res):
    return (res.final_step, float(res.final_loss), res.rollbacks,
            res.table.tolist(), res.log.to_json())


def _loop_both(tmp_path, n, make_kw):
    out = []
    for g, ck, row in ((jg, JCheckpointer, J_OVERFLOW_ROW),
                       (tg, Checkpointer, OVERFLOW_ROW)):
        kw = make_kw(g, ck, tmp_path / g.__name__)
        loop = g.GuardedLoop(_synthetic_step(row), {"x": np.float64(0.0)},
                             **kw)
        out.append(_summary(loop.run(n)))
    return out


def test_guarded_loop_detects_escalates_and_recovers(tmp_path):
    base = np.tile(np.array([8, 10, 0, 1], np.int32), (3, 1))
    ref, port = _loop_both(tmp_path, 20, lambda g, ck, d: dict(
        table=base, checkpointer=ck(str(d), async_save=False),
        cfg=g.GuardrailConfig(save_every=4),
        fault_plan=g.FaultPlan([g.FaultSpec(site=1, step=10,
                                            kind="overflow")])))
    final_step, final_loss, rollbacks, table, log = port
    assert final_step == 20 and np.isfinite(final_loss) and rollbacks == 1
    assert table[1] == IDENTITY_ROW.tolist() and table[0] == base[0].tolist()
    assert [iv["kind"] for iv in log] == ["fault_injected", "alarm",
                                          "escalate_sites", "rollback"]
    assert port == ref


def test_guarded_loop_without_checkpointer_restarts_from_init(tmp_path):
    base = np.tile(np.array([8, 10, 0, 1], np.int32), (2, 1))
    ref, port = _loop_both(tmp_path, 8, lambda g, ck, d: dict(
        table=base,
        fault_plan=g.FaultPlan([g.FaultSpec(site=0, step=3,
                                            kind="overflow")])))
    assert port[0] == 8 and port[2] == 1 and np.isfinite(port[1])
    assert port == ref


def test_guarded_loop_exhausts_rollbacks_and_raises():
    def bad_step(state, step, table):
        return state, float("nan"), True
    counts = []
    for g in BOTH:
        loop = g.GuardedLoop(bad_step, {}, np.tile(IDENTITY_ROW, (2, 1)),
                             cfg=g.GuardrailConfig(max_rollbacks=2))
        with pytest.raises(g.NumericalFaultError):
            loop.run(5)
        counts.append((loop.rollbacks, loop.log.to_json()))
    assert counts[1][0] >= 3
    assert counts[1] == counts[0]


# ---------------------------------------------------------------------------
# GuardedTrainer on the tiny model, both packages on the same parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm, tm = models()
    jp, tp = both_params(jm, tm, 0)
    jb, tb = fixed_batch(jm.cfg.vocab, B=4, S=16)
    return jm, jp, jb, tm, tp, tb


def _trainers(tiny, tmp_path, fault_plan, n_steps):
    jm, jp, jb, tm, tp, tb = tiny
    out = []
    for g, model, params, batch, ck, tcfg, pol, opt in (
            (jg, jm, jp, jb, JCheckpointer, JTrainConfig, JPolicy,
             JAdamWConfig),
            (tg, tm, tp, tb, Checkpointer, TrainConfig, TruncationPolicy,
             AdamWConfig)):
        tc = tcfg(optimizer=opt(lr=1e-2),
                  policy=pol.scoped("**/mlp", "e8m10"))
        ckpt = (ck(str(tmp_path / g.__name__), async_save=False)
                if fault_plan is not None else None)
        gt = g.GuardedTrainer(
            model, tc, tc.policy, params, lambda step, b=batch: b,
            checkpointer=ckpt, cfg=g.GuardrailConfig(save_every=5),
            fault_plan=fault_plan(g) if fault_plan is not None else None)
        out.append((gt, gt.run(n_steps)))
    return out


def test_guarded_trainer_bitflip_fault_recovers(tiny, tmp_path):
    (jgt, jres), (tgt, tres) = _trainers(
        tiny, tmp_path,
        lambda g: g.FaultPlan([g.FaultSpec(site=0, step=8, kind="bitflip")]),
        16)
    assert tres.final_step == 16 and np.isfinite(tres.final_loss)
    assert tres.rollbacks >= 1
    assert tgt.cache_size() == 1            # escalation was table-only
    kinds = tres.log.kinds()
    assert kinds["fault_injected"] == 1 and kinds["rollback"] >= 1
    assert np.array_equal(tgt.table[0], IDENTITY_ROW)
    # the same fault, alarm, escalated rows and rollback at the same steps
    assert tres.log.to_json() == jres.log.to_json()
    assert tres.rollbacks == jres.rollbacks
    np.testing.assert_array_equal(tgt.table, jgt.table)
    assert len(tgt.sites) == len(jgt.sites.sites)
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-3)


def test_guarded_trainer_fault_free_run_logs_nothing(tiny, tmp_path):
    (jgt, jres), (tgt, tres) = _trainers(tiny, tmp_path, None, 10)
    assert tres.rollbacks == 0 and len(tres.log) == 0
    assert np.isfinite(tres.final_loss) and tgt.cache_size() == 1
    assert jres.rollbacks == 0 and len(jres.log) == 0
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-3)
    # bit-equal to the unguarded hot-swap step on the same table
    _, _, _, tm, tp, tb = tiny
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-2),
                     policy=TruncationPolicy.scoped("**/mlp", "e8m10"))
    step, sites = make_hotswap_train_step(tm, tc, tc.policy, tp, tb)
    table = step.device_table(sites.table_for(tc.policy))
    p, o = tp, init_opt_state(tm, tp, tc, device="cpu")
    for s in range(10):
        p, o, m = step(p, o, tb, s, table)
    assert float(m["loss"]) == tres.final_loss


# ---------------------------------------------------------------------------
# sites_for_scope and the train entry point
# ---------------------------------------------------------------------------

def test_registry_sites_for_scope_helper():
    idx = _FakeIndex(["layer0/mlp", "layer0/mlp/sub", "layer1/mlp",
                      "layer0/mlpx"])
    for scope, want in (("layer0/mlp", [0, 1]), ("layer1", [2]),
                        ("nope", [])):
        assert tg.sites_for_scope(idx, scope) == want == \
            jg.sites_for_scope(idx, scope)


def test_launch_train_guardrails_recover_an_injected_bitflip(tmp_path):
    """``launch.train --guardrails --inject-fault 0:3:bitflip`` on the smoke
    config: the fault at step 3 is caught at step 3, its row widened and
    the run rolled back to the step-2 checkpoint, finite to the end under
    the escalated table with one enumeration; the log is saved and attached
    to the artifact."""
    from repro_torch.artifacts import PolicyArtifact, PolicyArtifact as PA
    from repro_torch.artifacts import Registry
    from repro_torch.launch import train
    reg = Registry(str(tmp_path / "reg"))
    reg.save(PolicyArtifact(name="a", policy=TruncationPolicy.scoped(
        "**/mlp", "e5m7")))
    out = train.main(["--arch", "h2o-danube-1.8b", "--device", "cpu",
                      "--seq", "16", "--global-batch", "2", "--steps", "6",
                      "--save-every", "2", "--ckpt", str(tmp_path / "ck"),
                      "--policy-artifact", "a", "--registry",
                      str(tmp_path / "reg"), "--guardrails",
                      "--inject-fault", "0:3:bitflip"])
    log = out["guardrail_log"]
    assert [(iv.step, iv.kind) for iv in log] == [
        (3, "fault_injected"), (3, "alarm"), (3, "escalate_sites"),
        (3, "rollback")]
    assert log.by_kind("escalate_sites")[0].detail["sites"] == [0]
    assert out["final_step"] == 6 and out["restarts"] == 1
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert out["step_fn"].sweep.n_traces == 1
    np.testing.assert_array_equal(out["table"][0], IDENTITY_ROW)
    saved = json.loads((tmp_path / "ck" / "guardrail_log.json").read_text())
    assert saved == log.to_json()
    audited = PA.loads((tmp_path / "ck" /
                        "guardrail_artifact.json").read_text())
    assert tg.GuardrailLog.from_artifact(audited).to_json() == log.to_json()


def test_launch_train_fault_flags_need_their_prerequisites(tmp_path):
    from repro_torch.launch import train
    base = ["--arch", "h2o-danube-1.8b", "--device", "cpu", "--steps", "1",
            "--ckpt", str(tmp_path / "ck")]
    with pytest.raises(SystemExit, match="--guardrails requires "
                                         "--policy-artifact"):
        train.main(base + ["--guardrails"])
    with pytest.raises(SystemExit, match="--inject-fault requires "
                                         "--guardrails"):
        train.main(base + ["--inject-fault", "0:1"])
    with pytest.raises(SystemExit, match="want SITE:STEP"):
        train._parse_fault("0")
    assert train._parse_fault("4:7") == tg.FaultSpec(site=4, step=7)
