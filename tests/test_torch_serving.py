"""The port's continuous-batching engine, shadow profiling and drift
detection, and ``launch/serve.py``, held to the reference package's
``tests/test_serving.py`` case by case and to the reference package itself:
both engines serve the same workload on the same parameters (the
reference's own initialisation, carried over by ``params_from_jax``) and
give the same tokens, with and without a policy; the drift scenario fires at
the same tick with the same peak (within 1 %); the guardrail log's JSON and
an artifact's provenance are the reference's text.

On the CPU, as in the reference's tests, continuous batching is held bit for
bit to decoding each request alone in a batch-1 engine. The model is the
reference's fixture: 2 layers, no ``scan_layers`` (the decode step's
unrolled branch), float32.
"""
import json
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.artifacts import PolicyArtifact as JArtifact
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import TruncationPolicy as JPolicy
from repro.guardrails.log import GuardrailLog as JLog
from repro.models import Model as JModel
from repro.serving import Engine as JEngine
from repro.serving import ShadowConfig as JShadowConfig

from repro_torch.artifacts import PolicyArtifact
from repro_torch.configs.base import ArchConfig
from repro_torch.core import TruncationPolicy
from repro_torch.guardrails import KINDS, GuardrailLog, Intervention
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from torch.utils import _pytree as pytree
from repro_torch.serving import DriftEvent, Engine, Request, ShadowConfig

LM = dict(name="srv", family="dense", n_layers=2, d_model=48, n_heads=4,
          n_kv_heads=2, head_dim=12, d_ff=96, vocab=64, dtype="float32",
          remat=False, scan_layers=False)


@pytest.fixture(scope="module")
def both():
    """(reference model, its params, port model, the same params)."""
    jm = JModel(JArchConfig(**LM))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(ArchConfig(**LM))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm.cfg,
                         "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def lm(both):
    _, _, tm, tp = both
    return tm.cfg, tm, tp


def _ragged_workload(cfg, seed=0, n=5):
    """Prompts of mixed length with mixed token budgets (the reference
    test's)."""
    r = np.random.RandomState(seed)
    lens = [3, 7, 5, 9, 2][:n]
    budgets = [4, 6, 3, 5, 8][:n]
    return [(r.randint(1, cfg.vocab, L).astype(np.int32), m)
            for L, m in zip(lens, budgets)]


def _isolated_outputs(model, params, workload, policy=None, batch_size=1):
    """Each request decoded alone, in an engine of ``batch_size`` slots."""
    outs = []
    for prompt, m in workload:
        eng = Engine(model, params, batch_size=batch_size, max_seq_len=32,
                     policy=policy)
        eng.submit(prompt, max_new_tokens=m)
        outs.append(tuple(eng.run()[0].out_tokens))
    return outs


def _serve(engine_cls, model, params, workload, **kw):
    eng = engine_cls(model, params, max_seq_len=32, **kw)
    handles = [eng.submit(p, max_new_tokens=m) for p, m in workload]
    eng.run()
    return eng, handles


# --------------------------------------------------------------------------
# ragged admission + bit-identity
# --------------------------------------------------------------------------

def test_mixed_prompt_lengths_one_batch(lm):
    cfg, model, params = lm
    workload = _ragged_workload(cfg)
    eng = Engine(model, params, batch_size=3, max_seq_len=32)
    handles = [eng.submit(p, max_new_tokens=m) for p, m in workload]
    done = eng.run()
    assert len(done) == len(workload)
    for h, (_, m) in zip(handles, workload):
        assert h.done and h.status == "ok"
        assert len(h.out_tokens) == m
    assert done[handles[0].rid] is handles[0]


@pytest.mark.parametrize("batch_size", [1, 3])
def test_continuous_bit_identical_to_isolated(lm, batch_size):
    """Continuous batching (3 slots) against each request alone: in a
    batch-1 engine (the reference's form) and in an engine of the same
    batch size with the other lanes idle."""
    cfg, model, params = lm
    workload = _ragged_workload(cfg)
    ref = _isolated_outputs(model, params, workload, batch_size=batch_size)
    eng, handles = _serve(Engine, model, params, workload, batch_size=3)
    assert [tuple(h.out_tokens) for h in handles] == ref


def test_decode_runs_at_one_row_count_whatever_the_batch_size(lm):
    """Engines of 1 and 4 slots call the decode step at the same row count
    (``DECODE_ROWS``), so on the card a request decodes through the same
    summation orders in either; 9 slots take the next multiple."""
    from repro_torch.serving.engine import DECODE_ROWS, decode_rows
    cfg, model, params = lm
    rows = {}
    for b in (1, 4, 9):
        eng = Engine(model, params, batch_size=b, max_seq_len=16)
        seen = []
        step = eng._decode

        def spy(p, cache, tokens, _step=step, _seen=seen):
            _seen.append((tuple(tokens.shape), int(cache["pos"].shape[0])))
            return _step(p, cache, tokens)

        spy.cache_size = step.cache_size
        eng._decode = spy
        eng.submit(np.array([1, 2, 3]), max_new_tokens=2)
        eng.run()
        assert seen and len(set(seen)) == 1
        rows[b] = seen[0]
        assert eng.rows == decode_rows(b) and len(eng.slots) == b
    assert rows[1] == rows[4] == ((DECODE_ROWS,), DECODE_ROWS)
    assert rows[9] == ((2 * DECODE_ROWS,), 2 * DECODE_ROWS)


def test_continuous_bit_identical_under_policy(lm):
    cfg, model, params = lm
    pol = TruncationPolicy.scoped("**/mlp", "e5m4")
    workload = _ragged_workload(cfg, seed=1)
    ref = _isolated_outputs(model, params, workload, policy=pol)
    eng, handles = _serve(Engine, model, params, workload, batch_size=2,
                          policy=pol)
    assert [tuple(h.out_tokens) for h in handles] == ref


def test_midstream_admission_into_freed_slot(lm):
    """More requests than slots: the queue drains into slots as they free,
    and the decode step sees one input signature throughout. The slot reset
    keeps no per-signature state: reported as None."""
    cfg, model, params = lm
    workload = _ragged_workload(cfg)          # 5 requests, 2 slots
    eng = Engine(model, params, batch_size=2, max_seq_len=32)
    handles = [eng.submit(p, max_new_tokens=m) for p, m in workload]
    ticks = 0
    admitted_midstream = False
    while eng.step():
        ticks += 1
        live = [s for s in eng.slots if s is not None]
        if any(h.done for h in handles) and any(
                not h.done and h in live for h in handles[2:]):
            admitted_midstream = True
    assert admitted_midstream
    assert all(h.done for h in handles)
    assert eng.cache_sizes() == {"decode": 1, "reset": None}
    assert ticks == eng.ticks < sum(len(p) + m for p, m in workload)


def test_quarantined_slot_immediately_reusable(lm):
    cfg, model, params = lm
    poisoned = pytree.tree_map(lambda p: p * float("nan"), params)
    eng = Engine(model, poisoned, batch_size=2, max_seq_len=16)
    handles = [eng.submit(np.arange(1, 4, dtype=np.int32), max_new_tokens=4)
               for _ in range(3)]
    done = eng.run()
    assert len(done) == 3                     # the 3rd got a recycled slot
    for h in handles:
        assert h.done and h.status == "error_nonfinite"
        assert "quarantined" in h.error
    assert all(s is None for s in eng.slots)


def test_admission_zeroes_exactly_one_lane():
    """Stacked layer caches and the encoder-decoder's cross K/V carry the
    batch on axis 1, everything else (cursors, global and lead caches,
    recurrent states) on axis 0: a reset zeroes that lane and nothing
    else."""
    from repro_torch.configs import get_config
    for arch in ("hymba-1.5b", "deepseek-v2-236b", "seamless-m4t-large-v2",
                 "rwkv6-7b"):
        cache = Model(get_config(arch, "smoke")).init_cache(3, 8,
                                                            device="cpu")
        flat = [(t, 1 if key in ("layers", "cross_k", "cross_v") else 0)
                for key, sub in cache.items()
                for t in pytree.tree_leaves(sub)]
        for t, _ in flat:
            t.fill_(1)
        Engine._slot_reset(cache, 1)
        for t, axis in flat:
            lane = t.select(axis, 1)
            assert not bool(lane.any()), arch
            assert bool(t.select(axis, 0).all() and t.select(axis, 2).all())


# --------------------------------------------------------------------------
# engine handles: auto-rid, legacy shim, stream(), validation
# --------------------------------------------------------------------------

def test_submit_returns_handle_with_auto_rid(lm):
    cfg, model, params = lm
    eng = Engine(model, params, batch_size=2, max_seq_len=16)
    a = eng.submit(np.array([1, 2, 3]), max_new_tokens=2)
    b = eng.submit(np.array([4, 5]), max_new_tokens=2)
    assert isinstance(a, Request) and (a.rid, b.rid) == (0, 1)
    c = eng.submit(np.array([6]), rid=7, max_new_tokens=2)
    assert c.rid == 7
    d = eng.submit(np.array([7]), max_new_tokens=2)
    assert d.rid == 8


def test_legacy_positional_submit_warns_and_works(lm):
    cfg, model, params = lm
    eng = Engine(model, params, batch_size=2, max_seq_len=16)
    with pytest.warns(DeprecationWarning, match="submit"):
        req = eng.submit(3, np.array([1, 2, 3]), max_new_tokens=2)
    assert req.rid == 3
    done = eng.run()
    assert done[3].out_tokens == req.out_tokens and len(req.out_tokens) == 2


def test_stream_yields_in_completion_order(lm):
    cfg, model, params = lm
    workload = _ragged_workload(cfg)
    eng = Engine(model, params, batch_size=2, max_seq_len=32)
    handles = [eng.submit(p, max_new_tokens=m) for p, m in workload]
    order = [r.rid for r in eng.stream()]
    assert sorted(order) == [h.rid for h in handles]
    assert all(h.done for h in handles)
    assert order != [h.rid for h in handles]


def test_submit_validation_messages(lm):
    cfg, model, params = lm
    eng = Engine(model, params, batch_size=2, max_seq_len=16)
    with pytest.raises(ValueError, match="non-empty 1-D"):
        eng.submit(np.array([], np.int32))
    with pytest.raises(ValueError, match="max_seq_len=16"):
        eng.submit(np.arange(1, 17))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.array([1]), max_new_tokens=0)


def test_cache_lives_on_the_params_device(lm):
    cfg, model, params = lm
    eng = Engine(model, params, batch_size=2, max_seq_len=16)
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in
               (eng.cache["pos"], eng.cache["layers"]["k"]))


# --------------------------------------------------------------------------
# shadow profiling + drift
# --------------------------------------------------------------------------

def test_shadow_serving_bit_identical_and_reports(lm):
    cfg, model, params = lm
    pol = TruncationPolicy.scoped("**/mlp", "e5m7")
    workload = _ragged_workload(cfg)
    _, ph = _serve(Engine, model, params, workload, batch_size=2, policy=pol)
    eng, sh = _serve(Engine, model, params, workload, batch_size=2,
                     policy=pol, shadow=ShadowConfig(rate=1.0,
                                                     threshold=1e-3))
    assert all(h.shadowed for h in sh)
    assert [tuple(a.out_tokens) for a in sh] == \
           [tuple(a.out_tokens) for a in ph]
    assert eng.serving_report is not None
    assert eng.serving_report.top(1)
    assert all(h.report is not None for h in sh)
    sizes = eng.cache_sizes()
    assert sizes["shadow"] == 1 and sizes["reset"] is None


def test_shadow_trajectory_mode_serves_the_same_tokens(lm):
    cfg, model, params = lm
    pol = TruncationPolicy.scoped("**/mlp", "e5m7")
    workload = _ragged_workload(cfg, n=3)
    _, ph = _serve(Engine, model, params, workload, batch_size=2, policy=pol)
    eng, sh = _serve(Engine, model, params, workload, batch_size=2,
                     policy=pol, shadow=ShadowConfig(rate=1.0,
                                                     mode="trajectory"))
    assert [h.out_tokens for h in sh] == [h.out_tokens for h in ph]
    assert eng.serving_report.top(1) and eng.cache_sizes()["shadow"] == 1
    with pytest.raises(ValueError, match="unknown shadow mode"):
        Engine(model, params, batch_size=1, policy=pol,
               shadow=ShadowConfig(mode="nope"))
    with pytest.raises(ValueError, match="deployed"):
        Engine(model, params, batch_size=1, shadow=ShadowConfig())


def test_shadow_rate_zero_samples_nothing(lm):
    cfg, model, params = lm
    pol = TruncationPolicy.scoped("**/mlp", "e5m7")
    eng = Engine(model, params, batch_size=2, max_seq_len=16, policy=pol,
                 shadow=ShadowConfig(rate=0.0))
    h = eng.submit(np.array([1, 2, 3]), max_new_tokens=3)
    eng.run()
    assert not h.shadowed and h.report is None
    assert eng.serving_report is None


def test_drift_detection_pages_and_lands_in_provenance(lm):
    cfg, model, params = lm
    art = PolicyArtifact(name="drifty",
                         policy=TruncationPolicy.everywhere("e5m2"),
                         provenance={"threshold": 1e-7})
    events = []
    shadow = ShadowConfig(rate=1.0, threshold=1e-6, min_shadow_ticks=4,
                          drift_margin=4.0, on_drift=events.append)
    eng, _ = _serve(Engine, model, params, _ragged_workload(cfg),
                    batch_size=2, policy=art, shadow=shadow)
    assert len(events) == 1                    # latched: fires once
    ev = events[0]
    assert isinstance(ev, DriftEvent)
    assert ev.budget == pytest.approx(1e-7)
    assert ev.peak > 4.0 * ev.budget
    assert ev.blame and isinstance(ev.blame[0][0], str)
    assert "drift@tick" in str(ev)
    assert eng.drift_events == [ev]
    kinds = eng.guardrail_log.kinds()
    assert kinds["drift_detected"] == 1 and kinds["research_paged"] == 1
    prov = eng.artifact.provenance["guardrail_log"]
    assert any(e["kind"] == "drift_detected" for e in prov)


def test_drift_scenario_fires_where_the_reference_fires(both):
    """The reference's ``test_no_drift_within_budget`` scenario (red there
    on jax 0.9.0: the e8m10 MLP rounds a near-zero product, whose hybrid
    deviation passes 4 x 0.1): the port computes what the reference
    computes — an event at the same tick, a peak within 1 %, the same
    top-blamed scope and primitive."""
    jm, jp, tm, tp = both
    runs = []
    for eng_cls, model, params, art_cls, pol, shadow_cls in (
            (JEngine, jm, jp, JArtifact, JPolicy, JShadowConfig),
            (Engine, tm, tp, PolicyArtifact, TruncationPolicy,
             ShadowConfig)):
        art = art_cls(name="stable", policy=pol.scoped("**/mlp", "e8m10"),
                      provenance={"threshold": 1e-1})
        events = []
        eng, _ = _serve(eng_cls, model, params,
                        _ragged_workload(tm.cfg, n=2), batch_size=2,
                        policy=art,
                        shadow=shadow_cls(rate=1.0, threshold=1e-3,
                                          min_shadow_ticks=2,
                                          on_drift=events.append))
        runs.append(events)
    want, got = runs
    assert len(want) == len(got) == 1
    assert got[0].tick == want[0].tick
    assert got[0].peak == pytest.approx(want[0].peak, rel=1e-2)
    assert got[0].peak > 4 * 0.1
    assert got[0].blame[0][0].split(" @ ")[0] == \
        want[0].blame[0][0].split(" @ ")[0]


# --------------------------------------------------------------------------
# both packages, one workload
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [None, "scope:**/mlp=e5m4",
                                    "scope:**/attn=e8m3"])
def test_both_packages_serve_the_same_tokens(both, policy):
    """The same ragged workload through both engines, 2 slots, plain or
    under a policy (the attention one matches nothing at decode in either
    package)."""
    jm, jp, tm, tp = both
    workload = _ragged_workload(tm.cfg, seed=2)
    _, want = _serve(JEngine, jm, jp, workload, batch_size=2, policy=policy)
    _, got = _serve(Engine, tm, tp, workload, batch_size=2, policy=policy)
    assert [h.out_tokens for h in got] == [h.out_tokens for h in want]
    assert [h.status for h in got] == [h.status for h in want]


# --------------------------------------------------------------------------
# the guardrail log
# --------------------------------------------------------------------------

def _records(log):
    log.record(3, "drift_detected", peak=0.5, budget=0.1, margin=4.0,
               shadow_ticks=2, blame=[{"location": "layer/mlp dot_general",
                                       "flags": 7, "max_rel": 0.5}])
    log.record(3, "research_paged", hook="append")
    return log


def test_guardrail_log_json_equals_the_reference(tmp_path):
    log, jlog = _records(GuardrailLog()), _records(JLog())
    assert log.to_json() == jlog.to_json()
    assert KINDS == __import__("repro.guardrails.log",
                               fromlist=["KINDS"]).KINDS
    back = GuardrailLog.from_json(json.loads(json.dumps(log.to_json())))
    assert back.to_json() == log.to_json() and len(back) == 2
    assert back.by_kind("research_paged")[0] == Intervention(
        3, "research_paged", {"hook": "append"})
    path = str(tmp_path / "log.json")
    log.save(path)
    assert GuardrailLog.load(path).to_json() == log.to_json()
    assert "drift_detected=1" in log.summary()
    with pytest.raises(ValueError, match="unknown intervention kind"):
        log.record(0, "nope")
    # the same provenance JSON in an artifact of either package
    art = log.attach(PolicyArtifact(
        name="a", policy=TruncationPolicy.scoped("**/mlp", "e5m7")))
    jart = jlog.attach(JArtifact(name="a",
                                 policy=JPolicy.scoped("**/mlp", "e5m7")))
    assert art.dumps() == jart.dumps()
    assert GuardrailLog.from_artifact(art).to_json() == jlog.to_json()


# --------------------------------------------------------------------------
# launch.serve
# --------------------------------------------------------------------------

def test_launch_serve_smoke_on_the_cpu(capsys):
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "glm4-9b", "--device", "cpu", "--requests",
                      "3", "--new-tokens", "4", "--policy",
                      "scope:**/mlp=e5m7", "--shadow-rate", "1.0"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert eng.model.cfg.name == "glm4-9b" and eng.model.cfg.n_layers < 40
    assert all(r.status == "ok" and r.shadowed for r in eng._done.values())
    assert eng.cache_sizes() == {"decode": None, "reset": None, "shadow": 1}
    assert eng.served_seconds > 0


def test_launch_serve_resolve_policy_wrapper():
    from repro_torch.core.policy import parse_policy
    from repro_torch.launch.serve import resolve_policy as serve_resolve
    pol, art = serve_resolve("scope:**/mlp=e5m7", None)
    assert art is None and pol == parse_policy("scope:**/mlp=e5m7")
    with pytest.raises(SystemExit):
        serve_resolve("scope:**/mlp=e5m7", "x@v1")


def test_launch_serve_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default device exists")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "glm4-9b"])
