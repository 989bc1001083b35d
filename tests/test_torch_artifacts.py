"""Policy artifacts of the port (``repro_torch.artifacts``) against the
reference's: lossless policy/artifact JSON round trips with the reference's
text, the file-backed versioned registry shared between the two packages,
the producers (``SearchResult.to_artifact``, ``OracleVerdict.attach``) and
the profile -> registry -> deploy -> warm re-search loop.

The cases of ``tests/test_artifacts.py`` that need no engine, trainer or
checkpointer are here. Left for later items: the serving engine's
(``test_engine_submit_validation``,
``test_engine_serves_artifact_bit_identical_to_policy`` and the engine half
of ``test_acceptance_bench_model_artifact_loop``: item 9), the trainer's and
checkpointer's (``test_checkpoint_manifest_records_artifact``,
``test_hotswap_train_step_zero_recompile``: item 7), and
``test_policy_drift_diff_detects_assignment_moves`` (the drift gate is a
reference benchmark, ``benchmarks/policy_drift.py``; its port comes with
the benchmarks, item 12). ``parse_policy``'s ``launch.train`` re-export
comes with item 7.

Tolerances: none. JSON text, digests, assignments, dispatch counts and
truncated outputs are compared exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core as jc
from repro.artifacts import PolicyArtifact as JPolicyArtifact
from repro.artifacts import Registry as JRegistry
from repro.artifacts import ScopeRow as JScopeRow
from repro.artifacts import load_artifact_file as jload_artifact_file
from repro.core.formats import E4M3 as JE4M3, E4M3FN as JE4M3FN
from repro.core.formats import FPFormat as JFPFormat

from repro_torch import search as ts
from repro_torch.apps import get_app, oracle
from repro_torch.artifacts import (
    ArtifactRef, ArtifactSchemaError, PolicyArtifact, Registry, ScopeRow,
    SCHEMA_VERSION, load_artifact_file, parse_ref, save_artifact_file,
)
from repro_torch.core import (
    NotSerializableError, TruncationPolicy, TruncationRule, truncate,
    profile_trajectory,
)
from repro_torch.core.formats import E4M3, E4M3FN, FPFormat
from repro_torch.core.policy import magnitude_below, parse_policy
from repro_torch.profile import ladder_hints

from test_torch_search import assigns, bench, toy_args, ttoy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BENCH_JSON = os.path.join(ROOT, "artifacts", "bench_model.json")


# --------------------------------------------------------------------------
# policy / format JSON round trips
# --------------------------------------------------------------------------

def every_rule_kind(Policy, Rule, Fmt, e4m3, e4m3fn):
    """``tests/test_artifacts.py``'s policies, built from one package."""
    return [
        Policy.from_flag("64_to_5_14;32_to_3_8"),
        Policy.scoped("**/mlp", "e5m7"),
        Policy(rules=(Rule(fmt=Fmt(8, 10), scope="layer*/attn",
                           ops=("dot_general", "add"),
                           exclude_ops=("exp", "tanh")),)),
        Policy(rules=(Rule(fmt=Fmt(8, 7), quantize_dot_inputs=True),)),
        Policy(rules=(Rule(fmt=e4m3, scope="a/**"),
                      Rule(fmt=e4m3fn, scope="b"),
                      Rule(fmt=Fmt(5, 2, saturate=True), from_width=32))),
        Policy(rules=(Rule(fmt=Fmt(8, 2), scope="**"),
                      Rule(fmt=Fmt(8, 10), scope="head")),
               excludes=("recon", "layer0/attn")),
    ]


PORT_POLICIES = every_rule_kind(TruncationPolicy, TruncationRule, FPFormat,
                                E4M3, E4M3FN)
REF_POLICIES = every_rule_kind(jc.TruncationPolicy, jc.TruncationRule,
                               JFPFormat, JE4M3, JE4M3FN)


def canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@pytest.mark.parametrize("k", range(len(PORT_POLICIES)))
def test_policy_json_round_trip_every_rule_kind(k):
    """Every serializable rule kind survives a real JSON trip (equality and
    cache identity), and its JSON text is the reference's."""
    pol = PORT_POLICIES[k]
    back = TruncationPolicy.from_json(json.loads(json.dumps(pol.to_json())))
    assert back == pol
    assert back.cache_key() == pol.cache_key()
    assert canonical(pol.to_json()) == canonical(REF_POLICIES[k].to_json())


@pytest.mark.parametrize("name", ["sod", "heat", "poisson"])
def test_mini_app_default_policies_round_trip(name):
    from repro.apps import get_app as jget_app
    app, japp = get_app(name), jget_app(name)
    uni = app.uniform_policy()
    assert TruncationPolicy.from_json(uni.to_json()) == uni
    assert canonical(uni.to_json()) == canonical(japp.uniform_policy().to_json())
    scoped = TruncationPolicy(rules=tuple(
        TruncationRule(fmt=FPFormat(8, m), scope=s)
        for m, s in enumerate(app.default_policy_scopes(), start=3)))
    assert TruncationPolicy.from_json(scoped.to_json()) == scoped


def test_mask_rule_raises_not_serializable():
    pol = TruncationPolicy(rules=(TruncationRule(
        fmt=FPFormat(8, 4), scope="**/mlp", mask=magnitude_below(1e-3)),))
    with pytest.raises(NotSerializableError, match="magnitude_below"):
        pol.to_json()
    art = PolicyArtifact(name="masked", policy=pol)
    with pytest.raises(NotSerializableError):
        art.to_json()
    assert issubclass(NotSerializableError, TypeError)


def test_future_schema_version_fails_naming_versions():
    art = PolicyArtifact(name="x", policy=TruncationPolicy.scoped("a", "e8m4"))
    data = art.to_json()
    data["schema_version"] = 99
    with pytest.raises(ArtifactSchemaError) as ei:
        PolicyArtifact.from_json(data)
    assert "99" in str(ei.value) and str(SCHEMA_VERSION) in str(ei.value)
    assert SCHEMA_VERSION == 1


def demo(pkg):
    """The same artifact built from one package's classes."""
    Art, Row, Policy = pkg
    return Art(
        name="demo", policy=Policy.from_flag("32_to_5_7"),
        assignments={"mlp": Row(man_bits=4, error_at_accept=1e-4,
                                flops=100.0, fraction=0.5, n_eqns=3),
                     "attn": Row(man_bits=23, error_at_accept=0.0,
                                 excluded=True)},
        provenance={"threshold": 1e-3, "history": [["probe", 0.1]],
                    "final_error": float("inf")},
        hints={"mlp": 4, "attn": None})


PORT = (PolicyArtifact, ScopeRow, TruncationPolicy)
REF = (JPolicyArtifact, JScopeRow, jc.TruncationPolicy)


def test_artifact_round_trip_and_digest():
    art = demo(PORT)
    back = PolicyArtifact.loads(art.dumps())
    assert back == art and back.digest == art.digest
    art2 = PolicyArtifact(
        name="demo", policy=art.policy,
        assignments=dict(reversed(list(art.assignments.items()))),
        provenance={"final_error": float("inf"), "history": [["probe", 0.1]],
                    "threshold": 1e-3},
        hints={"attn": None, "mlp": 4})
    assert art2.digest == art.digest
    # byte for byte the reference's text, so the same digest
    assert art.dumps() == demo(REF).dumps()
    assert art.digest == demo(REF).digest
    assert "PolicyArtifact 'demo'" in str(art) and "mlp" in art.table()


def test_numpy_and_torch_scalars_serialise_as_python_numbers():
    """A provenance or hint value computed with numpy or torch writes the
    number it holds: the text equals the artifact built from Python
    numbers."""
    plain = demo(PORT)
    art = PolicyArtifact(
        name="demo", policy=plain.policy,
        assignments={"mlp": ScopeRow(man_bits=np.int64(4),
                                     error_at_accept=np.float32(1e-4),
                                     flops=torch.tensor(100.0),
                                     fraction=np.float64(0.5),
                                     n_eqns=torch.tensor(3)),
                     "attn": plain.assignments["attn"]},
        provenance={"threshold": np.float64(1e-3),
                    "history": [["probe", np.float64(0.1)]],
                    "final_error": torch.tensor(float("inf"),
                                                dtype=torch.float64)},
        hints={"mlp": np.int32(4), "attn": None})
    assert art.dumps().replace(str(float(np.float32(1e-4))), "0.0001") \
        == plain.dumps()
    assert PolicyArtifact.loads(art.dumps()).hints == {"mlp": 4, "attn": None}


def test_parse_policy_grammar():
    assert parse_policy(None) is None
    assert parse_policy("") is None
    pol = TruncationPolicy.scoped("**/mlp", "e5m7")
    assert parse_policy(pol) is pol
    assert parse_policy("scope:**/mlp=e5m7") == pol
    assert parse_policy("64_to_5_14;32_to_3_8") == \
        TruncationPolicy.from_flag("64_to_5_14;32_to_3_8")


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def _artifact(name="m", man_bits=4, pkg=PORT):
    Art, Row, Policy = pkg
    Fmt = FPFormat if pkg is PORT else JFPFormat
    return Art(
        name=name,
        policy=Policy.scoped("**/mlp", Fmt(8, man_bits)),
        assignments={"mlp": Row(man_bits=man_bits, error_at_accept=1e-4)},
        hints={"mlp": man_bits})


def test_parse_ref():
    assert parse_ref("bench_model") == ("bench_model", None)
    assert parse_ref("bench_model@v3") == ("bench_model", 3)
    with pytest.raises(ValueError, match="name@vN"):
        parse_ref("bench_model@three")


def test_registry_save_load_versions_latest(tmp_path):
    reg = Registry(str(tmp_path))
    refs = [reg.save(_artifact(man_bits=m)) for m in (2, 4, 7)]
    assert [r.version for r in refs] == [1, 2, 3]
    assert refs[0].ref == "m@v1"
    assert reg.names() == ["m"]
    assert reg.versions("m") == [1, 2, 3]
    assert reg.latest_version("m") == 3
    assert reg.load("m@v1") == _artifact(man_bits=2)
    assert reg.load("m") == _artifact(man_bits=7)
    art, ref = reg.load_ref("m")
    assert ref.version == 3 and ref.digest == art.digest
    assert reg.digest("m@v2") == _artifact(man_bits=4).digest
    assert ArtifactRef.from_json(refs[1].to_json()) == refs[1]
    # the reference's on-disk layout
    assert sorted(os.listdir(tmp_path / "m")) == ["LATEST", "v0001", "v0002",
                                                 "v0003"]
    assert (tmp_path / "m" / "LATEST").read_text() == "v0003"


def test_registry_missing_refs_fail_clearly(tmp_path):
    reg = Registry(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="empty registry"):
        reg.load("nope")
    reg.save(_artifact())
    with pytest.raises(FileNotFoundError, match="m@v9"):
        reg.load("m@v9")
    with pytest.raises(ValueError, match="bad artifact name"):
        reg.save(_artifact(), name="../escape")


def test_registry_keep_k_gc_and_latest_self_heal(tmp_path):
    reg = Registry(str(tmp_path), keep_k=2)
    for m in (2, 3, 4, 5):
        reg.save(_artifact(man_bits=m))
    assert reg.versions("m") == [3, 4]          # GC kept the newest two
    assert reg.load("m") == _artifact(man_bits=5)
    os.remove(tmp_path / "m" / "LATEST")
    assert reg.latest_version("m") == 4
    assert reg.load("m") == _artifact(man_bits=5)
    # a dangling LATEST (its version gone) heals to the newest on disk
    (tmp_path / "m" / "LATEST").write_text("v0009")
    assert reg.latest_version("m") == 4


def test_registry_ignores_stale_tmp_dirs(tmp_path):
    reg = Registry(str(tmp_path))
    reg.save(_artifact())
    os.makedirs(tmp_path / "m" / ".tmp_v0002_99999")
    os.makedirs(tmp_path / ".half-written")
    assert reg.versions("m") == [1]
    assert reg.names() == ["m"]
    assert reg.save(_artifact(man_bits=9)).version == 2


def test_registry_default_root_follows_the_environment(tmp_path, monkeypatch):
    from repro_torch.artifacts import default_root
    from repro_torch.artifacts.registry import DEFAULT_ROOT_ENV
    assert DEFAULT_ROOT_ENV == "RAPTOR_REGISTRY"
    monkeypatch.setenv(DEFAULT_ROOT_ENV, str(tmp_path / "reg"))
    assert default_root() == str(tmp_path / "reg")
    assert Registry().save(_artifact()).ref == "m@v1"
    assert os.path.isdir(tmp_path / "reg" / "m" / "v0001")


def test_artifact_file_round_trip(tmp_path):
    path = str(tmp_path / "committed" / "m.json")
    art = _artifact()
    save_artifact_file(art, path)
    assert load_artifact_file(path) == art
    text = open(path).read()
    assert text.endswith("\n") and "\n  " in text
    # the reference writes the same bytes
    jpath = str(tmp_path / "ref.json")
    from repro.artifacts import save_artifact_file as jsave
    jsave(_artifact(pkg=REF), jpath)
    assert open(jpath).read() == text


def test_committed_bench_model_artifact_is_valid():
    """The committed artifact (read only) loads in the port with the
    reference's digest, and is internally consistent."""
    art = load_artifact_file(BENCH_JSON)
    assert art.name == "bench_model"
    assert len(art.policy.rules) >= 1
    assert art.assignments and set(art.hints) == set(art.assignments)
    assert art.provenance["threshold"] == 5e-3
    assert art.schema_version == SCHEMA_VERSION
    jart = jload_artifact_file(BENCH_JSON)
    assert art.digest == jart.digest
    assert art.dumps() == jart.dumps()


def test_cross_package_registry(tmp_path):
    """One registry serves both packages: what the reference saves the port
    loads with the same digest, and the other way round, lint warnings
    included (a shadowed rule is recorded in provenance by both)."""
    jreg, treg = JRegistry(str(tmp_path)), Registry(str(tmp_path))
    jref = jreg.save(_artifact("shared", 5, pkg=REF))
    tref = treg.save(_artifact("shared", 3))
    assert (jref.version, tref.version) == (1, 2)
    for ref in ("shared@v1", "shared@v2"):
        a, b = treg.load(ref), jreg.load(ref)
        assert a.digest == b.digest and a.dumps() == b.dumps()
    assert treg.load("shared@v1").policy == _artifact("shared", 5).policy
    assert jreg.load("shared").policy == _artifact("shared", 3, REF).policy
    # lint: the second rule is shadowed by the first, a warning both record
    shadowed = [(Art, Policy, Rule, Fmt) for Art, Policy, Rule, Fmt in (
        (PolicyArtifact, TruncationPolicy, TruncationRule, FPFormat),
        (JPolicyArtifact, jc.TruncationPolicy, jc.TruncationRule, JFPFormat))]
    arts = [Art(name="lint", policy=Policy(rules=(
        Rule(fmt=Fmt(8, 3), scope="**"), Rule(fmt=Fmt(8, 7), scope="mlp"))))
        for Art, Policy, Rule, Fmt in shadowed]
    r1, r2 = treg.save(arts[0]), jreg.save(arts[1])
    t1, j2 = treg.load(r1.ref), jreg.load(r2.ref)
    assert t1.provenance["lint_warnings"] == j2.provenance["lint_warnings"]
    assert r1.digest == r2.digest
    # an artifact failing lint is not published
    from repro_torch.analysis import ArtifactLintError
    from repro_torch.analysis import lint_artifact
    masked = PolicyArtifact(name="masked", policy=TruncationPolicy(rules=(
        TruncationRule(fmt=FPFormat(8, 4), mask=magnitude_below(1e-3)),)))
    assert [f.code for f in lint_artifact(masked)] == ["mask-not-serializable"]
    with pytest.raises(ArtifactLintError):
        treg.save(masked)
    assert "masked" not in treg.names()


# --------------------------------------------------------------------------
# producers: search + oracle
# --------------------------------------------------------------------------

def test_search_result_to_artifact_provenance(tmp_path):
    _, args = toy_args()
    res = ts.autosearch(ttoy, args, ts.rel_error, 48, threshold=1e-2)
    art = res.to_artifact("toy")
    assert art.policy == res.policy()
    assert set(art.assignments) == set(res.assignments)
    for p, a in res.assignments.items():
        row = art.assignments[p]
        assert (row.man_bits, row.excluded) == (a.man_bits, a.excluded)
        assert row.fraction == pytest.approx(a.scope.fraction)
    prov = art.provenance
    assert prov["threshold"] == 1e-2 and prov["budget"] == 48
    assert prov["evals_used"] == res.evals_used
    assert prov["n_dispatches"] == res.n_dispatches
    assert prov["history"] and all(len(h) == 2 for h in prov["history"])
    assert art.hints == res.hints()
    assert all(type(v) in (int, float, bool, list)
               for v in prov.values())
    reg = Registry(str(tmp_path))
    ref = reg.save(art)
    assert reg.load(ref.ref) == art
    # the reference loads it with the same digest
    assert JRegistry(str(tmp_path)).load(ref.ref).digest == ref.digest
    # hints, oracle and bench pass through
    v = oracle.OracleVerdict("toy", 1e-4, 1e-3, 1e-6)
    art2 = res.to_artifact("toy", hints={"attn": None}, oracle=v,
                           bench={"ms": 1.5})
    assert art2.hints == {"attn": None} and art2.oracle["passed"]
    assert art2.bench == {"ms": 1.5}


def test_oracle_verdict_attach():
    v = oracle.OracleVerdict(app="sod", error=2e-4, budget=1e-3, floor=5e-5)
    art = v.attach(_artifact("sod"))
    assert art.oracle == {"app": "sod", "error": 2e-4, "budget": 1e-3,
                          "floor": 5e-5, "passed": True}
    assert oracle.OracleVerdict.from_json(art.oracle).passed
    assert "oracle PASS" in str(art)
    back = PolicyArtifact.loads(art.dumps())
    assert back.oracle == art.oracle
    from repro.apps.oracle import OracleVerdict as JOracleVerdict
    jart = JOracleVerdict(app="sod", error=2e-4, budget=1e-3,
                          floor=5e-5).attach(_artifact("sod", pkg=REF))
    assert jart.dumps() == art.dumps()


# --------------------------------------------------------------------------
# e2e acceptance: profile -> registry -> fresh-state deploy -> re-search
# --------------------------------------------------------------------------

def test_e2e_sod_search_registry_reload_warm_start(tmp_path):
    """autosearch -> artifact -> registry save -> reload in a fresh
    registry object -> truncated run bit-identical under the reloaded
    policy -> ``warm_start=artifact.hints`` reproduces the assignments with
    fewer dispatches and no re-profiling (the reference's case)."""
    app = get_app("sod", n_cells=32, t_end=0.04)
    state = app.init_state(device="cpu")
    r0 = ts.autosearch(app.run_observables, (state,),
                       metric=app.error_metric, budget=48,
                       threshold=app.search_threshold)
    ref = Registry(str(tmp_path)).save(r0.to_artifact("sod"))

    out0 = truncate(app.run_observables, r0.policy())(state)
    art = Registry(str(tmp_path)).load("sod")
    assert art.digest == ref.digest
    out1 = truncate(app.run_observables, art.policy)(state)
    assert set(out0) == set(out1)
    assert all(torch.equal(out0[k], out1[k]) for k in out0)

    r1 = ts.autosearch(app.run_observables, (state,),
                       metric=app.error_metric, budget=48,
                       threshold=app.search_threshold,
                       warm_start=art.hints)
    assert assigns(r1) == assigns(r0)
    assert r1.n_dispatches < r0.n_dispatches
    r2 = ts.autosearch(app.run_observables, (state,),
                       metric=app.error_metric, budget=48,
                       threshold=app.search_threshold, warm_start=art)
    assert assigns(r2) == assigns(r0)
    assert r2.n_dispatches == r1.n_dispatches


def test_acceptance_bench_model_artifact_loop(tmp_path):
    """The reference's bench-model loop, without the serving engine: the
    persisted trajectory-blame hints make a registry-reloaded re-search
    reproduce the cold assignments in at most 4 dispatches WITHOUT
    profiling again, and the reloaded policy truncates bit for bit as the
    cold one (the bench model of ``test_torch_search.py``, scanned)."""
    _, _, tm, (params, batch) = bench(True)
    budget, thr = 128, 5e-3
    r0 = ts.autosearch(tm.loss, (params, batch), ts.loss_degradation, budget,
                       threshold=thr)
    probe = TruncationPolicy(rules=tuple(
        TruncationRule(fmt=FPFormat(8, 5), scope=p) for p in r0.assignments))
    n = tm.cfg.n_layers
    out_lo, traj = profile_trajectory(tm.loss, probe, threshold=thr,
                                      n_steps=n + 1)(params, batch)
    assert int(traj.steps_seen) == n
    joint = ts.loss_degradation(tm.loss(params, batch).numpy(),
                                out_lo.numpy())
    hints = ladder_hints(traj, ts.DEFAULT_WIDTHS, thr, 5, joint_metric=joint)
    assert set(hints) <= {b.scope for b in traj.blame(thr)}
    ref = Registry(str(tmp_path)).save(
        r0.to_artifact("bench_model", hints=hints))

    art, aref = Registry(str(tmp_path)).load_ref("bench_model")
    assert art.digest == ref.digest == aref.digest
    assert art.hints == hints
    assert torch.equal(truncate(tm.loss, art.policy)(params, batch),
                       truncate(tm.loss, r0.policy())(params, batch))
    r1 = ts.autosearch(tm.loss, (params, batch), ts.loss_degradation, budget,
                       threshold=thr, warm_start=art.hints)
    assert assigns(r1) == assigns(r0)
    assert r1.n_dispatches <= 4, r1.n_dispatches
