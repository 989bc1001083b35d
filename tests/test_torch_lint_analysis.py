"""The linter's checks that need the static analysis or the command line,
in both packages (the three such cases of ``tests/test_lint.py``):

  * ``dot-accumulator-risk``: ``lint_policy(sites=, analysis_result=,
    index=)`` warns where a ``quantize_dot_inputs`` rule's operands can
    accumulate past the carrier's range, and not where a saturating format
    clamps them; the same findings as the reference's on the same program;
  * ``python -m repro_torch.analysis.lint``: the reference CLI's exit codes
    and lines (clean, warnings, ``--strict``, an unreadable file);
  * the committed ``artifacts/`` lint clean, the benchmark model's
    context included, with the reference CLI's output line for line.
"""
import os

import numpy as np
import pytest

import jax
import torch

from repro.analysis import analyze_closed
from repro.analysis.lint import lint_policy as jlint_policy
from repro.analysis.lint import main as jmain
from repro.core import interpreter as jinterp
from repro.core.policy import TruncationPolicy as JPolicy
from repro.core.policy import TruncationRule as JRule

from repro_torch.analysis import analyze
from repro_torch.analysis.lint import lint_policy, main
from repro_torch.artifacts import PolicyArtifact, save_artifact_file
from repro_torch.core import interpreter
from repro_torch.core.interpreter import scope
from repro_torch.core.policy import TruncationPolicy, TruncationRule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(findings, level=None):
    return [f.code for f in findings if level is None or f.level == level]


def _program():
    """``tests/test_lint.py``'s program: a product of operands at 1e20
    under ``blk/mm``, then ``tanh`` and a sum of squares."""
    x = np.float32(np.ones((4, 8))) * 1e20
    w = np.float32(np.ones((8, 4))) * 1e20

    def f(x, w):
        with scope("blk"):
            with scope("mm"):
                h = x @ w
            h = torch.tanh(h)
        return torch.sum(h * h)

    def jf(x, w):
        with jax.named_scope("blk"):
            with jax.named_scope("mm"):
                h = x @ w
            h = jax.numpy.tanh(h)
        return jax.numpy.sum(h * h)
    return f, jf, x, w


@pytest.mark.parametrize("fmt,risky", [("bf16", True), ("e4m3", False)])
def test_dot_accumulator_risk(fmt, risky):
    f, jf, x, w = _program()
    args = (torch.from_numpy(x), torch.from_numpy(w))
    res = analyze(f, args, calib=list(args))
    index = interpreter.enumerate_sites(f, args, {}, TruncationPolicy(rules=(
        TruncationRule(fmt="e8m0", scope="**"),)))
    pol = TruncationPolicy(rules=(
        TruncationRule(fmt=fmt, scope="blk/mm", quantize_dot_inputs=True),))
    findings = lint_policy(pol, sites=index.sites, analysis_result=res,
                           index=index)
    assert ("dot-accumulator-risk" in _codes(findings, "warning")) == risky

    closed = jax.make_jaxpr(jf)(x, w)
    jindex = jinterp.enumerate_sites(closed, JPolicy(rules=(
        JRule(fmt="e8m0", scope="**"),)))
    jfindings = jlint_policy(
        JPolicy(rules=(JRule(fmt=fmt, scope="blk/mm",
                             quantize_dot_inputs=True),)),
        sites=jindex.sites, analysis_result=analyze_closed(closed, [x, w]),
        index=jindex)
    assert [f.render() for f in findings] == [f.render() for f in jfindings]


def test_cli_exit_codes(tmp_path, capsys):
    good = PolicyArtifact(name="good",
                          policy=TruncationPolicy.everywhere("e5m7"))
    save_artifact_file(good, str(tmp_path / "good.json"))
    assert main([str(tmp_path), "--no-model"]) == 0
    out = capsys.readouterr().out
    assert "clean" in out
    assert jmain([str(tmp_path), "--no-model"]) == 0
    assert capsys.readouterr().out == out

    warn = PolicyArtifact(name="warn", policy=TruncationPolicy(rules=(
        TruncationRule(fmt="bf16", scope="hydro"),
        TruncationRule(fmt="e5m2", scope="hydro/flux"))))
    save_artifact_file(warn, str(tmp_path / "warn.json"))
    assert main([str(tmp_path), "--no-model"]) == 0          # warnings pass
    assert main([str(tmp_path), "--no-model", "--strict"]) == 1
    out = capsys.readouterr().out
    assert jmain([str(tmp_path), "--no-model"]) == 0
    assert jmain([str(tmp_path), "--no-model", "--strict"]) == 1
    assert capsys.readouterr().out == out

    (tmp_path / "broken.json").write_text("{not json")
    assert main([str(tmp_path / "broken.json")]) == 1
    assert "unreadable" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main([])


def test_committed_artifacts_lint_clean_as_the_reference(capsys,
                                                         monkeypatch):
    """With the benchmark model's scope frontier and sites (the port's
    copy of its configuration, built on the CPU): clean, exit 0, and the
    reference CLI's lines."""
    monkeypatch.chdir(ROOT)
    assert main(["artifacts"]) == 0
    out = capsys.readouterr().out
    assert "artifacts/bench_model.json: clean\n" in out
    assert "structural checks only" not in out
    assert jmain(["artifacts"]) == 0
    assert capsys.readouterr().out == out


def test_bench_model_context_equals_the_reference():
    """The model-aware half of the CLI: the port's bench model has the
    reference's scope frontier."""
    from repro.analysis.lint import _bench_model_context as jctx
    from repro_torch.analysis.lint import _bench_model_context as tctx
    tpaths, tindex = tctx()
    jpaths, jindex = jctx()
    assert tpaths == jpaths
    assert {s.scope for s in tindex.sites} == {s.scope for s in jindex.sites}
