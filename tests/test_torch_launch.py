"""The port's launch tooling against the reference's ``tests/test_launch.py``:
the abstract input / parameter / cache factories (``launch.specs``, meta
tensors), the cell list, the roofline arithmetic at the H100's rates, ZeRO-1
state, the entry points, and one dry-run cell computed on meta tensors."""
import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax

from repro.configs.base import ARCH_IDS as JARCH_IDS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cells as jcells
from repro.configs.base import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.launch import roofline as jroofline
from repro.launch import specs as jsp
from repro.models import Model as JModel
from repro.models.common import ParamDef as JParamDef

from repro_torch.configs.base import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.core import speedup
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline
from repro_torch.launch import specs as sp
from repro_torch.models import Model
from repro_torch.models.common import ParamDef

POD = {"data": 16, "model": 16}


def _leaves(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def test_input_specs_no_mesh():
    cfg = get_config("glm4-9b")
    batch = sp.input_specs(cfg, SHAPES["train_4k"], None)
    want = jsp.input_specs(jget_config("glm4-9b"), JSHAPES["train_4k"], None)
    assert batch["tokens"].shape == (256, 4096)
    assert batch["labels"].dtype == torch.int32
    assert batch["tokens"].device.type == "meta"
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_input_specs_stub_frontends(arch):
    got = sp.input_specs(get_config(arch), SHAPES["train_4k"], None)
    want = jsp.input_specs(jget_config(arch), JSHAPES["train_4k"], None)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_specs_totals(arch):
    """Meta parameters of the full configuration: every leaf abstract, in
    ``cfg.dtype``, their total ``n_params()`` and the reference's; on the
    single-pod mesh each leaf's spec is the reference's resolution."""
    model = Model(get_config(arch))
    leaves = _leaves(sp.params_specs(model, None))
    assert all(t.device.type == "meta" for t in leaves)
    total = sum(t.numel() for t in leaves)
    jmodel = JModel(jget_config(arch))
    jleaves = jax.tree_util.tree_leaves(jsp.params_specs(jmodel, None))
    assert total == model.n_params() == sum(np.prod(l.shape)
                                            for l in jleaves)
    assert _leaves(model.abstract_params())[0].dtype == \
        getattr(torch, model.cfg.dtype)

    mesh = types.SimpleNamespace(shape=POD)
    specs = sp.params_specs(model, shd.AbstractMesh(POD))
    got = {pytree.keystr(p): tuple(sp.sharding_of(t).spec)
           for p, t in pytree.tree_flatten_with_path(specs)[0]}
    want = {jax.tree_util.keystr(p): tuple(jshd._resolve(
                mesh, jshd.DEFAULT_PARAM_RULES, d.axes, d.shape))
            for p, d in jax.tree_util.tree_flatten_with_path(
                jmodel.param_defs(),
                is_leaf=lambda x: isinstance(x, JParamDef))[0]}
    assert got == want


def test_param_axes_are_the_references():
    model = Model(get_config("olmoe-1b-7b"))
    jmodel = JModel(jget_config("olmoe-1b-7b"))
    is_axes = lambda x: isinstance(x, tuple)
    got = {pytree.keystr(p): a for p, a in pytree.tree_flatten_with_path(
        model.param_axes(), is_leaf=is_axes)[0]}
    want = {jax.tree_util.keystr(p): tuple(a) for p, a in
            jax.tree_util.tree_flatten_with_path(jmodel.param_axes(),
                                                 is_leaf=is_axes)[0]}
    assert got == want


def test_cache_specs_shapes():
    model = Model(get_config("deepseek-v2-236b"))
    cache = sp.cache_specs(model, SHAPES["decode_32k"], None)
    m = model.cfg.mla
    # MLA compressed cache: (L-1 scanned, B, S, kv_lora)
    assert cache["layers"]["c_kv"].shape == (59, 128, 32768, m.kv_lora)
    assert cache["lead"][0]["c_kv"].shape == (128, 32768, m.kv_lora)
    # per-slot cursor: one int32 per batch lane (continuous batching)
    assert cache["pos"].shape == (128,)
    # context-parallel: the cache's sequence on the model axis
    cache = sp.cache_specs(model, SHAPES["decode_32k"],
                           shd.AbstractMesh(POD))
    assert tuple(sp.sharding_of(cache["layers"]["c_kv"]).spec) == \
        (None, "data", "model")


def test_cells_skip_rule():
    for arch in ARCH_IDS:
        shapes = dict((s.name, run) for s, run in cells(arch))
        assert shapes == dict((s.name, run) for s, run in jcells(arch))
        assert shapes["train_4k"] and shapes["decode_32k"]
        expect_long = arch in ("hymba-1.5b", "h2o-danube-1.8b", "rwkv6-7b")
        assert shapes["long_500k"] == expect_long, arch
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)


def test_roofline_analyze_at_h100_rates():
    """The reference's arithmetic at the H100's rates (no v5e constant):
    1 s of compute, 0.5 s of HBM traffic, 0.25 s of NVLink."""
    assert roofline.PEAK_FLOPS == speedup.PEAK_BF16_FLOPS == 989e12
    assert roofline.HBM_BW == speedup.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    for tpu in (jroofline.PEAK_FLOPS, jroofline.HBM_BW, jroofline.LINK_BW):
        assert tpu not in (roofline.PEAK_FLOPS, roofline.HBM_BW,
                           roofline.LINK_BW)
    rec = {
        "arch": "x", "shape": "train_4k", "n_devices": 256,
        "jaxpr_flops": 256 * 989e12,          # exactly 1 s compute
        "jaxpr_bytes": 1.0, "jaxpr_bytes_fused": 256 * 3.35e12 * 0.5,
        "model_flops": 256 * 989e12 * 0.7,
        "collectives": {"total_bytes": 450e9 * 0.25},
        "memory": {"argument_bytes": 1e9, "temp_bytes": 2e9},
    }
    row = roofline.analyze(rec)
    assert row["t_compute_s"] == pytest.approx(1.0)
    assert row["t_memory_s"] == pytest.approx(0.5)
    assert row["t_collective_s"] == pytest.approx(0.25)
    assert row["dominant"] == "compute"
    assert row["useful_ratio"] == pytest.approx(0.7)
    assert row["roofline_frac"] == pytest.approx(0.7)
    assert row["hbm_gb_per_dev"] == pytest.approx(3.0)
    # the reference's formulas at its own rates give the same fractions
    jrec = dict(rec, jaxpr_flops=256 * 197e12, model_flops=256 * 197e12 * .7,
                jaxpr_bytes_fused=256 * 819e9 * 0.5,
                collectives={"total_bytes": 50e9 * 0.25})
    jrow = jroofline.analyze(jrec)
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
              "useful_ratio", "roofline_frac"):
        assert row[k] == pytest.approx(jrow[k]), k


def test_roofline_collective_term_not_measured():
    """A port record has no collective census: the term is not measured
    (``None``, printed so), never 0, and the dominant term is taken over the
    measured ones."""
    rec = {"arch": "x", "shape": "decode_32k", "n_devices": 256,
           "jaxpr_flops": 256 * 989e12 * 0.1,
           "jaxpr_bytes": 256 * 3.35e12 * 0.3, "model_flops": 1.0,
           "memory": {"argument_bytes": 5e9, "temp_bytes": None}}
    row = roofline.analyze(rec)
    assert row["t_collective_s"] is None and row["dominant"] == "memory"
    assert "not measured" in roofline.table([row])


def test_zero1_spec_shards_state():
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    pd = ParamDef((8, 64, 32), ("layers", "embed", "mlp"))
    base = shd._resolve(mesh, shd.SERVE_PARAM_RULES, pd.axes, pd.shape)
    # TP-only: embed not sharded, mlp on model
    assert tuple(base) == tuple(jshd._resolve(
        mesh, jshd.SERVE_PARAM_RULES, pd.axes, pd.shape)) == \
        (None, None, "model")
    assert tuple(sp._zero1_spec(pd, mesh).spec) == ("data", None, "model")
    model = Model(get_config("h2o-danube-1.8b"))
    st = sp.opt_state_specs(model, shd.AbstractMesh(POD), zero1=True)
    assert set(st) == {"step", "m", "v", "master"}
    per_dev = sp.tree_bytes_per_device(st["m"])
    assert per_dev * 256 == pytest.approx(model.n_params() * 4, rel=0.05)


def test_launch_entrypoints_import():
    import repro_torch.launch.dryrun
    import repro_torch.launch.roofline
    import repro_torch.launch.serve
    import repro_torch.launch.train
    for mod in (repro_torch.launch.train, repro_torch.launch.serve,
                repro_torch.launch.dryrun, repro_torch.launch.roofline):
        assert callable(mod.main)
    from repro_torch.core.policy import parse_policy
    pol = parse_policy("scope:**/mlp=e5m7")
    assert pol.rules[0].fmt.man_bits == 7
    pol2 = parse_policy("32_to_5_14")
    assert pol2.rules[0].from_width == 32


def test_dryrun_cell_on_meta_tensors(tmp_path):
    """One cell computed abstractly: per-device bytes of the parameters,
    the cache and the inputs on the single-pod mesh, the model FLOPs, and
    the counts of one decode step run on meta tensors; no collective census
    (no counterpart), so the roofline reads that term as not measured."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("h2o-danube-1.8b", "decode_32k", False,
                          out_dir=str(tmp_path))
    assert rec["ok"] and rec["n_devices"] == 256
    model = Model(get_config("h2o-danube-1.8b"))
    assert rec["model_flops"] == 2.0 * model.n_active_params() * 128
    assert rec["memory"]["fits"] and rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["by_part"]["params"] < model.n_params() * 2
    assert rec["jaxpr_flops"] > 0 and rec["jaxpr_bytes"] > 0
    assert "collectives" not in rec
    rows = roofline.main(["--dir", str(tmp_path)])
    assert rows[0]["t_collective_s"] is None


def test_dryrun_train_cell_counts_the_train_step(tmp_path, monkeypatch):
    """A train cell counts the whole train step, as the reference's dry-run
    lowers it: value and gradients of the loss and the AdamW update, on
    meta tensors. Its FLOPs stand over the loss forward's by the backward's
    share: 6 N D over 2 N D is 3 without recompute; with ``remat`` the
    layers are recomputed and, inside that, the attention's chunks once
    more (5.26 here). The smoke configuration at ``train_4k``'s shape keeps
    the count to seconds."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, "smoke"))
    rec = dryrun.run_cell("h2o-danube-1.8b", "train_4k", False,
                          out_dir=str(tmp_path))
    assert rec["ok"] and rec["counts_of"] == "train step"
    assert "counts_note" not in rec
    model, _, fn, args, _ = dryrun.abstract_cell(
        "h2o-danube-1.8b", dryrun.SHAPES["train_4k"], False)
    params, _, batch, _ = args
    fwd = dryrun.meta_counts(model.loss, (params, batch))[0]
    assert 4.0 < rec["jaxpr_flops"] / fwd < 6.0
