"""The five families left by ``test_torch_sharded_params.py`` on a mesh:
qwen2-vl-7b (M-RoPE, QKV biases), deepseek-v2-236b (MLA, a dense lead
layer, shared experts beside the routed ones), seamless-m4t-large-v2 (the
encoder, the cross-attention memory and its caches), rwkv6-7b (the WKV
recurrence) and hymba-1.5b (the Mamba scan, global layers, heads the model
axis does not divide); then the shadow lane of a sharded ``Engine``,
``truncate(native_fp8=True)`` on DTensor operands, and the examples.

As in ``test_torch_sharded_params.py``, jobs of two gloo ranks
(``torch.multiprocessing``, a ``FileStore`` under the test's temporary
directory), two a mesh, (data, model) = (2, 1) and (1, 2), run the f32 smoke
configurations on numpy-drawn parameters placed by ``Model.place_params``
(the batch laid out over the data axis by ``sharding.place_batch``); each
rank writes what it computed and the tests compare it with one process's
unsharded run of the same code:

  * every leaf's local shape is ``param_pspec``'s (the reference's
    ``_resolve``, the divisibility guard's drops included) under both rule
    sets, every split leaf halved;
  * logits, loss and every gradient equal the unsharded port's to rtol
    1e-5;
  * the sites of the differentiated loss (forward and backward frames),
    with ``remat`` on and off, are the unsharded ones, key for key;
  * three AdamW steps (plain, under a policy, hot-swapped) as the unsharded
    steps, within ``APART``;
  * ``Engine`` on (1, 2) serves the one-rank engine's tokens, its cache laid
    out leaf by leaf as the reference's ``_CACHE_AXES_BY_KEY`` says.

The recurrences of RWKV-6 and Mamba run on each rank's pieces
(``sharding.on_shards``) where those issue the global run's ops; where a
piece of one would not (rwkv6's two smoke heads on a model axis of two, a
batch of one a rank), they run on the DTensors. Both routes are taken here,
and ``test_on_shards_runs_the_scans_on_pieces`` holds the pieces' route at
shapes where every piece has more than one head and one row.

The unsharded side is the reference's on these parameters: the files of
each family (``test_torch_families.py``, ``test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_encdec.py``, ``test_torch_decode.py``)
hold the port to it on the same numpy rule and seed, and
``test_unsharded_forward_is_the_references`` does it here on these inputs.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core import (
    E4M3, TruncationPolicy, TruncationRule, parse_format, truncate,
    truncate_sweep,
)
from repro_torch.distributed import sharding as shd
from repro_torch.models import Model
from repro_torch.models.common import map_defs
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import tree as T
from repro_torch.train import (
    TrainConfig, init_opt_state, make_hotswap_train_step, make_train_step,
)
from repro_torch.train.trainer import value_and_grad
from test_torch_sharded_params import close, close_params, numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ("qwen2-vl-7b", "deepseek-v2-236b", "seamless-m4t-large-v2",
         "rwkv6-7b", "hymba-1.5b")
MESHES = ((2, 1), (1, 2))
# the families of each of a mesh's two jobs (the second also runs the drift
# scenario and the fp8 case on (1, 2))
GROUPS = (("qwen2-vl-7b", "deepseek-v2-236b", "rwkv6-7b"),
          ("seamless-m4t-large-v2", "hymba-1.5b"))
# a batch of four: two rows a rank on the data axis
B, S = 4, 16
# each family's feed-forward products at e5m7. Products only: a sum split
# over the ranks (a row-parallel product on (1, 2), a weight's gradient
# over the batch rows on (2, 1)) runs in another order, so a value within
# an f32 ulp of an e5m7 midpoint may round the other way, and where every
# elementwise op after it rounds too, that flip reaches every rounding
# downstream (through seamless's cross-attention memory into the encoder):
# the steps then part by more than ``APART`` allows on these small models
POLICY = TruncationPolicy(rules=tuple(
    TruncationRule(fmt=parse_format("e5m7"), scope=s, ops=("dot_general",))
    for s in ("**/mlp", "**/moe/experts", "**/channel_mix")))
SITES = TruncationPolicy.everywhere("e8m3")
STEPS = 3
# the train steps each family takes on each mesh: every kind of step on
# each mesh, and each family both kinds of truncated step
KINDS = {(2, 1): {"qwen2-vl-7b": "plain", "deepseek-v2-236b": "policy",
                  "seamless-m4t-large-v2": "hotswap", "rwkv6-7b": "policy",
                  "hymba-1.5b": "hotswap"},
         (1, 2): {"qwen2-vl-7b": "hotswap", "deepseek-v2-236b": "hotswap",
                  "seamless-m4t-large-v2": "policy", "rwkv6-7b": "hotswap",
                  "hymba-1.5b": "policy"}}
RTOL = 1e-5
# the e4m3 dot-input rule of the native fp8 path, on the MLP's products
FP8 = TruncationPolicy(rules=(TruncationRule(
    fmt=E4M3, scope="**/mlp", ops=("dot_general",),
    quantize_dot_inputs=True),))
FP8_DOT = TruncationPolicy(rules=(TruncationRule(
    fmt=E4M3, ops=("dot_general",), quantize_dot_inputs=True),))
# ``test_torch_serving.py``'s model and drift scenario
LM = dict(name="srv", family="dense", n_layers=2, d_model=48, n_heads=4,
          n_kv_heads=2, head_dim=12, d_ff=96, vocab=64, dtype="float32",
          remat=False, scan_layers=False)


def make_batch(cfg, seed=1):
    """``test_torch_families.make_batch``'s batch: tokens, frame embeddings
    (the encoder-decoder) or patch embeddings with three different M-RoPE
    streams."""
    r = np.random.RandomState(seed)
    toks = r.randint(0, cfg.vocab, (B, S + 1))
    nb = {"labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "encdec":
        nb["src_embeds"] = r.randn(B, S, cfg.d_model).astype(np.float32)
        nb["tokens"] = toks[:, :-1].astype(np.int32)
    elif cfg.input_mode == "embeds":
        nb["embeds"] = r.randn(B, S, cfg.d_model).astype(np.float32)
        s = np.arange(S)
        nb["positions"] = np.stack([np.broadcast_to(v, (B, S)) for v in (
            s, s // 4, (s * 7) % 5)]).astype(np.int32)
    else:
        nb["tokens"] = toks[:, :-1].astype(np.int32)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in nb.items()}


def inputs(arch):
    """(model, params, batch) of ``arch``'s smoke configuration."""
    cfg = get_config(arch, "smoke")
    return (Model(cfg), params_from_jax(numpy_tree(cfg), cfg, "cpu"),
            make_batch(cfg))


def whole(tree):
    return T.tree_map(lambda t: shd.gather(t).detach().clone(), tree)


def run_model(model, params, batch, kinds, mesh=None):
    """What a rank (or one process) computes of one family: logits, the
    loss and its gradients, the sites of the differentiated loss with
    ``remat`` on and off, and three train steps of each of ``kinds``."""
    out = {}
    if mesh is not None:
        params = model.place_params(params, mesh)
        batch = shd.place_batch(batch, mesh)
    out["logits"] = whole(model.forward(params, batch))
    out["loss"], out["grads"] = whole(value_and_grad(model.loss)(params,
                                                                 batch))
    for remat in (True, False):
        m = Model(model.cfg.replace(remat=remat))
        h = truncate_sweep(value_and_grad(m.loss), SITES)(params, batch)
        out[f"sites/{remat}"] = [(s.scope, s.prim, str(s.dtype))
                                 for s in h.sites]
        out[f"keys/{remat}"] = h.index.site_keys()
    tc = TrainConfig()
    for kind in kinds:
        extra = ()
        if kind == "hotswap":
            step_fn, index = make_hotswap_train_step(model, tc, POLICY,
                                                     params, batch)
            extra = (step_fn.device_table(index.table_for(POLICY)),)
        else:
            step_fn = make_train_step(model, TrainConfig(
                policy=POLICY if kind == "policy" else None))
        p, opt = params, init_opt_state(model, params, tc, device="cpu")
        losses = []
        for i in range(STEPS):
            p, opt, metrics = step_fn(p, opt, batch, i, *extra)
            losses.append(float(metrics["loss"]))
        out[f"train/{kind}/losses"] = losses
        out[f"train/{kind}/params"] = whole(p)
    return out


def prompts(vocab, n=4, seed=3):
    r = np.random.RandomState(seed)
    return [r.randint(1, vocab, int(r.randint(1, 6))) for _ in range(n)]


def run_engine(model, params, mesh=None):
    """4 ragged requests through a 4-slot engine (on ``mesh``: under
    ``SERVE_PARAM_RULES``); the tokens, and each cache leaf's local shape
    and type."""
    from repro_torch.serving import Engine
    if mesh is not None:
        params = model.place_params(params, mesh, shd.SERVE_PARAM_RULES)
    eng = Engine(model, params, batch_size=4, max_seq_len=32)
    reqs = [eng.submit(p, max_new_tokens=4)
            for p in prompts(model.cfg.vocab)]
    eng.run()
    return {"tokens": [r.out_tokens for r in reqs],
            "cache": [(tuple(shd.local_parts(t)[0].shape), type(t).__name__)
                      for t in torch.utils._pytree.tree_leaves(eng.cache)]}


def drift_scenario(tree, mesh=None):
    """``test_torch_serving``'s drift scenario (the reference's
    initialisation of its 2-layer model, an e8m10 MLP artifact accepted at
    0.1, every request shadowed) on one rank or on ``mesh``: the events'
    (tick, peak, top blame) and the served tokens, with the shadow lane and
    without it."""
    from repro_torch.artifacts import PolicyArtifact
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serving import Engine, ShadowConfig
    model = Model(ArchConfig(**LM))
    params = params_from_jax(tree, model.cfg, "cpu")
    if mesh is not None:
        params = model.place_params(params, mesh, shd.SERVE_PARAM_RULES)
    r = np.random.RandomState(0)
    work = [(r.randint(1, LM["vocab"], n).astype(np.int32), m)
            for n, m in ((3, 4), (7, 6))]
    out = {}
    for shadowed in (True, False):
        art = PolicyArtifact(name="stable", policy=TruncationPolicy.scoped(
            "**/mlp", "e8m10"), provenance={"threshold": 1e-1})
        events = []
        shadow = (ShadowConfig(rate=1.0, threshold=1e-3, min_shadow_ticks=2,
                               on_drift=events.append) if shadowed else None)
        eng = Engine(model, params, batch_size=2, max_seq_len=32, policy=art,
                     shadow=shadow)
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in work]
        eng.run()
        out[shadowed] = {
            "tokens": [q.out_tokens for q in reqs],
            "events": [(e.tick, e.peak, e.blame[0][0]) for e in events]}
    return out


def fp8_case(mesh=None):
    """``truncate(native_fp8=True, impl='ref')`` on h2o-danube-1.8b's smoke
    MLP and on two products (column-parallel: the weight's columns over
    ``model``; row-parallel: its rows), native and emulated."""
    from test_torch_sharded_params import inputs as dense_inputs
    model, params, batch = dense_inputs("h2o-danube-1.8b")
    r = np.random.RandomState(5)
    x = torch.from_numpy(r.randn(8, 64).astype(np.float32))
    w = torch.from_numpy(r.randn(64, 32).astype(np.float32))
    col = row = (x, w)
    if mesh is not None:
        params = model.place_params(params, mesh)
        batch = shd.place_batch(batch, mesh)
        col = (x, shd.place(w, shd.NamedSharding(mesh, shd.P(None,
                                                             "model"))))
        row = (shd.place(x, shd.NamedSharding(mesh, shd.P(None, "model"))),
               shd.place(w, shd.NamedSharding(mesh, shd.P("model"))))
    out = {}
    for native in (True, False):
        out[f"loss/{native}"] = float(shd.gather(truncate(
            model.loss, FP8, native_fp8=native, impl="ref")(params, batch)))
        for name, args in (("col", col), ("row", row)):
            out[f"{name}/{native}"] = shd.gather(truncate(
                lambda a, b: a @ b, FP8_DOT, native_fp8=native,
                impl="ref")(*args))
    return out


def _job(rank, world, store, out_dir, shape, group, drift_tree):
    t0 = time.perf_counter()
    torch.set_num_threads(1)        # several jobs share the cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import device_mesh
        res = {}
        mesh = device_mesh(shape, ("data", "model"), device="cpu")
        for arch in GROUPS[group]:
            model, params, batch = inputs(arch)
            for rules in ("DEFAULT", "SERVE"):
                placed = model.place_params(
                    params, mesh, getattr(shd, f"{rules}_PARAM_RULES"))
                res[("local", arch, rules)] = [
                    (tuple(shd.local_parts(t)[0].shape), type(t).__name__)
                    for t in T.leaves(placed)]
            res[arch] = run_model(model, params, batch,
                                  (KINDS[shape][arch],), mesh)
            if shape == (1, 2):
                res[("engine", arch)] = run_engine(model, params, mesh)
        if shape == (1, 2) and group == 1:
            res["drift"] = drift_scenario(drift_tree, mesh)
            res["fp8"] = fp8_case(mesh)
        res["on_shards"] = dict(shd.ON_SHARDS)
        res["seconds"] = time.perf_counter() - t0
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def reference_init():
    """The reference's initialisation of ``LM`` (``test_torch_serving``'s
    fixture), as numpy arrays."""
    import jax
    from repro.configs.base import ArchConfig as JArchConfig
    from repro.models import Model as JModel
    jp = JModel(JArchConfig(**LM)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


_UNSHARDED = {}


def unsharded(arch):
    """The unsharded port's run of ``arch``: every kind of train step its
    meshes take, and the engine."""
    if arch not in _UNSHARDED:
        model, params, batch = inputs(arch)
        kinds = sorted({KINDS[m][arch] for m in MESHES})
        _UNSHARDED[arch] = run_model(model, params, batch, kinds)
        _UNSHARDED[arch]["engine"] = run_engine(model, params)
    return _UNSHARDED[arch]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two jobs of two ranks per mesh (``GROUPS``), all started together;
    while they run this process computes the unsharded side. ``{mesh:
    [each rank's results]}``."""
    tmp = tmp_path_factory.mktemp("families2")
    tree = reference_init()
    jobs = {}
    for shape in MESHES:
        for group in range(len(GROUPS)):
            d = tmp / ("x".join(map(str, shape)) + f"-{group}")
            d.mkdir()
            jobs[shape, group] = (d, mp.start_processes(
                _job, args=(2, str(d / "store"), str(d), shape, group, tree),
                nprocs=2, join=False, start_method="spawn"))
    for arch in ARCHS:
        unsharded(arch)
    _UNSHARDED["drift"] = drift_scenario(tree)
    _UNSHARDED["fp8"] = fp8_case()
    out = {shape: [{"on_shards": {}} for _ in range(2)] for shape in MESHES}
    for (shape, _), (d, ctx) in jobs.items():
        while not ctx.join():
            pass
        for r in range(2):
            res = torch.load(d / f"rank{r}.pt", weights_only=False)
            runs = out[shape][r]["on_shards"]
            for k, n in res.pop("on_shards").items():
                runs[k] = runs.get(k, 0) + n
            out[shape][r].update(res)
    return out


# ---- placement ---------------------------------------------------------------

@pytest.mark.parametrize("rules", ["DEFAULT", "SERVE"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_follow_param_pspec(two_ranks, arch, shape, rules):
    """Every leaf is a DTensor whose local shard has the shape
    ``param_pspec`` gives it, the reference's ``_resolve`` with its
    divisibility guard (hymba's five heads of 16 are 80 columns, split in
    halves of 40; its one KV head's 16 are too), so every split leaf is
    halved and nothing is gathered whole."""
    import types
    from repro.distributed import sharding as jshd
    defs = T.leaves(map_defs(lambda d: d,
                             Model(get_config(arch, "smoke")).param_defs()))
    axes = {"data": shape[0], "model": shape[1]}
    want = []
    for d in defs:
        spec = shd._resolve(shd.AbstractMesh(axes),
                            getattr(shd, f"{rules}_PARAM_RULES"), d.axes,
                            d.shape)
        ref = jshd._resolve(types.SimpleNamespace(shape=axes),
                            getattr(jshd, f"{rules}_PARAM_RULES"), d.axes,
                            d.shape)
        assert tuple(spec) == tuple(ref), (d, spec, ref)
        local = list(d.shape)
        for i, a in enumerate(spec):
            local[i] //= axes[a] if a else 1
        want.append((tuple(local), "DTensor"))
    assert any(w[0] != tuple(d.shape) for w, d in zip(want, defs)) == (
        rules == "DEFAULT" or shape[1] > 1)
    for res in two_ranks[shape]:
        assert res[("local", arch, rules)] == want


# ---- the forward, the gradients and the sites ----------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_gradients_equal_unsharded(two_ranks, arch, shape):
    """The sharded program is the global one: the unsharded port's logits,
    loss and gradients to rtol 1e-5."""
    want = unsharded(arch)
    for res in two_ranks[shape]:
        got = res[arch]
        close(got["logits"], want["logits"], atol=1e-6)
        close(got["loss"], want["loss"])
        close(got["grads"], want["grads"], atol=1e-7)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_site_lists_per_scope_equal_unsharded(two_ranks, arch, shape, remat):
    """The sites of ``value_and_grad(loss)`` (its forward frames, the
    backward ones, the ``remat`` recomputes) on a mesh are the unsharded
    run's, scope by scope and key for key: the data movement, the scans on
    each rank's pieces and the gathers of uneven heads hold none."""
    want = unsharded(arch)
    for res in two_ranks[shape]:
        assert res[arch][f"sites/{remat}"] == want[f"sites/{remat}"]
        assert res[arch][f"keys/{remat}"] == want[f"keys/{remat}"]


def test_both_routes_of_the_scans_ran(two_ranks):
    """The recurrences ran on the ranks' pieces where those issue the
    global ops (Mamba's channels and batch rows on both meshes, RWKV-6's
    batch rows on (2, 1)) and on the DTensors where a piece of one head
    would not (RWKV-6's two smoke heads on (1, 2), but for the decode
    steps, whose one token views alike)."""
    for shape in MESHES:
        for res in two_ranks[shape]:
            runs = res["on_shards"]
            assert runs.get(("mamba_scan", "shards"), 0) > 0
            assert runs.get(("mamba_scan", "global"), 0) == 0
            if shape == (2, 1):
                assert runs.get(("rwkv6_scan", "shards"), 0) > 0
                assert runs.get(("rwkv6_scan", "global"), 0) == 0
            else:
                assert runs.get(("rwkv6_scan", "global"), 0) > 0


def test_unsharded_forward_is_the_references():
    """The unsharded side of these comparisons is the reference's forward
    and loss on the same inputs (the family tolerance of
    ``test_torch_families``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.models import Model as JModel
    for arch in ARCHS:
        model, _, batch = inputs(arch)
        jm = JModel(jbase.get_config(arch, "smoke"))
        jp = jax.tree_util.tree_map(jnp.asarray, numpy_tree(model.cfg))
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        np.testing.assert_allclose(unsharded(arch)["logits"].numpy(),
                                   np.asarray(jax.jit(jm.forward)(jp, jb)),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(unsharded(arch)["loss"]),
                                   float(jax.jit(jm.loss)(jp, jb)),
                                   rtol=1e-4)


# ---- training and serving ------------------------------------------------------

@pytest.mark.parametrize("shape,arch", [(s, a) for s in MESHES
                                        for a in ARCHS])
def test_train_steps_equal_unsharded(two_ranks, shape, arch):
    """Three AdamW steps on sharded parameters (plain, under the policy, or
    hot-swapped with its table) give the unsharded steps' losses to rtol
    1e-5 and their parameters within ``APART``
    (``test_torch_sharded_params.close_params``)."""
    kind = KINDS[shape][arch]
    want = unsharded(arch)
    for res in two_ranks[shape]:
        got = res[arch]
        np.testing.assert_allclose(got[f"train/{kind}/losses"],
                                   want[f"train/{kind}/losses"], rtol=RTOL)
        if kind == "plain":
            close_params(got[f"train/{kind}/params"],
                         want[f"train/{kind}/params"], kind)
        else:
            close_truncated_steps(got[f"train/{kind}/params"],
                                  want[f"train/{kind}/params"])


def close_truncated_steps(got, want, steps=STEPS, lr=3e-4):
    """Parameters after truncated AdamW steps: each leaf's mean distance
    from the unsharded parameters at most a fiftieth of a step, every
    element within the steps' bound. ``APART``'s share of elements within
    1e-3 relative (``close_params``) is kept for the plain steps: a sum
    split over the ranks (a row-parallel product on (1, 2), a weight's
    gradient over the batch rows on (2, 1)) runs in another order, so a
    product within an f32 ulp of an e5m7 midpoint may round the other way;
    the flip moves the AdamW steps of the elements it reaches by a fraction
    of ``lr`` (up to 1.4 ``lr`` where it turns a gradient near zero around,
    seamless on (1, 2)), which on these small models' zero-initialised
    biases, as large as their steps, is more than 1e-3 of them in up to 20 %
    of a leaf. The mean stays below ``lr / 100`` (seamless's encoder
    ``norm2`` bias, 0.0087 ``lr``)."""
    for g, w in zip(T.leaves(got), T.leaves(want)):
        assert float((g - w).abs().mean()) <= lr / 50
        assert float((g - w).abs().max()) <= 2 * lr * steps


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_a_model_axis_of_two_serves_the_same_tokens(two_ranks,
                                                              arch):
    """``Engine`` on TP parameters (``SERVE_PARAM_RULES`` on (1, 2)) serves
    4 ragged requests with the unsharded engine's tokens; every cache leaf
    is a DTensor laid out as the reference's ``_CACHE_AXES_BY_KEY`` and the
    activation rules say (hymba's one KV head and MLA's latents over
    ``cache_seq``, Mamba's states over ``mlp``, RWKV-6's over ``heads`` and
    ``embed``, seamless's cross memory over ``kv_heads``)."""
    import types
    from repro.distributed import sharding as jshd
    from repro.launch.specs import _CACHE_AXES_BY_KEY
    model = Model(get_config(arch, "smoke"))
    want = unsharded(arch)["engine"]
    cache = model.init_cache(8, 32, device="cpu")
    axes = {"data": 1, "model": 2}
    shapes = []
    flat, _ = torch.utils._pytree.tree_flatten_with_path(cache)
    for path, t in flat:
        key = path[-1].key if hasattr(path[-1], "key") else path[-2].key
        ax = _CACHE_AXES_BY_KEY.get(key, ("batch",))
        ax = (None,) * (t.ndim - len(ax)) + ax
        spec = jshd._resolve(types.SimpleNamespace(shape=axes),
                             jshd.DEFAULT_ACT_RULES, ax, tuple(t.shape))
        local = list(t.shape)
        for i, a in enumerate(spec):
            local[i] //= axes[a] if a else 1
        shapes.append(tuple(local))
    assert any(s != tuple(t.shape) for s, (_, t) in zip(shapes, flat))
    for res in two_ranks[(1, 2)]:
        got = res[("engine", arch)]
        assert got["tokens"] == want["tokens"]
        assert got["cache"] == [(s, "DTensor") for s in shapes]


def test_shadow_lane_of_a_sharded_engine_fires_at_the_same_tick(two_ranks):
    """``test_torch_serving``'s drift scenario on (1, 2): the shadow lane
    runs ``memtrace`` of the decode tick on gathered inputs, so the event
    comes at the one-rank engine's tick with its peak and blame, and the
    shadowed engine serves the tokens the sharded engine serves without
    it."""
    want = _UNSHARDED["drift"]
    assert len(want[True]["events"]) == 1
    for res in two_ranks[(1, 2)]:
        got = res["drift"]
        (tick, peak, blame), = got[True]["events"]
        w_tick, w_peak, w_blame = want[True]["events"][0]
        assert tick == w_tick and blame == w_blame
        assert peak == pytest.approx(w_peak, rel=1e-6)
        assert got[True]["tokens"] == got[False]["tokens"] \
            == want[False]["tokens"]


# ---- native fp8 on shards ------------------------------------------------------

def test_native_fp8_on_shards(two_ranks):
    """``truncate(native_fp8=True)`` on DTensor operands runs the fp8 dot on
    each rank's pieces (``impl='ref'``, its plain version): a
    column-parallel product is the one-rank product bit for bit; a
    row-parallel one sums f32 partial products before its one rounding, as
    the emulated product on shards does; the model's loss is bit-equal to
    the emulated loss on the same shards and within 1e-3 of one rank's
    native loss."""
    want = _UNSHARDED["fp8"]
    assert want["loss/True"] != float(unsharded("qwen2-vl-7b")["loss"])
    for res in two_ranks[(1, 2)]:
        got = res["fp8"]
        assert got["loss/True"] == got["loss/False"]
        assert got["loss/True"] == pytest.approx(want["loss/True"], rel=1e-3)
        assert torch.equal(got["col/True"], want["col/True"])
        assert torch.equal(got["row/True"], got["row/False"])
        np.testing.assert_allclose(got["row/True"].numpy(),
                                   want["row/True"].numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---- the scans on pieces -------------------------------------------------------

def _pieces_job(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import device_mesh
        res = {}
        for shape in MESHES:
            mesh = device_mesh(shape, ("data", "model"), device="cpu")
            shd.ON_SHARDS.clear()
            res[shape] = (_scans(mesh), dict(shd.ON_SHARDS))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _scans(mesh=None):
    """Both scans through ``on_shards`` on inputs with four batch rows and
    four heads (channels): the outputs, the inputs' gradients, and the
    site keys of the WKV scan under ``truncate_sweep``."""
    from repro_torch.models import ssm
    r = np.random.RandomState(7)

    def t(*shape, scale=1.0):
        return torch.from_numpy((r.randn(*shape) * scale).astype(np.float32))
    wkv = [t(4, 16, 4, 8), t(4, 16, 4, 8), t(4, 16, 4, 8),
           torch.sigmoid(t(4, 16, 4, 8)), t(4, 8), t(4, 4, 8, 8)]
    sel = [torch.nn.functional.softplus(t(4, 16, 8)), t(4, 16, 8),
           t(4, 16, 3), t(4, 16, 3), -torch.exp(t(8, 3)), t(4, 8, 3), t(8)]
    out = {}
    for name, fn, xs, lab, lo, split in (
            ("rwkv6_scan", ssm._wkv_scan, wkv,
             "bshi,bshi,bshi,bshi,hi,bhij", "bshi,bhij", "h"),
            ("mamba_scan", ssm._selective_scan, sel,
             "bsd,bsd,bsn,bsn,dn,bdn,d", "bsd,bdn", "d")):
        if mesh is not None:
            # the rows over ``data``, the heads / channels over ``model``
            xs = [shd.place(x, shd.NamedSharding(mesh, shd.P(*[
                "data" if c == "b" else "model" if c == split else None
                for c in lx]))) for x, lx in zip(xs, lab.split(","))]
        xs = [x.requires_grad_() for x in xs]

        def f(*a):
            return shd.on_shards(name, fn, a, lab, lo,
                                 repeats=("s", ssm._CHUNK))
        ys = f(*xs)
        loss = sum((shd.gather(y) ** 2).sum() for y in ys)
        grads = [shd.gather(g) for g in torch.autograd.grad(loss, xs)]
        keys = truncate_sweep(f, SITES)(*xs).index.site_keys()
        out[name] = ([shd.gather(y).detach() for y in ys], grads, keys)
    return out


def test_on_shards_runs_the_scans_on_pieces(tmp_path):
    """``on_shards`` runs the WKV and the selective scan on each rank's
    batch rows (2, 1) or heads / channels (1, 2) when every piece holds
    more than one: the outputs and the inputs' gradients are the global
    run's (to 1e-5 of each tensor's largest element), and under
    ``truncate_sweep`` its site keys."""
    ctx = mp.start_processes(_pieces_job,
                             args=(2, str(tmp_path / "store"), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    want = _scans()
    while not ctx.join():
        pass
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        for shape in MESHES:
            got, runs = res[shape]
            assert runs.get(("rwkv6_scan", "global"), 0) == 0
            assert runs.get(("mamba_scan", "global"), 0) == 0
            for name in want:
                # within 1e-5 of each tensor's largest element: the
                # gradients of the operands each rank reads whole are sums
                # of the ranks' terms, in another order
                for g, w in zip(got[name][0] + list(got[name][1]),
                                want[name][0] + list(want[name][1])):
                    np.testing.assert_allclose(
                        g.numpy(), w.numpy(), rtol=0,
                        atol=RTOL * float(w.abs().max()))
                assert got[name][2] == want[name][2]


# ---- the examples --------------------------------------------------------------

EXAMPLES = {
    "torch_quickstart.py": (["--batch", "1", "--seq", "16"],
                            ["loss full=", "predicted:",
                             "top numerically-fragile locations:"]),
    "torch_precision_search.py": (["--batch", "1", "--evals", "4"],
                                  ["baseline loss", "per-scope assignment",
                                   "final policy loss", "predicted speedup:"]),
    "torch_train_lm.py": (["--steps", "2", "--d-model", "32", "--layers",
                           "1", "--seq", "16", "--batch", "2"],
                          ["arch=glm4-9b", "step     1 loss",
                           "done; checkpoint at"]),
}


def test_examples_run_on_the_cpu_without_jax(tmp_path):
    """The three examples run with ``--device cpu`` (at small sizes) in
    processes where importing ``jax`` or ``repro`` fails, and print what
    their JAX twins print."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for name, (args, _) in EXAMPLES.items():
        argv = ["--device", "cpu"] + args
        if name == "torch_train_lm.py":
            argv += ["--ckpt-dir", str(tmp_path / "ck")]
        code = ("import runpy, sys; sys.modules['jax'] = None; "
                "sys.modules['repro'] = None; "
                f"sys.argv = [{name!r}] + {argv!r}; "
                f"runpy.run_path({os.path.join(ROOT, 'examples', name)!r}, "
                "run_name='__main__')")
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        text, _ = p.communicate(timeout=300)
        assert p.returncode == 0, text[-3000:]
        for line in EXAMPLES[name][1]:
            assert line in text, (name, line, text[-2000:])
