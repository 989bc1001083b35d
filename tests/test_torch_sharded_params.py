"""Sharded parameters: the port's dense and MoE models on DTensor shards,
against the unsharded port and the reference, as the reference's
``tests/test_distributed.py`` trains olmoe-1b-7b on a (4, 2) mesh.

One job of two gloo ranks (``torch.multiprocessing``, a ``FileStore`` under
the test's temporary directory, no port) runs the f32 smoke configurations
of h2o-danube-1.8b and olmoe-1b-7b on the meshes (data, model) = (2, 1)
(FSDP) and (1, 2) (TP), with the parameters placed by
``Model.place_params`` under ``DEFAULT_PARAM_RULES`` (and
``SERVE_PARAM_RULES`` for the engine) and the batch laid out over the data
axis. Each rank writes what it computed; the tests compare it with one
process's unsharded run of the same code on the same numpy-drawn
parameters:

  * every leaf's local shape is the one ``param_pspec`` gives, under both
    rule sets, and the specs are the reference's ``_resolve``;
  * logits and loss equal the unsharded port's to rtol 1e-5 (and so the
    reference's, at the family tolerance);
  * under ``truncate`` and ``truncate_sweep`` of the loss and of its
    gradients the site lists per scope are the unsharded ones;
  * a row-parallel product of integer-valued inputs, rounded at e5m2, is
    bit-equal to the unsharded one: the partial sums are reduced before the
    rounding (rounding the ranks' terms gives other bits);
  * three steps of ``make_train_step`` (plain and under ``**/mlp`` e5m7)
    and of ``make_hotswap_train_step``: losses and parameters as the
    unsharded steps', AdamW's moments laid out as their parameters;
  * ``Engine`` on (1, 2) serves 4 ragged requests with the unsharded
    engine's tokens;
  * ``launch.train`` on two ranks (the reference's smoke mesh, (1, 2)),
    resumed from its checkpoint, continues as one process's run does.

The reference's (4, 2) olmoe case has a counterpart on four ranks, (2, 2),
under the ``spmd`` marker.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core import (
    TruncationPolicy, TruncationRule, parse_format, truncate, truncate_sweep,
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
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("h2o-danube-1.8b", "olmoe-1b-7b")
MESHES = ((2, 1), (1, 2))
B, S = 2, 16
# the MLP of the dense layers and the experts of the MoE ones at e5m7
POLICY = TruncationPolicy(rules=tuple(
    TruncationRule(fmt=parse_format("e5m7"), scope=s)
    for s in ("**/mlp", "**/moe/experts")))
SITES = TruncationPolicy.everywhere("e8m3")
STEPS = 3
# the train steps each model takes on each mesh in tier 1: the truncated
# steps of each model once on each mesh, the plain ones on the FSDP mesh
# (all of them on four ranks, ``spmd``)
KINDS = {(2, 1): {"h2o-danube-1.8b": ("plain", "policy"),
                  "olmoe-1b-7b": ("plain", "policy")},
         (1, 2): {"h2o-danube-1.8b": ("plain", "hotswap"),
                  "olmoe-1b-7b": ("hotswap",)}}
TRAIN = ["--arch", "h2o-danube-1.8b", "--device", "cpu", "--seq", "16",
         "--global-batch", "4", "--save-every", "2"]
RTOL = 1e-5


def numpy_tree(cfg, seed=0):
    """Parameters drawn with numpy from a seed (``test_torch_families``'
    rule: normal with the def's scale, zeros, ones)."""
    r = np.random.RandomState(seed)

    def draw(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return (r.randn(*d.shape) * d.scale).astype(np.float32)
    return map_defs(draw, Model(cfg).param_defs())


def inputs(arch):
    """(model, params, batch) of ``arch``'s smoke configuration."""
    cfg = get_config(arch, "smoke")
    r = np.random.RandomState(1)
    toks = r.randint(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    return Model(cfg), params_from_jax(numpy_tree(cfg), cfg, "cpu"), batch


def prompts(vocab, n=4, seed=3):
    r = np.random.RandomState(seed)
    return [r.randint(1, vocab, int(r.randint(1, 6))) for _ in range(n)]


def whole(tree):
    """Every leaf's global value, on the CPU."""
    return T.tree_map(lambda t: shd.gather(t).detach().clone(), tree)


def run_model(model, params, batch, kinds, mesh=None):
    """What a rank (or one process, ``mesh=None``) computes of one model:
    logits, the loss and its gradients, the sites of the differentiated
    loss with its value under two tables, and three train steps of each
    of ``kinds``."""
    out = {}
    if mesh is not None:
        params = model.place_params(params, mesh)
        batch = {k: shd.place(v, shd.batch_sharding(mesh))
                 for k, v in batch.items()}
    grad_fn = value_and_grad(model.loss)
    out["logits"] = whole(model.forward(params, batch))
    out["loss"], out["grads"] = whole(grad_fn(params, batch))
    h = truncate_sweep(grad_fn, SITES)(params, batch)
    out["sites"] = [(s.scope, s.prim, str(s.dtype)) for s in h.sites]
    out["keys"] = h.index.site_keys()
    for name, pol in (("e8m3", SITES), ("policy", POLICY)):
        table = h.table(pol)
        out[f"rows/{name}"] = [i for i, row in enumerate(table)
                               if tuple(row) != tuple(h.identity_table()[0])]
        out[f"swept/{name}"] = whole(h(table))
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
        out[f"train/{kind}/moments_as_params"] = all(
            type(m) is type(q) and type(v) is type(q)
            and shd.local_parts(m)[0].shape == shd.local_parts(q)[0].shape
            and shd.local_parts(v)[0].shape == shd.local_parts(q)[0].shape
            for q, m, v in zip(T.leaves(p), T.leaves(opt["m"]),
                               T.leaves(opt["v"])))
        if kind == "hotswap":
            out["hotswap_traces"] = step_fn.sweep.n_traces
    return out


def run_engine(model, params, mesh=None):
    from repro_torch.serving import Engine
    if mesh is not None:
        params = model.place_params(params, mesh, shd.SERVE_PARAM_RULES)
    eng = Engine(model, params, batch_size=4, max_seq_len=32)
    reqs = [eng.submit(p, max_new_tokens=4)
            for p in prompts(model.cfg.vocab)]
    eng.run()
    return [r.out_tokens for r in reqs]


def row_parallel(x, w, mesh=None):
    """``x @ w`` rounded at e5m2; on a mesh ``w``'s rows and ``x``'s
    columns lie over ``model``, so the product is a sum of the ranks'
    partial products."""
    if mesh is not None:
        x = shd.place(x, shd.NamedSharding(mesh, shd.P(None, "model")))
        w = shd.place(w, shd.NamedSharding(mesh, shd.P("model")))
    return shd.gather(truncate(lambda a, b: a @ b,
                               TruncationPolicy.everywhere("e5m2"))(x, w))


def integer_operands():
    """Small integer-valued f32 operands: every partial sum is exact, and
    the first product's terms on rank 0 and rank 1, 9 and 5, round to 8 and
    5 at e5m2, whose rounded sum is 12, where their sum 14 is exact."""
    x = torch.tensor([[3., 3., 1., 4.], [1., 2., 2., 3.]])
    w = torch.tensor([[1., 1.], [2., 1.], [1., 2.], [1., 1.]])
    return x, w


def _job(rank, world, store, out_dir, shape, kinds):
    kinds = kinds[shape]
    t0 = time.perf_counter()
    torch.set_num_threads(1)        # several jobs share the cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import device_mesh
        res = {}
        mesh = device_mesh(shape, ("data", "model"), device="cpu")
        for arch in kinds:
            model, params, batch = inputs(arch)
            for rules in ("DEFAULT", "SERVE"):
                placed = model.place_params(
                    params, mesh, getattr(shd, f"{rules}_PARAM_RULES"))
                res[("local", arch, rules)] = [
                    (tuple(shd.local_parts(t)[0].shape), type(t).__name__)
                    for t in T.leaves(placed)]
            res[arch] = run_model(model, params, batch, kinds[arch], mesh)
            if shape == (1, 2):
                res[("engine", arch)] = run_engine(model, params, mesh)
        if shape == (1, 2):
            res["row_parallel"] = row_parallel(*integer_operands(), mesh)
        else:
            # its own mesh of both ranks, the reference's smoke mesh (1, 2)
            from repro_torch.launch import train
            ck = os.path.join(out_dir, "ck")
            first = train.main(TRAIN + ["--steps", "3", "--ckpt", ck,
                                        "--num-hosts", "2"])
            again = train.main(TRAIN + ["--steps", "5", "--ckpt", ck,
                                        "--num-hosts", "2"])
            res["resume"] = (first["losses"], again["losses"],
                             again["restarts"],
                             whole(again["state"]["params"]))
        res["seconds"] = time.perf_counter() - t0
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, meshes, kinds):
    """One job of ranks per mesh, all started together; while they run,
    this process computes the unsharded side. Returns ``{mesh: [each
    rank's results]}``."""
    jobs = {}
    for shape in meshes:
        d = tmp_path / "x".join(map(str, shape))
        d.mkdir()
        world = shape[0] * shape[1]
        jobs[shape] = (d, world, mp.start_processes(
            _job, args=(world, str(d / "store"), str(d), shape, kinds),
            nprocs=world, join=False, start_method="spawn"))
    for arch in {a for k in kinds.values() for a in k}:
        unsharded(arch)
    if (2, 1) in kinds:
        one_process_resume(tmp_path / "one")
    out = {}
    for shape, (d, world, ctx) in jobs.items():
        while not ctx.join():
            pass
        out[shape] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sharded2"), MESHES, KINDS)


_UNSHARDED = {}


def one_process_resume(tmp_path):
    """One process's ``launch.train``: to step 3, then to step 5 from its
    checkpoint (the losses of both runs, the final parameters)."""
    if "resume" not in _UNSHARDED:
        from repro_torch.launch import train
        ck = str(tmp_path / "ck")
        first = train.main(TRAIN + ["--steps", "3", "--ckpt", ck])
        again = train.main(TRAIN + ["--steps", "5", "--ckpt", ck])
        _UNSHARDED["resume"] = (first["losses"], again["losses"],
                                again["restarts"],
                                whole(again["state"]["params"]))
    return _UNSHARDED["resume"]


def unsharded(arch):
    """The unsharded port's run of ``arch``, every kind of train step."""
    if arch not in _UNSHARDED:
        _UNSHARDED[arch] = run_model(*inputs(arch),
                                     ("plain", "policy", "hotswap"))
    return _UNSHARDED[arch]


def close(got, want, rtol=RTOL, atol=0.0):
    for g, w in zip(T.leaves(got), T.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                   atol=atol)


# ---- placement ---------------------------------------------------------------

@pytest.mark.parametrize("rules", ["DEFAULT", "SERVE"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_follow_param_pspec(two_ranks, arch, shape, rules):
    """Every leaf is a DTensor whose local shard has the shape its spec
    gives: each dimension divided by the size of the mesh axis over which
    ``param_pspec`` lays it; the specs are the reference's ``_resolve``
    (FSDP's ``embed`` over ``data`` under the training rules; nothing over
    ``data`` under the serving ones)."""
    import types
    from repro.distributed import sharding as jshd
    defs = T.leaves(map_defs(lambda d: d,
                             Model(get_config(arch, "smoke")).param_defs()))
    axes = {"data": shape[0], "model": shape[1]}
    want = []
    for d in defs:
        spec = shd.param_pspec(d.shape, d.axes, shd.AbstractMesh(axes)) \
            if rules == "DEFAULT" else shd._resolve(
                shd.AbstractMesh(axes), shd.SERVE_PARAM_RULES, d.axes,
                d.shape)
        ref = jshd._resolve(types.SimpleNamespace(shape=axes),
                            getattr(jshd, f"{rules}_PARAM_RULES"), d.axes,
                            d.shape)
        assert tuple(spec) == tuple(ref), (d, spec, ref)
        local = list(d.shape)
        for i, a in enumerate(spec):
            local[i] //= axes[a] if a else 1
        want.append((tuple(local), "DTensor"))
    split = [w[0] != tuple(d.shape) for w, d in zip(want, defs)]
    assert any(split) == (rules == "DEFAULT" or shape[1] > 1)
    for res in two_ranks[shape]:
        assert res[("local", arch, rules)] == want


# ---- the forward and the gradients ---------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_gradients_equal_unsharded(two_ranks, arch, shape):
    """The sharded program is the global one: the unsharded port's logits,
    loss and gradients to rtol 1e-5 (the row-parallel products and the
    data axis sum in another order), the gradients laid out as their
    parameters."""
    want = unsharded(arch)
    for res in two_ranks[shape]:
        got = res[arch]
        close(got["logits"], want["logits"], atol=1e-6)
        close(got["loss"], want["loss"])
        close(got["grads"], want["grads"], atol=1e-7)


def test_unsharded_forward_is_the_references():
    """The unsharded side of the comparison on these inputs is the
    reference's forward (the family tolerance of ``test_torch_families``),
    so the sharded logits above are the reference's too."""
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


# ---- rounding on a mesh --------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_site_lists_per_scope_equal_unsharded(two_ranks, arch, shape):
    """The sites of the differentiated loss (its backward frames, the
    ``remat`` recomputes, ``shared_body``, ``loop_const``,
    ``zero_cotangents``) on a mesh are the unsharded run's, key for key,
    and so are the rows the two policies (e8m3 everywhere; the MLP and the
    experts at e5m7) match: DTensor's data movement holds none. The swept
    loss and gradients under each are the unsharded ones within one
    rounding of the format, but a few gradient elements (a rounding may
    flip at a midpoint; under e8m3 everywhere, where every sum is rounded,
    the FSDP mesh's gradients are the unsharded ones bit for bit)."""
    want = unsharded(arch)
    for res in two_ranks[shape]:
        got = res[arch]
        assert got["sites"] == want["sites"]
        assert got["keys"] == want["keys"]
        for name, ulp in (("e8m3", 2.0 ** -3), ("policy", 2.0 ** -7)):
            assert got[f"rows/{name}"] == want[f"rows/{name}"]
            assert got[f"rows/{name}"]
            loss, grads = got[f"swept/{name}"]
            np.testing.assert_allclose(float(loss),
                                       float(want[f"swept/{name}"][0]),
                                       rtol=ulp)
            # the gradients: all but a 2 % share of each leaf's elements
            # within one rounding of the format (a subnormal e5m7 one's:
            # 2^-21). The unrounded ops' sums (attention, norms, the batch
            # over the data axis) differ in their last bits, and where the
            # policy rounds such a value at a midpoint it flips; a flip
            # reaches further sums that cancel
            for g, w in zip(T.leaves(grads),
                            T.leaves(want[f"swept/{name}"][1])):
                off = (g - w).abs() > ulp * w.abs() + 2.0 ** -21
                assert float(off.float().mean()) <= 0.02, name


def test_row_parallel_integer_product_is_bit_equal(two_ranks):
    """``x @ w`` with ``w``'s rows over ``model`` is a ``Partial`` value on
    every rank. Rounded after the reduction it is the unsharded rounding
    bit for bit; rounding the ranks' partial products and summing them
    gives other bits on these inputs."""
    x, w = integer_operands()
    want = row_parallel(x, w)
    q = TruncationPolicy.everywhere("e5m2")
    half = x.shape[1] // 2
    terms = [truncate(lambda a, b: a @ b, q)(x[:, i:i + half],
                                             w[i:i + half])
             for i in (0, half)]
    assert not torch.equal(truncate(lambda a, b: a + b, q)(*terms), want)
    for res in two_ranks[(1, 2)]:
        assert torch.equal(res["row_parallel"], want)


# ---- training ----------------------------------------------------------------

# how far apart a leaf's elements may lie after the steps, and what share
# of them: the plain steps' 1e-5, the truncated steps' 1e-3 (the criterion
# of ``test_torch_grad_values``), in a share of at most 1e-3 / 1e-2
APART = {"plain": (RTOL, 1e-3), "policy": (1e-3, 1e-2),
         "hotswap": (1e-3, 1e-2)}


def close_params(got, want, kind, steps=STEPS, lr=3e-4):
    """Parameters after AdamW steps: all but a share of each leaf's
    elements within ``APART[kind]``'s relative distance of the unsharded
    ones, every element within the steps' bound. A step moves an element
    by about ``lr`` whatever the size of its gradient, so where a gradient
    element is within rounding of 0 the sums' order decides its step; under
    a policy a rounding that flips at a midpoint of e5m7 (the sums' order
    again) moves the gradients it reaches by a part in 2^8, and their
    steps by a part of that."""
    rtol, share = APART[kind]
    for g, w in zip(T.leaves(got), T.leaves(want)):
        off = (g - w).abs() > rtol * w.abs() + 1e-7
        assert float(off.float().mean()) <= share, float(off.float().mean())
        assert float((g - w).abs().max()) <= 2 * lr * steps


@pytest.mark.parametrize("shape,arch,kind", [
    (shape, arch, kind) for shape in MESHES
    for arch, kinds in KINDS[shape].items() for kind in kinds])
def test_train_steps_equal_unsharded(two_ranks, shape, arch, kind):
    """Three AdamW steps on sharded parameters (plain, ``make_train_step``
    under the policy, ``make_hotswap_train_step`` with its table) give the
    unsharded steps' losses to rtol 1e-5 and their parameters, with ``m``
    and ``v`` laid out as the parameters; the hot-swap step enumerates
    once."""
    _check_steps(two_ranks[shape], arch, kind)


def _check_steps(ranks, arch, kind):
    want = unsharded(arch)
    for res in ranks:
        got = res[arch]
        np.testing.assert_allclose(got[f"train/{kind}/losses"],
                                   want[f"train/{kind}/losses"], rtol=RTOL)
        close_params(got[f"train/{kind}/params"],
                     want[f"train/{kind}/params"], kind)
        assert got[f"train/{kind}/moments_as_params"]
        if kind == "hotswap":
            assert got["hotswap_traces"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_a_model_axis_of_two_serves_the_same_tokens(two_ranks,
                                                              arch):
    """``Engine`` on TP parameters (``SERVE_PARAM_RULES`` on (1, 2)) and a
    cache laid out over ``kv_heads`` (over ``cache_seq`` where the one KV
    head does not divide) serves 4 ragged requests with the unsharded
    engine's tokens."""
    model, params, _ = inputs(arch)
    want = run_engine(model, params)
    for res in two_ranks[(1, 2)]:
        assert res[("engine", arch)] == want


def test_sharded_launch_train_resumes_as_one_process(two_ranks, tmp_path):
    """``launch.train`` on two ranks trains FSDP x TP on the reference's
    smoke mesh; run to step 3 (a checkpoint at step 2 and at the end), then
    to step 5 from the last one: the losses and the final parameters are
    one process's doing the same."""
    first, again, restarts, want = one_process_resume(tmp_path)
    assert restarts == 0 and sorted(again) == [3, 4]
    for res in two_ranks[(2, 1)]:
        f, a, restarts, params = res["resume"]
        assert restarts == 0
        for got, ref in ((f, first), (a, again)):
            assert sorted(got) == sorted(ref)
            np.testing.assert_allclose([got[k] for k in sorted(got)],
                                       [ref[k] for k in sorted(got)],
                                       rtol=RTOL)
        close_params(params, want, "plain", steps=5)


# ---- the reference's (4, 2) olmoe case: four ranks ----------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("sharded4"), ((2, 2),), {
        (2, 2): {"olmoe-1b-7b": ("plain", "policy", "hotswap")}})[(2, 2)]


@pytest.mark.spmd
def test_olmoe_trains_on_a_2x2_mesh(four_ranks):
    """olmoe-1b-7b on (data, model) = (2, 2), FSDP x TP, as the reference's
    test trains it on (4, 2): the unsharded logits, gradients and sites,
    three steps of each kind whose losses fall and equal the unsharded
    ones, and ``layers.moe.wi`` split over ``model`` (its experts) and
    ``data`` (its ``embed`` axis)."""
    arch = "olmoe-1b-7b"
    want = unsharded(arch)
    defs = T.leaves(map_defs(lambda d: d,
                             Model(get_config(arch, "smoke")).param_defs()))
    i = next(i for i, d in enumerate(defs)
             if d.axes == ("layers", "experts", "embed", "mlp"))
    L, E, D, F = defs[i].shape
    for res in four_ranks:
        got = res[arch]
        close(got["logits"], want["logits"], atol=1e-6)
        close(got["grads"], want["grads"], atol=1e-7)
        assert got["keys"] == want["keys"]
        for kind in ("plain", "policy", "hotswap"):
            _check_steps([res], arch, kind)
            losses = got[f"train/{kind}/losses"]
            assert losses[-1] < losses[0]
        assert res[("local", arch, "DEFAULT")][i][0] == (L, E // 2, D // 2,
                                                         F)
