"""The port's training stack (``repro_torch.train``, ``repro_torch.optim``)
held to the reference package's: the cases of ``tests/test_trainer.py`` run
in both packages on the same parameters (drawn with numpy, carried over
by ``params_from_jax``) and the same numpy batch, plus the
hot-swap train step's contract on the CPU.

Tolerances. One step's loss, gradient norm and parameters agree to
``rtol 1e-5`` (parameters ``atol 1e-5``, as the reference's own
grad-accumulation case holds them; float32; XLA contracts the AdamW update's multiply-adds into
fmas, PyTorch rounds each product, ROADMAP Queue C 3). Longer runs are held
to the reference's trajectory at ``rtol 1e-3`` on the loss: AdamW divides by
``sqrt(v)``, so a last-bit difference in a small gradient can move a
parameter by up to the learning rate, and the losses drift apart slowly
(``rtol 1e-2`` under int8 compression, whose 127-step grid turns a last-bit
difference into a whole step). Under bf16 parameters a gradient a few ulps
from zero can change sign, and AdamW's first step then moves that master
weight by ``2 lr``: fewer than 1 % of the weights may differ by more than
``1e-4``, none by more than ``2 lr``.
A truncated step is held to the reference's under a fine format
(``e8m16``); under a coarse one each package rounds after its own
backward formulas (``test_torch_grad_scopes.py``), so only the direction
of the effect is compared.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core import TruncationPolicy as JPolicy
from repro.models import Model as JModel
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import warmup_cosine as j_warmup_cosine
from repro.train import trainer as jtrainer

from repro_torch.configs.base import ArchConfig
from repro_torch.core import TruncationPolicy
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import tree as T
from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
from test_torch_families import numpy_params
from repro_torch.train import (
    TrainConfig, init_opt_state, make_hotswap_train_step, make_train_step,
)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64, dtype="float32", remat=False)


def models(**over):
    cfg = dict(TINY, **over)
    return JModel(JArchConfig(**cfg)), Model(ArchConfig(**cfg))


def both_params(jm, tm, seed):
    """The same parameters for both packages, drawn with numpy from
    ``seed`` as the definitions ask (``test_torch_families.numpy_params``)."""
    tree = numpy_params(tm.param_defs(), seed)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.dtype(jm.cfg.dtype)), tree)
    return jp, params_from_jax(tree, tm.cfg, "cpu")


def fixed_batch(vocab, B=4, S=16, seed=0):
    r = np.random.RandomState(seed)
    toks = r.randint(0, vocab, (B, S + 1))
    nb = {"tokens": toks[:, :-1].astype(np.int32),
          "labels": toks[:, 1:].astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def run_both(tc_kw, steps, seed, B=4, jtc_kw=None, ref=True, **over):
    """Losses of ``steps`` steps in both packages (the port's alone with
    ``ref=False``), and the final states."""
    jm, tm = models(**over)
    jp, tp = both_params(jm, tm, seed)
    jb, tb = fixed_batch(jm.cfg.vocab, B)
    opt_kw = tc_kw.pop("optimizer", {})
    jtc = jtrainer.TrainConfig(optimizer=JAdamWConfig(**opt_kw),
                               **(jtc_kw if jtc_kw is not None else tc_kw))
    ttc = TrainConfig(optimizer=AdamWConfig(**opt_kw), **tc_kw)
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    tstep = make_train_step(tm, ttc)
    jo = jtrainer.init_opt_state(jm, jp, jtc)
    to = init_opt_state(tm, tp, ttc, device="cpu")
    jl, tl = [], []
    jmet = None
    for i in range(steps):
        if ref:
            jp, jo, jmet = jstep(jp, jo, jb, jnp.int32(i))
            jl.append(float(jmet["loss"]))
        tp, to, tmet = tstep(tp, to, tb, i)
        tl.append(float(tmet["loss"]))
    return np.array(jl), np.array(tl), (jp, jo, jmet), (tp, to, tmet)


def assert_trees_close(j, t, rtol, atol=0.0):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(j)]
    tl = [x.detach().float().numpy() for x in T.leaves(t)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a.astype(np.float32), rtol=rtol,
                                   atol=atol)


def test_loss_decreases():
    jl, tl, _, _ = run_both(
        {"optimizer": dict(lr=1e-2, weight_decay=0.0)}, 30, seed=0)
    assert tl[-1] < tl[0] * 0.7, tl[::10]
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl[:3], jl[:3], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_one_step_equals_the_reference():
    """Loss, gradient norm, parameters and AdamW state after one step, and
    the metrics the reference returns."""
    _, _, (jp, jo, jm_), (tp, to, tm_) = run_both(
        {"optimizer": dict(lr=1e-3)}, 1, seed=1)
    assert set(tm_) == set(jm_)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5)
    assert not bool(tm_["nonfinite"])
    assert_trees_close(jp, tp, rtol=0, atol=1e-5)
    assert_trees_close(jo["m"], to["m"], rtol=1e-4, atol=1e-8)
    assert int(to["step"]) == int(jo["step"]) == 1


def test_grad_accum_equivalence():
    """accum=4 on a 4x batch == accum=1 (the reference's case, there marked
    slow), in the port, and against the reference's accumulated step."""
    jm, tm = models()
    jp, tp = both_params(jm, tm, 1)
    jb, tb = fixed_batch(jm.cfg.vocab, B=8)
    out = {}
    for accum in (1, 4):
        ttc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), grad_accum=accum)
        out[accum] = make_train_step(tm, ttc)(
            tp, init_opt_state(tm, tp, ttc, device="cpu"), tb, 0)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    for a, b in zip(T.leaves(p1), T.leaves(p4)):
        assert float((a - b).abs().max()) < 1e-5
    jtc = jtrainer.TrainConfig(optimizer=JAdamWConfig(lr=1e-3), grad_accum=4)
    jp4, _, jm4 = jax.jit(jtrainer.make_train_step(jm, jtc))(
        jp, jtrainer.init_opt_state(jm, jp, jtc), jb, jnp.int32(0))
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]),
                               rtol=1e-5)
    assert_trees_close(jp4, p4, rtol=0, atol=1e-5)


def test_mrope_positions_split_on_their_batch_axis():
    """Under accumulation the (3, B, S) M-RoPE positions are sliced on
    axis 1, every other batch entry on axis 0 (the reference's
    ``_split_micro_fn``)."""
    from repro_torch.train.trainer import _split_micro_fn
    batch = {"embeds": torch.arange(4 * 2 * 3).reshape(4, 2, 3),
             "positions": torch.arange(3 * 4 * 2).reshape(3, 4, 2)}
    got = _split_micro_fn(2)(batch, 1)
    assert torch.equal(got["embeds"], batch["embeds"][2:4])
    assert torch.equal(got["positions"], batch["positions"][:, 2:4])
    jgot = jtrainer._split_micro_fn(2)(
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 1)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]))


def test_truncated_training_runs_and_hurts_at_4bit():
    """Paper Fig. 7 in miniature (the reference's case, there marked slow):
    a 4-bit-mantissa train step degrades the loss trajectory against f32,
    an e8m16 step tracks it; the f32 and e8m16 runs equal the reference's
    (whose own ordering ``tests/test_trainer.py`` checks)."""
    def run(policy, steps=15, ref=True):
        jpol = None if policy is None else JPolicy.everywhere(policy)
        tpol = None if policy is None else TruncationPolicy.everywhere(policy)
        jl, tl, _, _ = run_both(
            {"optimizer": dict(lr=1e-2, weight_decay=0.0), "policy": tpol,
             "policy_impl": "ref"}, steps, seed=2,
            jtc_kw={"policy": jpol, "policy_impl": "ref"}, ref=ref)
        return jl[-1] if ref else None, tl[-1]

    jfull, tfull = run(None)
    jfine, tfine = run("e8m16")
    _, tcoarse = run("e8m4", ref=False)
    assert abs(tfine - tfull) < abs(tcoarse - tfull) + 1e-6
    assert np.isfinite(tcoarse)
    np.testing.assert_allclose(tfine, jfine, rtol=1e-3)
    np.testing.assert_allclose(tfull, jfull, rtol=1e-3)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_grad_compression_trains(kind):
    """bf16 (error feedback: the buffer carries residuals) and int8
    compression train as in the reference."""
    jl, tl, (_, jo, _), (_, to, _) = run_both(
        {"optimizer": dict(lr=1e-2, weight_decay=0.0),
         "grad_compression": kind}, 30, seed=3 if kind == "bf16" else 4)
    assert "err" in to
    assert tl[-1] < tl[0] * (0.7 if kind == "bf16" else 0.8)
    nz = sum(int((e != 0).sum()) for e in T.leaves(to["err"]))
    assert nz > 0
    np.testing.assert_allclose(tl[:3], jl[:3], rtol=1e-4)
    # int8: a last-bit difference can move a value across a rounding
    # boundary of the 127-step grid
    np.testing.assert_allclose(tl, jl, rtol=2e-3 if kind == "bf16" else 1e-2)


def test_warmup_cosine_schedule():
    steps = (0, 5, 10, 50, 100)
    lrs = [float(warmup_cosine(torch.tensor(s, dtype=torch.int32),
                               peak_lr=1.0, warmup=10, total=100))
           for s in steps]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0, abs=0.01)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=0.01)
    ref = [float(j_warmup_cosine(jnp.int32(s), peak_lr=1.0, warmup=10,
                                 total=100)) for s in steps]
    np.testing.assert_allclose(lrs, ref, rtol=1e-6, atol=1e-7)


def test_bf16_params_master_copy():
    _, _, (jp, jo, jm_), (tp, to, tm_) = run_both(
        {"optimizer": dict(lr=1e-2)}, 1, seed=5, n_layers=1, n_kv_heads=4,
        dtype="bfloat16")
    masters = [m for m in T.leaves(to["master"]) if m is not None]
    assert masters and all(m.dtype == torch.float32 for m in masters)
    assert all(p.dtype == torch.bfloat16 for p in T.leaves(tp))
    assert bool(torch.isfinite(tm_["loss"]))
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                               rtol=1e-2)
    # bf16 gradients: where one is a few ulps from zero its sign can differ
    # between the packages, and AdamW's first step moves the master copy by
    # +-lr whatever the gradient's size
    for a, b in zip(jax.tree_util.tree_leaves(jo["master"]),
                    [m for m in T.leaves(to["master"]) if m is not None]):
        d = np.abs(b.numpy() - np.asarray(a))
        assert d.max() <= 2 * 1e-2 + 1e-4
        assert (d > 1e-4).mean() < 0.01


def test_hotswap_step_is_the_static_step_bit_for_bit():
    """The contract of the reference's
    ``tests/test_artifacts.py::test_hotswap_train_step_zero_recompile``:
    one enumeration of the differentiated loss; each table swap is a new
    value (``n_traces`` stays 1), and every step's loss and parameters
    equal the statically truncated step's under the same policy, bit for
    bit."""
    _, tm = models()
    _, tp = both_params(*models(), 6)
    _, tb = fixed_batch(tm.cfg.vocab)
    pol_a = TruncationPolicy.scoped("layer/mlp", "e5m7")
    pol_b = TruncationPolicy.scoped("layer/attn/**", "e8m3")
    site = TruncationPolicy(rules=pol_a.rules + pol_b.rules)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    hot, sites = make_hotswap_train_step(tm, tc, site, tp, tb)
    assert hot.sweep.n_traces == 1
    back = [s for s in sites.sites if "#grad" in str(s)] or sites.sites
    assert len(sites) > 0 and back
    ph, oh = tp, init_opt_state(tm, tp, tc, device="cpu")
    ps, os_ = tp, init_opt_state(tm, tp, tc, device="cpu")
    for i, pol in enumerate((pol_a, pol_b, pol_a)):
        table = hot.device_table(sites.table_for(pol))
        ph, oh, mh = hot(ph, oh, tb, i, table)
        static = make_train_step(
            tm, TrainConfig(optimizer=AdamWConfig(lr=1e-3), policy=pol))
        ps, os_, ms = static(ps, os_, tb, i)
        assert mh["loss"].view(torch.int32) == ms["loss"].view(torch.int32)
        for a, b in zip(T.leaves(ph), T.leaves(ps)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert hot.sweep.n_traces == 1
    plain = make_train_step(tm, tc)(tp, init_opt_state(tm, tp, tc,
                                                       device="cpu"), tb, 0)
    first = hot(tp, init_opt_state(tm, tp, tc, device="cpu"), tb, 0,
                hot.device_table(sites.table_for(pol_a)))
    assert float(first[2]["loss"]) != float(plain[2]["loss"]) or not \
        torch.equal(T.leaves(first[0])[0], T.leaves(plain[0])[0])


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    _, tm = models()
    _, tp = both_params(*models(), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_opt_state(tm, tp, TrainConfig())
    # distribution is ported: ``grad_shardings`` are accepted as the
    # reference's are (their placement: test_torch_spmd.py and
    # test_torch_checkpoint_ft.py::test_elastic_reshard)
    assert callable(make_train_step(tm, TrainConfig(), grad_shardings={}))
