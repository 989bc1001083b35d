"""The port's checkpointing, data pipeline and single-process fault
tolerance held to the reference's ``tests/test_checkpoint_ft.py`` case by
case (its two mesh cases, ``test_elastic_reshard`` and
``test_best_mesh_shape_elastic``, wait for the distribution port), plus:
the two packages read each other's checkpoints (the same layout and array
names), a bf16 tree survives a round trip bit for bit without ``ml_dtypes``,
and the synthetic and memmap pipelines give the reference's tokens step for
step.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.data import pipeline as jpipe

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import (
    DataConfig, Pipeline, Prefetcher, to_device, write_token_file,
)
from repro_torch.distributed import (
    StragglerMonitor, SupervisorConfig, best_mesh_shape, run_supervised,
)
from repro_torch.optim import tree as T


def tree(seed=0):
    r = np.random.RandomState(seed)
    return {"w": torch.from_numpy(r.randn(4, 4).astype(np.float32)),
            "nested": {"b": torch.from_numpy(r.randn(3).astype(np.float32)),
                       "none": None},
            "step": torch.tensor(7, dtype=torch.int32)}


def assert_tree_equal(a, b):
    fa, fb = T.leaves(a), T.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = tree()
    ck.save(3, t, extra={"data_step": 11})
    out, manifest = ck.restore(t)
    assert_tree_equal(out, t)
    assert out["nested"]["none"] is None
    assert manifest["extra"]["data_step"] == 11
    assert ck.latest_step() == 3


def test_async_save_with_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, tree(1))
    ck.save(2, tree(2))
    ck.wait()
    out, _ = ck.restore(tree(2))
    assert_tree_equal(out, tree(2))


def test_keep_k_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_k=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, tree(s))
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]


def test_latest_pointer_atomic(tmp_path):
    """A stale tmp dir from a 'crashed' save never shadows LATEST."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, tree(5))
    os.makedirs(tmp_path / ".tmp_step_000000009_zombie", exist_ok=True)
    assert ck.latest_step() == 5
    out, _ = ck.restore(tree(5))
    assert_tree_equal(out, tree(5))


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """bf16 leaves go to disk as their uint16 bit patterns (numpy has no
    bfloat16 of its own) and come back bit for bit, NaN payloads and
    subnormals included; the manifest records their dtype."""
    bits = torch.tensor([0x0001, 0x7FC1, 0xFF81, 0x3F80, 0x8000, 0x7F80],
                        dtype=torch.int32).to(torch.int16)
    t = {"p": torch.randn(64, 8).to(torch.bfloat16),
         "odd": bits.view(torch.bfloat16),
         "f32": torch.randn(3)}
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, t, policy_artifact={"name": "a", "version": 2,
                                   "digest": "d" * 64})
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as z:
        assert z["['p']"].dtype == np.uint16
    out, manifest = ck.restore(t)
    assert manifest["dtypes"]["['p']"] == "torch.bfloat16"
    assert manifest["policy_artifact"]["version"] == 2
    for k in t:
        assert out[k].dtype == t[k].dtype
        assert torch.equal(out[k].view(torch.int16) if k != "f32"
                           else out[k], t[k].view(torch.int16)
                           if k != "f32" else t[k])


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same layout and array names: a checkpoint the reference wrote
    restores in the port, and the port's restores in the reference."""
    r = np.random.RandomState(0)
    arrs = {"w": r.randn(4, 4).astype(np.float32),
            "layers": [r.randn(3).astype(np.float32),
                       r.randn(2).astype(np.float32)]}
    jt = jax.tree_util.tree_map(jnp.asarray, arrs)
    tt = T.tree_map(torch.from_numpy, arrs)
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(
        4, jt, extra={"data": {"step": 9}})
    out, manifest = Checkpointer(str(tmp_path / "j")).restore(tt)
    assert_tree_equal(out, tt)
    assert manifest["extra"]["data"]["step"] == 9
    Checkpointer(str(tmp_path / "t"), async_save=False).save(5, tt)
    jout, _ = JCheckpointer(str(tmp_path / "t")).restore(jt)
    for a, b in zip(jax.tree_util.tree_leaves(jout), T.leaves(tt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_supervisor_restarts_on_failure(tmp_path):
    """step_fn dies twice; supervisor restores and completes the run."""
    state = {"restored": 0, "completed": [], "saved_at": 0}
    failures = {8: True, 13: True}

    def step_fn(step):
        if failures.pop(step, None):
            raise RuntimeError("device lost (simulated)")
        state["completed"].append(step)

    def save_fn(step):
        state["saved_at"] = step

    def restore_fn():
        state["restored"] += 1
        return state["saved_at"]

    final, restarts, _ = run_supervised(
        step_fn, save_fn, restore_fn, total_steps=20,
        cfg=SupervisorConfig(save_every=5))
    assert final == 20
    assert restarts == 2
    assert state["restored"] == 3  # initial + 2 failures
    assert 20 in [state["saved_at"]]


def test_straggler_monitor():
    m = StragglerMonitor(straggle_factor=2.0)
    for _ in range(10):
        assert not m.record(1.0)
    assert m.record(5.0)      # 5x median flags
    assert not m.record(1.1)


def test_straggler_monitor_rolling_window_eviction():
    """The window evicts the oldest samples, so the median tracks the
    current regime (the reference's case)."""
    m = StragglerMonitor(straggle_factor=2.0, window=10)
    for _ in range(10):
        m.record(1.0)
    assert len(m._times) == 10
    assert m.record(3.0)
    for _ in range(10):
        m.record(3.0)
    assert len(m._times) == 10
    assert all(t == 3.0 for t in m._times)
    assert not m.record(3.0)
    assert m.record(7.0)


@pytest.mark.parametrize("mode", ["tokens", "embeds", "encdec"])
def test_data_pipeline_resume_determinism(mode):
    cfg = DataConfig(seq_len=16, global_batch=4, vocab=100, d_model=8,
                     input_mode=mode, mrope=mode == "embeds")
    p1 = Pipeline(cfg)
    batches = [p1.next() for _ in range(5)]
    state = p1.state_dict()
    more1 = [p1.next() for _ in range(3)]
    p2 = Pipeline(cfg)
    p2.load_state_dict(state)
    more2 = [p2.next() for _ in range(3)]
    for a, b in zip(more1, more2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    p3 = Pipeline(cfg)
    first = p3.next()
    for k in first:
        np.testing.assert_array_equal(first[k], batches[0][k])
    # the reference's stream, step for step
    jp = jpipe.Pipeline(jpipe.DataConfig(**vars(cfg)))
    for b in batches:
        jb = jp.next()
        assert set(jb) == set(b)
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k])


def test_prefetcher():
    cfg = DataConfig(seq_len=8, global_batch=2, vocab=50)
    pf = Prefetcher(Pipeline(cfg))
    a = pf.next()
    b = pf.next()
    assert a["tokens"].shape == (2, 8)
    assert not np.array_equal(a["tokens"], b["tokens"])
    pf.close()


def test_memmap_pipeline(tmp_path):
    toks = np.arange(10_000, dtype=np.int32) % 97
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, toks)
    cfg = DataConfig(seq_len=16, global_batch=4, vocab=97, kind="memmap",
                     path=path)
    p = Pipeline(cfg)
    jp = jpipe.Pipeline(jpipe.DataConfig(**vars(cfg)))
    for _ in range(3):
        b, jb = p.next(), jp.next()
        assert b["tokens"].shape == (4, 16)
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        np.testing.assert_array_equal(b["tokens"], jb["tokens"])


def test_to_device_needs_the_card_unless_asked_for_the_cpu():
    b = Pipeline(DataConfig(seq_len=8, global_batch=2, vocab=50)).next()
    got = to_device(b, "cpu")
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), b["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            to_device(b)


# --------------------------------------------------------------------------
# launch.train on the CPU
# --------------------------------------------------------------------------

def _train(tmp_path, *extra):
    from repro_torch.launch import train
    return train.main(["--arch", "h2o-danube-1.8b", "--device", "cpu",
                       "--seq", "16", "--global-batch", "2",
                       "--ckpt", str(tmp_path / "ck"), *extra])


def test_launch_train_resumes_from_its_checkpoint(tmp_path):
    """A truncated run to step 2, then the same command to step 4: the
    supervisor restores step 2 (parameters, optimizer state and the data
    cursor, which is the prefetcher's, as in the reference) and trains
    on."""
    pol = ["--policy", "scope:**/mlp=e5m7", "--save-every", "2"]
    first = _train(tmp_path, "--steps", "2", *pol)
    assert first["final_step"] == 2 and sorted(first["losses"]) == [0, 1]
    assert first["step_fn"].grad_fn.n_traces == 1
    saved = json.loads((tmp_path / "ck" / "step_000000002" /
                        "manifest.json").read_text())
    second = _train(tmp_path, "--steps", "4", *pol)
    assert second["final_step"] == 4 and sorted(second["losses"]) == [2, 3]
    assert all(np.isfinite(v) for v in second["losses"].values())
    assert saved["extra"]["data"]["step"] >= 2
    assert saved["treedef"].startswith("(")          # (params, opt)
    assert sorted(os.listdir(tmp_path / "ck"))[-1] == "step_000000004"


def test_launch_train_swaps_artifacts_on_one_enumeration(tmp_path):
    """--policy-artifact trains through runtime tables; --swap-artifact
    deploys a second artifact mid-run as a new table (one enumeration); a
    restart resumes under the artifact the checkpoint recorded, and refuses
    one whose digest changed."""
    from repro_torch.artifacts import PolicyArtifact, Registry
    from repro_torch.core import TruncationPolicy
    reg = Registry(str(tmp_path / "reg"))
    reg.save(PolicyArtifact(name="a", policy=TruncationPolicy.scoped(
        "layer/mlp", "e5m7")))
    reg.save(PolicyArtifact(name="b", policy=TruncationPolicy.scoped(
        "layer/attn/**", "e8m3")))
    args = ["--policy-artifact", "a", "--swap-artifact", "1:b",
            "--registry", str(tmp_path / "reg"), "--save-every", "2"]
    out = _train(tmp_path, "--steps", "2", *args)
    assert out["final_step"] == 2
    assert out["step_fn"].sweep.n_traces == 1
    manifest = json.loads((tmp_path / "ck" / "step_000000002" /
                           "manifest.json").read_text())
    assert manifest["policy_artifact"]["name"] == "b"
    again = _train(tmp_path, "--steps", "3", *args)
    assert again["final_step"] == 3 and again["step_fn"].sweep.n_traces == 1
    # tamper with the recorded digest: the restore refuses
    path = tmp_path / "ck" / "step_000000003" / "manifest.json"
    m = json.loads(path.read_text())
    m["policy_artifact"]["digest"] = "0" * 64
    path.write_text(json.dumps(m))
    with pytest.raises(RuntimeError, match="refusing to resume"):
        _train(tmp_path, "--steps", "4", *args)


def test_launch_train_n_layers_cuts_the_depth(tmp_path):
    """``main(..., n_layers=N)`` trains the configuration at depth N; the
    checkpoint holds N layers' stacked weights."""
    from repro_torch.launch import train
    out = train.main(["--arch", "h2o-danube-1.8b", "--device", "cpu",
                      "--seq", "16", "--global-batch", "2", "--steps", "1",
                      "--ckpt", str(tmp_path / "ck")], n_layers=1)
    assert out["final_step"] == 1
    depths = {leaf.shape[0] for leaf in T.leaves(out["state"]["params"]
                                                 ["layers"])}
    assert depths == {1}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flags,item", [
    (["--guardrails"], "item 2"), (["--inject-fault", "0:1"], "item 2"),
    (["--multi-pod"], "item 5"), (["--num-hosts", "2"], "item 5"),
    (["--coordinator", "localhost:PORT"], "item 5")])
def test_launch_train_flags_not_ported_raise(tmp_path, flags, item):
    """The guardrail flags (item 2) without their prerequisites
    (``--policy-artifact``, resp. ``--guardrails``) exit with the
    reference's message, as ``test_torch_guardrails.py`` checks too. The
    distribution flags (item 5) are ported: ``--multi-pod`` builds the
    512-device production mesh and raises naming the count on one rank;
    ``--num-hosts 2`` without a coordinator joins ``torchrun``'s group,
    whose environment is missing here; ``--coordinator`` starts a process
    group (``tcp://``, a free local port) and trains on it. The launcher
    takes down a group it started."""
    import torch.distributed as dist
    before = dist.is_initialized()
    if item == "item 2":
        with pytest.raises(SystemExit, match="requires"):
            _train(tmp_path, "--steps", "1", *flags)
        return
    if flags == ["--multi-pod"]:
        with pytest.raises(ValueError, match="512 devices requested, 1 "
                                             "visible"):
            _train(tmp_path, "--steps", "1", *flags)
    elif flags[0] == "--num-hosts":
        with pytest.raises(ValueError, match="RANK"):
            _train(tmp_path, "--steps", "1", *flags)
    else:
        addr = flags[1].replace("PORT", str(_free_port()))
        out = _train(tmp_path, "--steps", "1", "--coordinator", addr)
        assert out["final_step"] == 1
    assert dist.is_initialized() == before


# --------------------------------------------------------------------------
# elastic re-sharding (the mesh cases of tests/test_checkpoint_ft.py)
# --------------------------------------------------------------------------

def test_elastic_reshard(tmp_path):
    """Save replicated, restore with explicit shardings on a one-rank mesh
    (the same code path re-shards onto any mesh shape): the leaf comes back
    a DTensor laid out per its sharding, its values the saved ones -- as the
    reference's restore places its leaf."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from jax.sharding import NamedSharding as JNamedSharding
    from jax.sharding import PartitionSpec as JP
    from repro.compat import make_mesh
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import device_mesh

    w = np.arange(16, dtype=np.float32).reshape(4, 4)
    jmesh = make_mesh((1,), ("data",))
    jck = JCheckpointer(str(tmp_path / "j"), async_save=False)
    jck.save(1, {"w": jnp.asarray(w)})
    jsh = {"w": JNamedSharding(jmesh, JP("data", None))}
    jout, _ = jck.restore({"w": jnp.asarray(w)}, shardings=jsh)
    assert jout["w"].sharding == jsh["w"]

    started = not dist.is_initialized()
    try:
        mesh = device_mesh((1,), ("data",), device="cpu")
        ck = Checkpointer(str(tmp_path / "t"), async_save=False)
        t = {"w": torch.from_numpy(w)}
        ck.save(1, t)
        sh = {"w": NamedSharding(mesh, P("data", None))}
        out, _ = ck.restore(t, shardings=sh)
        assert isinstance(out["w"], DTensor)
        assert out["w"].device_mesh == mesh
        assert list(out["w"].placements) == [Shard(0)]
        np.testing.assert_array_equal(out["w"].full_tensor().numpy(),
                                      np.asarray(jout["w"]))
        # a None sharding keeps the leaf as it is
        out, _ = ck.restore(t, shardings={"w": None})
        assert not isinstance(out["w"], DTensor)
        assert torch.equal(out["w"], t["w"])
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def test_best_mesh_shape_elastic():
    from repro.distributed.fault_tolerance import best_mesh_shape as jbest
    for n, mp in ((512, 16), (256, 16), (24, 16), (7, 16)):
        assert best_mesh_shape(n, mp) == jbest(n, mp)
    assert best_mesh_shape(512, 16) == (32, 16)
    assert best_mesh_shape(256, 16) == (16, 16)
    assert best_mesh_shape(24, 16) == (3, 8)   # degraded pod: fewer chips
    assert best_mesh_shape(7, 16) == (7, 1)


def test_remesh_over_the_ranks():
    """``remesh`` builds a (data, model) mesh over the ranks of the process
    group: one rank here."""
    import torch.distributed as dist
    from repro_torch.distributed import remesh
    from repro_torch.distributed.sharding import mesh_shape
    started = not dist.is_initialized()
    try:
        assert mesh_shape(remesh(16, device="cpu")) == {"data": 1,
                                                        "model": 1}
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
