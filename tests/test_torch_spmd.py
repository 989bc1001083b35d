"""Mesh-parallel profiling of the port on several ranks (gloo on the CPU):
the sharded ``truncate_sweep``, ``memtrace`` with a batch-sharded input,
``RaptorReport`` / ``TrajectoryReport.allreduce`` and ``autosearch(mesh=)``
against the unsharded port, as the reference's
``tests/test_spmd_profiling.py`` holds its own.

Each tier spawns one job of ranks (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory, no port), each rank
writes what it computed to a file, and the tests compare those with what
one process computes unsharded:

  * the sweep's K = 6 and K = 5 ladders (5 is padded with an identity row to
    the probe axis' multiple and sliced back) bit for bit;
  * ``memtrace`` with the batch a DTensor sharded over the data axis: every
    rank gathers it and runs the global program, so the outputs and the
    report, a cross-shard mean included, are the single-process ones bit for
    bit;
  * a per-example program run by each rank on its slice of the batch: the
    reports ``allreduce``d over the data axis equal ``merge_all`` of the
    slices' reports, and so does the trajectory;
  * ``autosearch(mesh=)``: the same assignments, evaluations, dispatches,
    rows a dispatch and history as the unsharded search, ``probe_batch``
    padded to the probe axis;
  * ``launch.train`` and ``launch.serve`` on the two ranks' (1, 2) mesh,
    against one process.

The two-rank job runs in tier 1; the reference's (probe=2, data=4) cases
run on eight ranks under the ``spmd`` marker.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import search
from repro_torch.core import (
    TruncationPolicy, loop_body, memtrace, profile_trajectory, scope,
    truncate_sweep,
)
from repro_torch.core.memmode import RaptorReport
from repro_torch.distributed.sharding import batch_sharding, place
from repro_torch.launch.mesh import make_probe_mesh, make_profile_mesh
from repro_torch.profile.trajectory import TrajectoryReport

SITE = TruncationPolicy.everywhere("e5m2")
LADDER = [TruncationPolicy.everywhere(f"e8m{m}")
          for m in (15, 10, 7, 5, 3, 2)]
SEARCH = dict(threshold=1e-2, budget=48)
TRAIN = ["--arch", "h2o-danube-1.8b", "--device", "cpu", "--seq", "16",
         "--global-batch", "4", "--steps", "3", "--save-every", "2",
         "--policy", "scope:**/mlp=e5m7"]
SERVE = ["--arch", "glm4-9b", "--device", "cpu", "--requests", "3",
         "--new-tokens", "3", "--policy", "scope:**/mlp=e5m7"]


def _served(engine):
    """Each request's tokens, by request id."""
    return {rid: req.out_tokens for rid, req in engine._done.items()}


def _toy(w1, w2, x):
    with scope("attn"):
        h = torch.tanh(x @ w1)
    with scope("mlp"):
        for _ in range(3):
            with loop_body("scan"):
                h = torch.relu(h @ w2)
    with scope("head"):
        return (h * h).sum() / h.numel()


def _toy_ew(w1, w2, x):
    """Per-example: no reduction over the batch."""
    with scope("attn"):
        h = torch.tanh(x @ w1)
    with scope("mlp"):
        for _ in range(3):
            with loop_body("scan"):
                h = torch.relu(h @ w2)
    with scope("head"):
        return h * h


def _steps(w1, w2, x):
    h = torch.tanh(x @ w1)
    for _ in range(5):
        with loop_body("step"):
            with scope("mlp"):
                h = torch.tanh(h @ w2)
    return h * h


def _args():
    r = np.random.RandomState(0)
    return tuple(torch.from_numpy(a) for a in (
        (r.randn(32, 64) / 8).astype(np.float32),
        (r.randn(64, 64) / 8).astype(np.float32),
        r.randn(16, 32).astype(np.float32)))


def _report(rep):
    return {"locations": rep.locations, "flags": rep.flags,
            "max_rel": rep.max_rel, "op_counts": rep.op_counts}


def _traj(t):
    return {k: getattr(t, k) for k in ("max_rel", "abs_sum", "mag_sum",
                                       "op_counts", "steps_seen")}


def _search(r):
    return {"assignments": {p: (a.man_bits, a.excluded)
                            for p, a in r.assignments.items()},
            "evals": r.evals_used, "dispatches": r.n_dispatches,
            "max_rows": r.max_dispatch_rows, "history": r.history,
            "k": r.probe_batch, "ndev": r.n_devices}


def _job(rank, world, sweep_mesh, data_mesh, store, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        w1, w2, x = _args()
        res = {}
        mesh = make_profile_mesh(*sweep_mesh, device="cpu")
        h = truncate_sweep(_toy, SITE, mesh=mesh)(w1, w2, x)
        res["sweep6"] = h.batch(h.tables(LADDER))
        res["sweep5"] = h.batch(h.tables(LADDER[:5]))

        mesh = make_profile_mesh(*data_mesh, device="cpu")
        sh = batch_sharding(mesh, "data")
        xs = place(x, sh)
        out, rep = memtrace(_toy, SITE, mesh=mesh,
                            in_shardings=[None, None, sh])(w1, w2, xs)
        res["mem_out"], res["mem"] = out, _report(rep)

        part = x.shape[0] // data_mesh[1]
        coord = mesh.get_local_rank("data")
        mine = x[coord * part:(coord + 1) * part]
        _, rep = memtrace(_toy_ew, SITE)(w1, w2, mine)
        res["allreduce"] = _report(rep.allreduce("data", mesh))
        _, t = profile_trajectory(_steps, SITE, n_steps=6)(w1, w2, mine)
        res["traj_allreduce"] = _traj(t.allreduce("data", mesh))

        res["search"] = _search(search.autosearch(
            _toy, (w1, w2, x), mesh=make_probe_mesh(device="cpu"), **SEARCH))
        if world == 2:
            from repro_torch.launch import serve, train
            res["train"] = train.main(TRAIN + [
                "--num-hosts", str(world),
                "--ckpt", os.path.join(out_dir, "ck")])["losses"]
            res["serve"] = _served(serve.main(SERVE))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, sweep_mesh, data_mesh):
    world = sweep_mesh[0] * sweep_mesh[1]
    mp.spawn(_job, args=(world, sweep_mesh, data_mesh,
                         str(tmp_path / "store"), str(tmp_path)),
             nprocs=world)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _check_sweep(ranks):
    w1, w2, x = _args()
    h = truncate_sweep(_toy, SITE)(w1, w2, x)
    want6, want5 = h.batch(h.tables(LADDER)), h.batch(h.tables(LADDER[:5]))
    singles = torch.stack([h(h.table(p)) for p in LADDER[:5]])
    assert want5.shape == (5,) and torch.equal(want5, singles)
    for res in ranks:
        assert torch.equal(res["sweep6"], want6)
        assert torch.equal(res["sweep5"], want5)


def _same_report(got, want):
    assert got["locations"] == want.locations
    for k in ("flags", "max_rel", "op_counts"):
        assert torch.equal(got[k], getattr(want, k)), k


def _check_memtrace(ranks):
    w1, w2, x = _args()
    out, rep = memtrace(_toy, SITE)(w1, w2, x)
    assert int(rep.flags.sum()) > 0 and len(rep.locations) >= 3
    for res in ranks:
        assert torch.equal(res["mem_out"], out)
        _same_report(res["mem"], rep)


def _slices(data):
    w1, w2, x = _args()
    part = x.shape[0] // data
    return [(w1, w2, x[i * part:(i + 1) * part]) for i in range(data)]


def _check_allreduce(ranks, data):
    reps = [memtrace(_toy_ew, SITE)(*a)[1] for a in _slices(data)]
    merged = RaptorReport.merge_all(reps)
    for res in ranks:
        _same_report(res["allreduce"], merged)
    # the slices' counts are the global run's: a per-example program
    _, whole = memtrace(_toy_ew, SITE)(*_args())
    assert torch.equal(merged.flags, whole.flags)
    assert torch.equal(merged.op_counts, whole.op_counts)


def _check_traj_allreduce(ranks, data):
    ts = [profile_trajectory(_steps, SITE, n_steps=6)(*a)[1]
          for a in _slices(data)]
    merged = TrajectoryReport.merge_all(ts)
    assert int(merged.steps_seen) == 5
    for res in ranks:
        got = res["traj_allreduce"]
        for k in ("max_rel", "op_counts", "steps_seen"):
            assert torch.equal(got[k], torch.as_tensor(getattr(merged, k))), k
        for k in ("abs_sum", "mag_sum"):
            # float sums: exact up to the order of the terms
            torch.testing.assert_close(got[k], getattr(merged, k),
                                       rtol=1e-6, atol=0)


def _check_search(ranks, ndev):
    want = _search(search.autosearch(_toy, _args(), **SEARCH))
    assert want["ndev"] == 1
    for res in ranks:
        got = res["search"]
        for k in ("assignments", "evals", "dispatches", "max_rows",
                  "history"):
            assert got[k] == want[k], k
        assert got["ndev"] == ndev
        assert got["k"] == -(-want["k"] // ndev) * ndev


# ---- two ranks: tier 1 ---------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One job of two ranks: the sweeps on a (probe=2, data=1) mesh, the
    data-axis cases on a (probe=1, data=2) mesh, the search on a probe mesh
    of both ranks, and data-parallel training."""
    return _spawn(tmp_path_factory.mktemp("spmd2"), (2, 1), (1, 2))


def test_sharded_sweep_equals_the_unsharded_handle(two_ranks):
    _check_sweep(two_ranks)


def test_memtrace_of_a_batch_sharded_input_is_the_global_report(two_ranks):
    _check_memtrace(two_ranks)


def test_raptor_report_allreduce_equals_merge_all(two_ranks):
    _check_allreduce(two_ranks, 2)


def test_trajectory_allreduce_equals_merge_all(two_ranks):
    _check_traj_allreduce(two_ranks, 2)


def test_sharded_autosearch_dispatch_stats_match_unsharded(two_ranks):
    _check_search(two_ranks, 2)


def test_launch_train_data_parallel(two_ranks, tmp_path):
    """``launch.train`` on two ranks runs on the reference's smoke mesh,
    ``make_host_mesh(model_parallel=2)``, which on two ranks is (data,
    model) = (1, 2): the parameters and AdamW's state are DTensor shards
    (FSDP x TP under ``DEFAULT_PARAM_RULES``) and the step is the global
    program's, so every rank's losses are one process's to rtol 1e-5 (the
    row-parallel sums in another order; rank 0 writes the checkpoint at
    step 2). Data parallelism, the (2, 1) mesh, is held to one process in
    ``test_torch_sharded_params.py``."""
    from repro_torch.launch import train
    want = train.main(TRAIN + ["--ckpt", str(tmp_path / "ck")])["losses"]
    for res in two_ranks:
        assert sorted(res["train"]) == sorted(want) == [0, 1, 2]
        np.testing.assert_allclose([res["train"][k] for k in sorted(want)],
                                   [want[k] for k in sorted(want)],
                                   rtol=1e-5)


def test_launch_serve_on_a_mesh_of_two(two_ranks):
    """``launch.serve`` on two ranks serves tensor-parallel on (1, 2): the
    parameters under ``SERVE_PARAM_RULES``, the key / value cache over
    ``kv_heads``, every decode step's MLP under ``**/mlp`` e5m7. Both ranks
    serve one process's tokens."""
    from repro_torch.launch import serve
    want = _served(serve.main(SERVE))
    assert len(want) == 3
    for res in two_ranks:
        assert res["serve"] == want


# ---- the reference's (probe=2, data=4) cases: eight ranks ------------------

@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("spmd8"), (2, 4), (2, 4))


@pytest.mark.spmd
def test_sharded_sweep_bit_for_bit_2x4_mesh(eight_ranks):
    _check_sweep(eight_ranks)


@pytest.mark.spmd
def test_raptor_report_reductions_2x4_mesh(eight_ranks):
    _check_memtrace(eight_ranks)
    _check_allreduce(eight_ranks, 4)


@pytest.mark.spmd
def test_trajectory_reduces_exactly_under_mesh(eight_ranks):
    _check_traj_allreduce(eight_ranks, 4)


@pytest.mark.spmd
def test_sharded_autosearch_dispatch_stats_match_unsharded_8(eight_ranks):
    _check_search(eight_ranks, 8)
