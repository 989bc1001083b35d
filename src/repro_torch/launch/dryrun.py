"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell, computed
abstractly -- ``meta`` tensors, an ``AbstractMesh``, no process group and no
card.

For each cell the record holds:

  * ``memory``: the per-device bytes of the parameters, optimizer state,
    decode caches and inputs under their resolved specs
    (``launch.specs``), and whether they fit the H100's 80 GB. Activations
    and workspace are not counted: XLA's ``memory_analysis`` temp bytes
    have no counterpart here (``temp_bytes`` is ``None``);
  * ``model_flops``: 6 N D for training, 2 N D for a prefill, 2 N B a decoded
    token (N the active parameters);
  * ``jaxpr_flops`` / ``jaxpr_bytes`` / ``jaxpr_bytes_fused``: the global
    FLOPs and bytes of ``profile_counts`` run on the meta tensors -- the
    whole train step for a train cell (value and gradients of the loss,
    the AdamW update; autograd's derivative formulas, see
    ``core.counters``), the prefill forward, one decode step. A family whose
    program reads tensor values on the host (MoE dispatch) does not run on
    meta tensors: its counts are ``None`` and ``counts_note`` says why.

XLA's ``cost_analysis`` and the HLO collective census have no counterpart:
records leave ``collectives`` out, and ``launch.roofline`` reports that term
as not measured.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k [--single-pod-only]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Artifacts land in ``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json``
(git-ignored).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

from repro_torch.configs.base import ARCH_IDS, SHAPES, InputShape, cells, get_config
from repro_torch.core import api, counters
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.models import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "repro_torch", "dryrun")

HBM_BYTES = 80e9             # NVIDIA H100 80GB HBM3

# m/v dtype per arch (memory fit for the 236B single-pod case)
_STATE_DTYPE = {"deepseek-v2-236b": "bfloat16"}


def production_mesh(multi_pod: bool) -> shd.AbstractMesh:
    """``launch.mesh.make_production_mesh``'s shape, with no devices."""
    if multi_pod:
        return shd.AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return shd.AbstractMesh({"data": 16, "model": 16})


def _serve_rules(model: Model):
    """TP-only param sharding for serving when bf16 weights fit one
    model-parallel shard group (<=12 GB/dev leaves room for the cache);
    otherwise keep FSDP (deepseek-v2-236b)."""
    if model.n_params() * 2 / 16 <= 12e9:
        return shd.SERVE_PARAM_RULES
    return None


def train_step(model: Model):
    """The train step a train cell counts: value and gradients of the loss
    (``grad_accum`` microbatches) and the AdamW update, as the reference's
    dry-run lowers it."""
    cfg = model.cfg
    tc = TrainConfig(optimizer=AdamWConfig(
        state_dtype=_STATE_DTYPE.get(cfg.name, "float32")),
        grad_accum=cfg.grad_accum)
    return make_train_step(model, tc)


def abstract_cell(arch_id: str, shape: InputShape, multi_pod: bool):
    """``(model, mesh, fn, args, memory parts)`` of one cell: the program
    to count and its meta inputs, and the per-device bytes of each part."""
    cfg = get_config(arch_id)
    model = Model(cfg)
    mesh = production_mesh(multi_pod)
    param_rules = None if shape.kind == "train" else _serve_rules(model)
    with shd.use_mesh(mesh, param_rules=param_rules):
        params = sp.params_specs(model, mesh)
        parts = {"params": params}
        if shape.kind == "train":
            parts["opt_state"] = sp.opt_state_specs(
                model, mesh, _STATE_DTYPE.get(cfg.name, "float32"))
            batch = parts["inputs"] = sp.input_specs(cfg, shape, mesh)
            fn, args = train_step(model), (params, parts["opt_state"],
                                           batch, 0)
        elif shape.kind == "prefill":
            batch = parts["inputs"] = sp.input_specs(cfg, shape, mesh,
                                                     with_labels=False)
            fn, args = model.prefill, (params, batch)
        else:
            cache = parts["cache"] = sp.cache_specs(model, shape, mesh)
            toks, emb = sp.decode_token_specs(cfg, shape, mesh)
            parts["inputs"] = (toks, emb)
            if emb is not None:
                fn = lambda p, c, t, e: model.decode_step(p, c, t, embeds=e)
                args = (params, cache, toks, emb)
            else:
                fn, args = model.decode_step, (params, cache, toks)
    memory = {k: sp.tree_bytes_per_device(v) for k, v in parts.items()}
    return model, mesh, fn, args, memory


def model_flops(model: Model, shape: InputShape) -> float:
    """Paper-style MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for
    a prefill forward, 2·N_active·B per decoded token."""
    n = model.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def meta_counts(fn, args):
    """``(flops, bytes unfused, bytes fused)`` of one run of ``fn`` on meta
    tensors."""
    rep = api.profile_counts(fn, api.TruncationPolicy(rules=()),
                             cache=False)(*args)
    rep_f = counters.count_ops(fn, args, {}, None, fused=True)
    return (rep.total_flops, sum(rep.bytes_by_fmt.values()),
            sum(rep_f.bytes_by_fmt.values()))


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR) -> Dict[str, Any]:
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch_id}__{shape_name}__{mesh_name}"
    rec: Dict[str, Any] = {"arch": arch_id, "shape": shape_name,
                           "mesh": mesh_name, "ok": False}
    t0 = time.time()
    try:
        model, mesh, fn, args, memory = abstract_cell(arch_id, shape,
                                                      multi_pod)
        total = sum(memory.values())
        rec.update(
            ok=True,
            n_devices=mesh.size,
            n_params=model.n_params(),
            n_active_params=model.n_active_params(),
            model_flops=model_flops(model, shape),
            memory={"by_part": memory, "argument_bytes": total,
                    "temp_bytes": None, "hbm_bytes": HBM_BYTES,
                    "fits": total <= HBM_BYTES},
            counts_of={"train": "train step", "prefill": "prefill forward",
                       "decode": "one decode step"}[shape.kind],
        )
        rec["jaxpr_flops"] = rec["jaxpr_bytes"] = None
        rec["jaxpr_bytes_fused"] = None
        t1 = time.time()
        try:
            (rec["jaxpr_flops"], rec["jaxpr_bytes"],
             rec["jaxpr_bytes_fused"]) = meta_counts(fn, args)
        except Exception as e:  # noqa: BLE001 -- recorded per cell
            rec["counts_note"] = (f"not counted on meta tensors: "
                                  f"{type(e).__name__}: {e}"[:400])
        rec["count_s"] = round(time.time() - t1, 2)
    except Exception as e:  # noqa: BLE001 -- a failed cell is a bug; record it
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {tag}  ({rec['total_s']}s)"
          + ("" if rec["ok"] else f"  {rec['error']}"), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    jobs = []
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    for arch in archs:
        for shape, runnable in cells(arch):
            if args.shape and shape.name != args.shape:
                continue
            if not runnable:
                print(f"[SKIP] {arch}__{shape.name} -- full-attention arch, "
                      f"long-context cell skipped", flush=True)
                continue
            meshes = []
            if not args.multi_pod_only:
                meshes.append(False)
            if not args.single_pod_only:
                meshes.append(True)
            if args.multi_pod:
                meshes = [True]
            for mp in meshes:
                jobs.append((arch, shape.name, mp))

    results = [run_cell(a, s, m, args.out) for a, s, m in jobs]
    ok = sum(r["ok"] for r in results)
    print(f"\n{ok}/{len(results)} cells computed", flush=True)
    if ok < len(results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
