"""Training entry point (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        [--production] [--steps 1000] [--seq 128] [--global-batch 8] \\
        [--policy "scope:**/mlp=e5m7" | --policy-artifact NAME[@vN] \\
         [--swap-artifact STEP:REF ...] [--registry DIR]] \\
        [--ckpt DIR] [--save-every 100] [--device cpu] \\
        [--coordinator HOST:PORT --num-hosts N --host-id I] [--multi-pod]

``--smoke`` (the default) trains the architecture's smoke configuration,
``--production`` the full one (with its gradient accumulation); random
weights from seed 0, synthetic tokens from the seeded data pipeline. The
model runs on one CUDA device; ``--device cpu`` runs it on the CPU.

The loop is the reference's: deterministic data, grad accumulation,
checkpoint/restart supervision with straggler monitoring, and an optional
RAPTOR policy. ``--policy`` truncates the differentiated loss (``truncate``
of loss and gradients); ``--policy-artifact`` trains under a registry
artifact through runtime format tables (one enumeration), so
``--swap-artifact`` deploys another artifact mid-run as a new table value.
A restart restores the latest checkpoint and, when the checkpoint records
the artifact it trained under, re-loads that artifact by name and version
and refuses to resume if its digest differs.

``--guardrails`` (with ``--policy-artifact``) watches every step's loss and
finiteness; on an alarm the escalation ladder widens the blamed rows of the
live table and, from its second rung, rolls back to the last checkpoint,
resuming under the escalated table. ``--inject-fault SITE:STEP[:KIND]``
(with ``--guardrails``) corrupts a table row at a step (``overflow``, the
default, or ``bitflip``). The log of interventions is saved beside the
checkpoints and attached to the artifact.

Several ranks, one per device: ``--coordinator HOST:PORT --num-hosts N
--host-id I`` starts the process group (``init_method="tcp://HOST:PORT"``);
under ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR``) ``--num-hosts N`` alone joins its group. The ranks form the
reference's smoke mesh, ``make_host_mesh(model_parallel=2)`` (``(1, 2)`` on
two ranks, ``(2, 2)`` on four), and the parameters and the optimizer state
are placed FSDP x TP under ``DEFAULT_PARAM_RULES``: every rank holds its
shards (DTensors), the batch is laid out over the data axis, and the step is
the global program's, so its loss and gradients are the mean over the
global batch, for any ``--arch``. Every rank takes part in a checkpoint's
gather, rank 0 writes it.
``--multi-pod`` builds the 512-device production mesh and raises, naming
the count, on fewer ranks.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from typing import Optional

import torch.distributed as dist

from repro_torch.artifacts import ArtifactRef, Registry, default_root
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.policy import TruncationPolicy, resolve_policy
from repro_torch.data.pipeline import DataConfig, Pipeline, Prefetcher, to_device
from repro_torch.distributed import (
    StragglerMonitor, SupervisorConfig, run_supervised,
)
from repro_torch.distributed import sharding as shd
from repro_torch.guardrails import (
    EscalationLadder, FaultPlan, FaultSpec, GuardrailLog,
    NumericalFaultError, StepMonitor,
)
from repro_torch.guardrails.controller import _DeviceTable
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
from repro_torch.train import (
    TrainConfig, init_opt_state, make_hotswap_train_step, make_train_step,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--policy", default=None,
                    help='RAPTOR spec: "32_to_5_14" or "scope:**/mlp=e5m7"')
    ap.add_argument("--policy-artifact", default=None,
                    help='registry ref ("name" or "name@v3"): train under '
                         "the artifact's policy via runtime format tables")
    ap.add_argument("--swap-artifact", action="append", default=[],
                    metavar="STEP:REF",
                    help="hot-swap to registry artifact REF at STEP "
                         "(repeatable; requires --policy-artifact)")
    ap.add_argument("--guardrails", action="store_true",
                    help="runtime numerical guardrails: per-step divergence "
                         "monitor + precision-escalation ladder + "
                         "checkpoint rollback (requires --policy-artifact)")
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="SITE:STEP[:KIND]",
                    help="chaos demo: corrupt table row SITE at STEP "
                         "(KIND: overflow | bitflip; repeatable; requires "
                         "--guardrails)")
    ap.add_argument("--registry", default=None,
                    help=f"artifact registry root (default $RAPTOR_REGISTRY "
                         f"or {default_root()!r})")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the architecture's smoke configuration")
    ap.add_argument("--production", dest="smoke", action="store_false")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int,
                    default=int(os.environ.get("RANK", 0)))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "for tests)")
    return ap.parse_args(argv)


def _parse_fault(spec: str) -> FaultSpec:
    """``--inject-fault SITE:STEP[:KIND]`` (KIND: overflow | bitflip)."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise SystemExit(
            f"bad --inject-fault {spec!r}; want SITE:STEP[:KIND]")
    kind = parts[2] if len(parts) == 3 else "overflow"
    return FaultSpec(site=int(parts[0]), step=int(parts[1]), kind=kind)


def _distribution(args, device):
    """The mesh of the run, ``None`` on one rank. Starts the process group
    a ``--coordinator`` or ``--num-hosts`` asks for."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if args.num_hosts < 1:
        raise ValueError(f"--num-hosts {args.num_hosts}: want at least 1")
    if args.coordinator:
        dist.init_process_group(
            backend, init_method=f"tcp://{args.coordinator}",
            world_size=args.num_hosts, rank=args.host_id)
    elif args.num_hosts > 1 and not dist.is_initialized():
        dist.init_process_group(backend)        # torchrun's environment
    if args.multi_pod:
        return make_production_mesh(multi_pod=True, device=device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        return make_host_mesh(model_parallel=2, device=device)
    return None


def main(argv=None, *, n_layers: Optional[int] = None) -> dict:
    """Train and print the run; returns ``{"final_step", "restarts",
    "straggles", "losses" (step -> loss; a replayed step keeps its last
    loss), "step_fn", "state" (the final ``{"params", "opt"}``, as the last
    checkpoint holds them), "guardrail_log" (``None`` without
    ``--guardrails``), "table" (the final numpy table, ``None`` without
    ``--policy-artifact``)}``.
    ``n_layers`` cuts the configuration's depth (a caller's smoke run of a
    full-width model); the command line has no such flag."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        return _main(args, device, n_layers)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, device, n_layers):
    mesh = _distribution(args, device)
    rank = dist.get_rank() if mesh is not None else 0
    cfg = get_config(args.arch, "smoke" if args.smoke else "full")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    seq = args.seq or (128 if args.smoke else 4096)
    gbatch = args.global_batch or (8 if args.smoke else 256)
    print(f"arch={cfg.name} params={model.n_params()/1e6:.1f}M "
          f"device={device} seq={seq} batch={gbatch}", flush=True)

    # ---- precision-policy resolution --------------------------------------
    # --policy truncates the differentiated loss; --policy-artifact routes
    # through runtime format tables, so --swap-artifact deploys another
    # artifact mid-run as a new table value (one enumeration)
    if args.swap_artifact and not args.policy_artifact:
        raise SystemExit("--swap-artifact requires --policy-artifact "
                         "(the runtime-table training path)")
    if args.guardrails and not args.policy_artifact:
        raise SystemExit("--guardrails requires --policy-artifact (the "
                         "escalation ladder rewrites the runtime table)")
    if args.inject_fault and not args.guardrails:
        raise SystemExit("--inject-fault requires --guardrails")
    registry = Registry(args.registry) if args.policy_artifact else None
    try:
        res = resolve_policy(args.policy, args.policy_artifact,
                             registry=registry)
    except ValueError as e:
        raise SystemExit(str(e))
    artifact, artifact_ref = res.artifact, res.ref
    swap_schedule = {}
    if artifact_ref is not None:
        print(f"policy artifact: {artifact_ref.ref} "
              f"(digest {artifact_ref.digest[:12]})", flush=True)
        for spec in args.swap_artifact:
            at, _, ref = spec.partition(":")
            swap_schedule[int(at)] = registry.load_ref(ref)

    tc = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        grad_accum=1 if args.smoke else cfg.grad_accum,
        # artifact policies deploy through runtime tables below
        policy=res.policy if artifact is None else None,
        lr_schedule=lambda s: warmup_cosine(
            s, peak_lr=args.lr, warmup=min(2000, args.steps // 10 + 1),
            total=args.steps))
    data = Pipeline(DataConfig(
        seq_len=seq, global_batch=gbatch, vocab=cfg.vocab,
        d_model=cfg.d_model,
        input_mode=("encdec" if cfg.family == "encdec" else cfg.input_mode),
        mrope=cfg.rope_type == "mrope"))
    ck = Checkpointer(args.ckpt, keep_k=3, async_save=mesh is None)
    if mesh is not None:
        n_data = math.prod(n for a, n in shd.mesh_shape(mesh).items()
                           if a in ("pod", "data"))
        if gbatch % n_data:
            raise ValueError(f"global batch {gbatch} does not divide over "
                             f"{n_data} data ranks")
        print(f"mesh={shd.mesh_shape(mesh)} rank={rank}: "
              f"{gbatch // n_data} rows of each batch", flush=True)

    def next_batch():
        batch = to_device(pf.next(), device)
        if mesh is None:
            return batch
        # every rank draws the global batch and keeps its rows
        return shd.place_batch(batch, mesh)

    params = model.init(seed=0, device=device)
    if mesh is not None:
        params = model.place_params(params, mesh)
    state = {"params": params,
             "opt": init_opt_state(model, params, tc, device=device)}
    pf = Prefetcher(data)
    peeked = []   # the first prefetched batch, the enumeration's example

    if artifact is not None:
        peeked.append(next_batch())
        # sites = the union of every artifact this run may deploy, so a swap
        # is always a subset of the enumerated table rows
        site_rules = tuple(artifact.policy.rules) + tuple(
            r for art, _ in swap_schedule.values() for r in art.policy.rules)
        step_fn, sites = make_hotswap_train_step(
            model, tc, TruncationPolicy(rules=site_rules), state["params"],
            peeked[0])
        # the live table is numpy (faults and the ladder rewrite it); the
        # step reads its device copy, made again only when it changes
        live_table = _DeviceTable(step_fn.device_table)
        active = {"ref": artifact_ref,
                  "table": sites.table_for(artifact.policy)}
    else:
        step_fn = make_train_step(model, tc)
        sites = active = None

    # ---- runtime numerical guardrails -------------------------------------
    # monitor every step's loss and finiteness; on an alarm, escalate blamed
    # sites in the live table (a new table value, no new enumeration) and
    # roll back through run_supervised (NumericalFaultError is a
    # RuntimeError, the supervisor's default retry class)
    guard = None
    if args.guardrails:
        glog = GuardrailLog()
        guard = {
            "monitor": StepMonitor(),
            "ladder": EscalationLadder(active["table"], site_index=sites,
                                       log=glog),
            "plan": FaultPlan([_parse_fault(f) for f in args.inject_fault]),
            "log": glog,
            "escalated": None,
        }

    def restore_fn() -> int:
        # a rollback right after a save restores that save: wait for the
        # write in flight to land before asking for the latest step
        ck.wait()
        latest = ck.latest_step()
        if guard is not None:
            guard["monitor"].reset()
        if latest is None:
            return 0
        (state["params"], state["opt"]), manifest = ck.restore(
            (state["params"], state["opt"]))
        data.load_state_dict(manifest["extra"]["data"])
        rec = manifest.get("policy_artifact")
        if rec and active is not None:
            # resume under the exact policy the checkpoint trained on:
            # reload by recorded name and verify the content digest
            art = registry.load(f"{rec['name']}@v{rec['version']}")
            if art.digest != rec["digest"]:
                raise RuntimeError(
                    f"registry artifact {rec['name']}@v{rec['version']} "
                    f"digest {art.digest[:12]} != checkpoint-recorded "
                    f"{rec['digest'][:12]}; refusing to resume under a "
                    "different policy than the one trained on")
            active["ref"] = ArtifactRef.from_json(rec)
            active["table"] = sites.table_for(art.policy)
            print(f"[supervisor] resumed policy {active['ref'].ref}",
                  flush=True)
        if guard is not None and guard["escalated"] is not None:
            # the ladder's widened rows survive the rollback -- resuming
            # under the pre-escalation table would just diverge again
            active["table"] = guard["escalated"]
        print(f"[supervisor] restored step {latest}", flush=True)
        return latest

    def save_fn(step: int):
        if rank == 0 or mesh is not None:      # sharded: every rank gathers
            ck.save(step, (state["params"], state["opt"]),
                    extra={"data": data.state_dict()},
                    policy_artifact=active["ref"] if active else None)
        if mesh is not None:
            dist.barrier()

    losses = {}
    t0 = time.time()

    def step_fn_supervised(step: int):
        if active is not None and step in swap_schedule:
            art, ref = swap_schedule[step]
            active["ref"] = ref
            active["table"] = sites.table_for(art.policy)
            print(f"[policy] step {step}: hot-swapped to {ref.ref} "
                  "(runtime table, no new enumeration)", flush=True)
        if guard is not None:
            table, fired = guard["plan"].apply(active["table"], step)
            for f in fired:
                guard["log"].record(
                    step, "fault_injected", site=f.site, fault=f.kind,
                    row=[int(x) for x in table[f.site]])
                print(f"[guardrail] step {step}: injected {f.kind} "
                      f"fault at site {f.site}", flush=True)
            active["table"] = table
        batch = peeked.pop() if peeked else next_batch()
        extra = (live_table(active["table"]),) if active is not None else ()
        state["params"], state["opt"], m = step_fn(
            state["params"], state["opt"], batch, step, *extra)
        loss = losses[step] = float(m["loss"])
        if guard is not None:
            v = guard["monitor"].update(step, loss,
                                        nonfinite=bool(m["nonfinite"]))
            if v.alarm:
                print(f"[guardrail] step {step}: ALARM — {v.reason}",
                      flush=True)
                table, rollback = guard["ladder"].escalate(
                    active["table"], step, v)
                active["table"] = guard["escalated"] = table
                if rollback:
                    guard["log"].record(step, "rollback", reason=v.reason)
                    raise NumericalFaultError(v.reason)
        if step % 10 == 0:
            print(f"step {step:6d} loss {loss:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"({(time.time()-t0):.0f}s)", flush=True)
        return loss

    try:
        final, restarts, straggles = run_supervised(
            step_fn_supervised, save_fn, restore_fn, args.steps,
            SupervisorConfig(save_every=args.save_every),
            monitor=StragglerMonitor())
        ck.wait()
        print(f"done: step={final} restarts={restarts} "
              f"straggles={straggles}", flush=True)
        if guard is not None:
            glog = guard["log"]
            log_path = os.path.join(args.ckpt, "guardrail_log.json")
            glog.save(log_path)
            print(glog.summary(), flush=True)
            print(f"[guardrail] log saved to {log_path}", flush=True)
            if artifact is not None and len(glog):
                # the audited artifact: the deployed policy plus what the
                # controller did while it ran
                audited = glog.attach(artifact)
                art_path = os.path.join(args.ckpt, "guardrail_artifact.json")
                with open(art_path, "w") as f:
                    f.write(audited.dumps() + "\n")
                print(f"[guardrail] audited artifact saved to {art_path}",
                      flush=True)
    finally:
        pf.close()
    return {"final_step": final, "restarts": restarts,
            "straggles": straggles, "losses": losses, "step_fn": step_fn,
            "state": state,
            "guardrail_log": guard["log"] if guard is not None else None,
            "table": active["table"] if active is not None else None}


if __name__ == "__main__":
    main()
