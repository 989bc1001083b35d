"""Training entry point on one card (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        [--production] [--steps 1000] [--seq 128] [--global-batch 8] \\
        [--policy "scope:**/mlp=e5m7" | --policy-artifact NAME[@vN] \\
         [--swap-artifact STEP:REF ...] [--registry DIR]] \\
        [--ckpt DIR] [--save-every 100] [--device cpu]

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

Not ported yet: ``--guardrails`` / ``--inject-fault`` (ROADMAP Queue A item
2) and ``--multi-pod`` / ``--coordinator`` / ``--num-hosts`` > 1 (item 5);
each raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

from repro_torch.artifacts import ArtifactRef, Registry, default_root
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.policy import TruncationPolicy, resolve_policy
from repro_torch.data.pipeline import DataConfig, Pipeline, Prefetcher, to_device
from repro_torch.distributed import (
    StragglerMonitor, SupervisorConfig, run_supervised,
)
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
                    help="not ported yet (ROADMAP Queue A item 2)")
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="SITE:STEP[:KIND]",
                    help="not ported yet (ROADMAP Queue A item 2)")
    ap.add_argument("--registry", default=None,
                    help=f"artifact registry root (default $RAPTOR_REGISTRY "
                         f"or {default_root()!r})")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the architecture's smoke configuration")
    ap.add_argument("--production", dest="smoke", action="store_false")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "for tests)")
    return ap.parse_args(argv)


def _not_ported(args):
    if args.guardrails or args.inject_fault:
        raise NotImplementedError(
            "--guardrails / --inject-fault need the guardrails port "
            "(ROADMAP Queue A item 2)")
    if args.multi_pod or args.coordinator or args.num_hosts > 1:
        raise NotImplementedError(
            "--multi-pod / --coordinator / --num-hosts > 1 need the "
            "distribution port (ROADMAP Queue A item 5); this entry point "
            "trains on one card")


def main(argv=None, *, n_layers: Optional[int] = None) -> dict:
    """Train and print the run; returns ``{"final_step", "restarts",
    "straggles", "losses" (step -> loss), "step_fn", "state" (the final
    ``{"params", "opt"}``, as the last checkpoint holds them)}``.
    ``n_layers`` cuts the configuration's depth (a caller's smoke run of a
    full-width model); the command line has no such flag."""
    args = parse_args(argv)
    _not_ported(args)
    device = resolve_device(args.device)
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
    ck = Checkpointer(args.ckpt, keep_k=3)

    params = model.init(seed=0, device=device)
    state = {"params": params,
             "opt": init_opt_state(model, params, tc, device=device)}
    pf = Prefetcher(data)
    peeked = []   # the first prefetched batch, the enumeration's example

    if artifact is not None:
        peeked.append(to_device(pf.next(), device))
        # sites = the union of every artifact this run may deploy, so a swap
        # is always a subset of the enumerated table rows
        site_rules = tuple(artifact.policy.rules) + tuple(
            r for art, _ in swap_schedule.values() for r in art.policy.rules)
        step_fn, sites = make_hotswap_train_step(
            model, tc, TruncationPolicy(rules=site_rules), state["params"],
            peeked[0])
        active = {"ref": artifact_ref,
                  "table": step_fn.device_table(
                      sites.table_for(artifact.policy))}
    else:
        step_fn = make_train_step(model, tc)
        sites = active = None

    def restore_fn() -> int:
        latest = ck.latest_step()
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
            active["table"] = step_fn.device_table(sites.table_for(art.policy))
            print(f"[supervisor] resumed policy {active['ref'].ref}",
                  flush=True)
        print(f"[supervisor] restored step {latest}", flush=True)
        return latest

    def save_fn(step: int):
        ck.save(step, (state["params"], state["opt"]),
                extra={"data": data.state_dict()},
                policy_artifact=active["ref"] if active else None)

    losses = {}
    t0 = time.time()

    def step_fn_supervised(step: int):
        if active is not None and step in swap_schedule:
            art, ref = swap_schedule[step]
            active["ref"] = ref
            active["table"] = step_fn.device_table(sites.table_for(art.policy))
            print(f"[policy] step {step}: hot-swapped to {ref.ref} "
                  "(runtime table, no new enumeration)", flush=True)
        batch = peeked.pop() if peeked else to_device(pf.next(), device)
        extra = (active["table"],) if active is not None else ()
        state["params"], state["opt"], m = step_fn(
            state["params"], state["opt"], batch, step, *extra)
        loss = losses[step] = float(m["loss"])
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
    finally:
        pf.close()
    return {"final_step": final, "restarts": restarts,
            "straggles": straggles, "losses": losses, "step_fn": step_fn,
            "state": state}


if __name__ == "__main__":
    main()
