"""Serving entry point: continuous batching with an optional RAPTOR
truncation policy and sampled shadow profiling of live traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        [--production] [--policy "scope:**/mlp=e5m7"] [--requests 8] \\
        [--new-tokens 16] [--shadow-rate 0.0625] [--drift-margin 4.0]

``--smoke`` (the default) serves the architecture's smoke configuration,
``--production`` the full one. The model runs on one CUDA device (``--device
cpu`` runs it on the CPU, for tests); random weights from seed 0. The
parameters are placed under ``SERVE_PARAM_RULES`` (TP-only, the reference's
serving layout) on the host mesh of the running process group
(``make_host_mesh(model_parallel=2)``: ``(1, 2)`` on two ranks), or on the
shape of a one-device mesh when there is none: every spec then resolves to
replicated and the tensors stay as they are. On a mesh of several ranks
every rank holds its shards of the parameters and of the key / value
cache, runs the decode step on them (tensor parallelism) and serves the
same tokens.

Requests stream in with mixed prompt lengths and token budgets; the engine
admits each one into any free decode slot while the other slots keep
decoding (no aligned waves — see :mod:`repro_torch.serving.engine`).

Policies deploy through :func:`repro_torch.core.policy.resolve_policy`: an
explicit ``--policy`` flag string, or a registry ref (``--policy-artifact
bench_model@v3 [--registry artifacts]``) whose searched policy is applied
to the decode step.

With ``--shadow-rate > 0`` a sampled fraction of requests decode through
the memtrace-shadowed step (served tokens stay bit-identical); the merged
serving-side RaptorReport is printed at drain, and drift past the deployed
artifact's accepted error budget pages a re-search suggestion and is
recorded in the artifact's provenance.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.artifacts import default_root
from repro_torch.configs import get_config
from repro_torch.core.policy import resolve_policy as _core_resolve_policy
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.serving import Engine, ShadowConfig


def resolve_policy(policy_flag, artifact_ref, registry_root=None):
    """Back-compat wrapper over :func:`repro_torch.core.policy.resolve_policy`.
    Returns ``(policy, artifact_or_None)``."""
    try:
        res = _core_resolve_policy(policy_flag, artifact_ref,
                                   registry=registry_root)
    except ValueError as e:
        raise SystemExit(str(e))
    if res.ref is not None:
        print(f"loaded {res.artifact} from registry "
              f"{registry_root or default_root()!r}", flush=True)
    return res.policy, res.artifact


def _print_drift(event):
    """Re-search hook: surface the blame ranking as an autosearch warm
    start so the on-call can page a re-search with the live evidence."""
    print(f"DRIFT {event}", flush=True)
    warm = ",".join(loc for loc, _flags, _err in event.blame[:4])
    print(f"  re-search warm start: --warm-sites '{warm}'", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="mean prompt length (actual lengths are ragged)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--policy", default=None,
                    help='raw spec: "scope:**/mlp=fp16" or "32_to_5_14"')
    ap.add_argument("--policy-artifact", default=None,
                    help='registry ref: "name" (latest) or "name@v3"')
    ap.add_argument("--registry", default=None,
                    help=f"registry root (default $RAPTOR_REGISTRY or "
                         f"{default_root()!r})")
    ap.add_argument("--shadow-rate", type=float, default=0.0,
                    help="fraction of requests shadow-profiled (0 = off)")
    ap.add_argument("--shadow-threshold", type=float, default=1e-3,
                    help="memtrace flagging threshold for shadowed steps")
    ap.add_argument("--drift-margin", type=float, default=4.0,
                    help="page when peak shadow error exceeds margin x "
                         "the deployed artifact's accepted budget")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--production", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "for tests)")
    return ap.parse_args(argv)


def workload(vocab: int, n: int, prompt_len: int, seed: int = 0):
    """Ragged prompts around ``prompt_len`` from a seeded generator, so
    serving exercises masked prefill into busy batches, not aligned
    waves."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        plen = max(1, int(rng.randint(max(1, prompt_len // 2),
                                      prompt_len * 2)))
        out.append(rng.randint(1, vocab, plen))
    return out


def main(argv=None, *, n_layers: Optional[int] = None) -> Engine:
    """Serve ``--requests`` requests and print what was served; returns the
    engine that served them (its ``params`` and ``model`` stay usable, and
    ``served_seconds`` holds the wall time of the drain). ``n_layers`` cuts
    the configuration's depth (a caller's shorter run of a full-width
    model); ``None`` keeps it."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, "smoke" if args.smoke else "full")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    # serving uses TP-only params when they fit (the reference's layout)
    mesh = (make_host_mesh(model_parallel=2, device=device)
            if dist.is_initialized()
            else shd.AbstractMesh({"data": 1, "model": 1}))
    params = model.init(seed=0, device=device)
    if shd.mesh_size(mesh) > 1:
        params = model.place_params(params, mesh, shd.SERVE_PARAM_RULES)

    policy, artifact = resolve_policy(args.policy, args.policy_artifact,
                                      args.registry)
    shadow = None
    if args.shadow_rate > 0 and policy is not None:
        shadow = ShadowConfig(rate=args.shadow_rate,
                              threshold=args.shadow_threshold,
                              drift_margin=args.drift_margin,
                              on_drift=_print_drift)
    eng = Engine(model, params, batch_size=args.batch,
                 max_seq_len=args.max_seq,
                 policy=artifact if artifact is not None else policy,
                 shadow=shadow)
    for prompt in workload(cfg.vocab, args.requests, args.prompt_len):
        eng.submit(prompt, max_new_tokens=args.new_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done.values())
    print(f"served {len(done)} requests, {total} tokens in {dt:.1f}s "
          f"({total / dt:.1f} tok/s, {1e3 * dt / max(eng.ticks, 1):.2f} "
          f"ms a tick over {eng.ticks} ticks on {device})", flush=True)
    for rid in sorted(done):
        req = done[rid]
        tag = " [shadowed]" if req.shadowed else ""
        tag += f" [{req.status}]" if req.status != "ok" else ""
        print(f"  req {rid}: {req.out_tokens}{tag}")
    if eng.serving_report is not None:
        print("shadow serving report (top sites):")
        for loc, flags, err in eng.serving_report.top(3):
            print(f"  {loc}: flags={flags} max_rel={err:.2e}")
    for ev in eng.drift_events:
        print(f"drift event recorded at tick {ev.tick} "
              f"(peak {ev.peak:.2e} vs budget {ev.budget:.2e})")
    eng.served_seconds = dt
    return eng


if __name__ == "__main__":
    main()
