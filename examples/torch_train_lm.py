"""End-to-end training on the PyTorch port (the twin of ``train_lm.py``):
data pipeline -> train step -> checkpoint/restart -> optional RAPTOR
truncation policy, on one device (``launch/train.py`` runs the same step
FSDP x TP on several ranks).

Default: a ~13M-param GLM4-family model for 60 steps. Scale up:
    PYTHONPATH=src python examples/torch_train_lm.py --arch glm4-9b \\
        --steps 300 --d-model 768 --layers 12      # ~100M params

It runs on the CUDA device unless ``--device cpu`` is given.

Demonstrates fault tolerance: the run saves every --save-every steps; rerun
the same command and it resumes from the latest checkpoint.
"""
import argparse
import os
import tempfile
import time

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import TruncationPolicy
from repro_torch.data.pipeline import (
    DataConfig, Pipeline, Prefetcher, to_device,
)
from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.optim.adamw import AdamWConfig, warmup_cosine
from repro_torch.train import TrainConfig, make_train_step, init_opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--policy", default=None,
                    help="RAPTOR flag, e.g. 32_to_8_10 or scope:mlp=e5m7")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device")
    args = ap.parse_args(argv)

    base = get_config(args.arch, "smoke")
    cfg = base.replace(d_model=args.d_model,
                       n_layers=args.layers,
                       d_ff=args.d_model * 3,
                       vocab=4096, dtype="float32")
    model = Model(cfg)
    print(f"arch={cfg.name} family={cfg.family} params={model.n_params()/1e6:.1f}M")

    policy = None
    if args.policy:
        if args.policy.startswith("scope:"):
            scope, fmt = args.policy[len("scope:"):].split("=")
            policy = TruncationPolicy.scoped(f"**/{scope}", fmt)
        else:
            policy = TruncationPolicy.from_flag(args.policy)

    tc = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        policy=policy,
        lr_schedule=lambda s: warmup_cosine(s, peak_lr=args.lr, warmup=20,
                                            total=max(args.steps, 100)))
    data = Pipeline(DataConfig(seq_len=args.seq, global_batch=args.batch,
                               vocab=cfg.vocab,
                               d_model=cfg.d_model,
                               input_mode=("encdec" if cfg.family == "encdec"
                                           else cfg.input_mode),
                               mrope=cfg.rope_type == "mrope"))
    ck = Checkpointer(args.ckpt_dir, keep_k=2)

    device = resolve_device(args.device)
    step_fn = make_train_step(model, tc)
    params = model.init(seed=0, device=device)
    opt = init_opt_state(model, params, tc, device=device)

    start = 0
    if ck.latest_step() is not None:
        (params, opt), manifest = ck.restore((params, opt))
        data.load_state_dict(manifest["extra"]["data"])
        start = manifest["step"]
        print(f"resumed from step {start}")

    pf = Prefetcher(data)
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = to_device(pf.next(), device)
            params, opt, m = step_fn(params, opt, batch, step)
            if step % 10 == 0 or step == args.steps - 1:
                dt = (time.time() - t0) / max(step - start + 1, 1)
                print(f"step {step:5d} loss {float(m['loss']):.4f} "
                      f"lr {float(m['lr']):.2e} "
                      f"gnorm {float(m['grad_norm']):.2f} "
                      f"({dt*1e3:.0f} ms/step)", flush=True)
            if (step + 1) % args.save_every == 0:
                ck.save(step + 1, (params, opt),
                        extra={"data": data.state_dict()})
        ck.save(args.steps, (params, opt),
                extra={"data": data.state_dict()}, block=True)
        print("done; checkpoint at", args.ckpt_dir)
    finally:
        pf.close()


if __name__ == "__main__":
    main()
