"""Quickstart on the PyTorch port: profile a model's numerical sensitivity
in ~30 lines (the twin of ``quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] \
        [--batch 4] [--seq 64]

It runs on the CUDA device unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    truncate, memtrace, profile_counts, TruncationPolicy, estimate_speedup,
)
from repro_torch.models import Model
from repro_torch.models.common import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: the CUDA device")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--seq", type=int, default=64)
args = ap.parse_args()
device = resolve_device(args.device)

# 1. any assigned architecture, reduced config for the laptop
cfg = get_config("olmoe-1b-7b", "smoke")
model = Model(cfg)
params = model.init(seed=0, device=device)
r = np.random.RandomState(0)
toks = torch.from_numpy(
    r.randint(0, cfg.vocab, (args.batch, args.seq + 1)).astype(np.int32))
batch = {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}

# 2. hypothesis: the MoE experts tolerate 8 mantissa bits (the router won't)
policy = TruncationPolicy.scoped("**/moe/experts", "e8m8")

# 3. op-mode: run the truncated model, measure the damage
full = float(model.loss(params, batch))
lossy = float(truncate(model.loss, policy)(params, batch))
print(f"loss full={full:.6f}  truncated={lossy:.6f}  delta={lossy-full:+.2e}")

# 4. counters -> predicted speedup (paper §7.2)
rep = profile_counts(model.loss, policy)(params, batch)
print(rep.summary())
print("predicted:", estimate_speedup(rep))

# 5. mem-mode: where does it hurt? (numerical heatmap)
out, heat = memtrace(model.loss, TruncationPolicy.everywhere("e8m8"),
                     threshold=1e-3)(params, batch)
print("\ntop numerically-fragile locations:")
print(heat.summary(8))
