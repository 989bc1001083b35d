"""Automated precision search on the PyTorch port (the twin of
``precision_search.py``).

Built on ``repro_torch.search.autosearch``: walk the loss once, discover the
``scope`` regions, bisect each region's mantissa width in isolation, then
compose the joint policy and greedily exclude fragile regions until the
loss degradation fits the budget (paper §6.3's "exclude Recon, re-run").
Ends with the Fig. 7-style cost-benefit readout: the per-scope format table,
the truncated-FLOP census, and the predicted speedup.

    PYTHONPATH=src python examples/torch_precision_search.py [--device cpu] \
        [--batch 8] [--evals 48]

It runs on the CUDA device unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import search
from repro_torch.configs import get_config
from repro_torch.core import truncate, profile_counts, estimate_speedup
from repro_torch.models import Model
from repro_torch.models.common import resolve_device

ERROR_BUDGET = 5e-3       # max acceptable relative loss degradation
EVAL_BUDGET = 48          # candidate evaluations the search may spend

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: the CUDA device")
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--evals", type=int, default=EVAL_BUDGET)
args = ap.parse_args()
device = resolve_device(args.device)

cfg = get_config("h2o-danube-1.8b", "smoke")
model = Model(cfg)
params = model.init(seed=0, device=device)
r = np.random.RandomState(0)
toks = torch.from_numpy(
    r.randint(0, cfg.vocab, (args.batch, 65)).astype(np.int32))
batch = {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}
full = float(model.loss(params, batch))
print(f"baseline loss {full:.6f}; budget {ERROR_BUDGET:.0e} relative, "
      f"{args.evals} evaluations\n")

result = search.autosearch(
    model.loss, (params, batch),
    search.loss_degradation, args.evals,
    threshold=ERROR_BUDGET, verbose=True)

print("\nper-scope assignment (paper heatmap analogue):")
print(result.table())

policy = result.policy()
lossy = float(truncate(model.loss, policy)(params, batch))
rep = profile_counts(model.loss, policy)(params, batch)
print(f"\nfinal policy loss {lossy:.6f} (rel err "
      f"{abs(lossy - full) / abs(full):.2e})")
print(rep.summary())
print("predicted speedup:", estimate_speedup(rep))
