"""Loss of the first AdamW steps at several learning rates, in the
reference package and in the port, on the same parameters and batch.

    PYTHONPATH=src:tests python tests/torch_lr_witness.py \\
        [--layers 2] [--seq 2048] [--lrs 1e-3,3e-4,1e-4] [--steps 3] \\
        [--package both|reference|port]

h2o-danube-1.8b at its full width (depth cut to ``--layers``), bfloat16
parameters with the float32 master copy, one sequence of ``--seq`` tokens
from the seeded synthetic pipeline, stepped ``--steps`` times on that one
batch as ``chip_smoke.py``'s train path does. The parameters are drawn with
numpy (``test_torch_families.numpy_params``) and carried over to both
packages, so the two columns of each line differ only by the packages'
arithmetic. Both run on the CPU; a JSON line per learning rate.
``--package`` runs one of them alone (half the memory at a larger depth).

It is the witness for the train path's learning rate: where a rate makes
the port's loss rise at the second step, the reference's rises with it.
Not a test (it takes minutes at full width); run it by hand.
"""
import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.configs import base as jbase
from repro.models import Model as JModel
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import trainer as jtrainer

from repro_torch.configs import base as tbase
from repro_torch.data import DataConfig, Pipeline
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainConfig, init_opt_state, make_train_step
from test_torch_families import numpy_params

ARCH = "h2o-danube-1.8b"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lrs", default="1e-3,3e-4,1e-4")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--package", default="both",
                    choices=("both", "reference", "port"))
    args = ap.parse_args()
    jcfg = jbase.get_config(ARCH).replace(n_layers=args.layers)
    tcfg = tbase.get_config(ARCH).replace(n_layers=args.layers)
    jm, tm = JModel(jcfg), Model(tcfg)
    tree = numpy_params(tm.param_defs())
    nb = Pipeline(DataConfig(seq_len=args.seq, global_batch=1,
                             vocab=tcfg.vocab)).next()
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()}
    for lr in (float(x) for x in args.lrs.split(",")):
        t0 = time.perf_counter()
        jl, jn, tl, tn = [], [], [], []
        if args.package != "port":
            jl, jn = reference_steps(jm, tree, jb, lr, args.steps)
        if args.package != "reference":
            tl, tn = port_steps(tm, tree, tb, lr, args.steps)
        print(json.dumps(dict(
            arch=ARCH, n_layers=args.layers, seq=args.seq,
            dtype=tcfg.dtype, lr=lr, reference_losses=jl, port_losses=tl,
            reference_grad_norms=jn, port_grad_norms=tn,
            seconds=round(time.perf_counter() - t0, 1))), flush=True)


def reference_steps(jm, tree, jb, lr, steps):
    """Losses and gradient norms of ``steps`` reference train steps."""
    jtc = jtrainer.TrainConfig(optimizer=JAdamWConfig(lr=lr))
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.dtype(jm.cfg.dtype)), tree)
    jo = jtrainer.init_opt_state(jm, jp, jtc)
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    losses, norms = [], []
    for i in range(steps):
        jp, jo, met = jstep(jp, jo, jb, jnp.int32(i))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms


def port_steps(tm, tree, tb, lr, steps):
    """The same for the port's train step."""
    ttc = TrainConfig(optimizer=AdamWConfig(lr=lr))
    tp = params_from_jax(tree, tm.cfg, "cpu")
    to = init_opt_state(tm, tp, ttc, device="cpu")
    tstep = make_train_step(tm, ttc)
    losses, norms = [], []
    for i in range(steps):
        tp, to, met = tstep(tp, to, tb, i)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms


if __name__ == "__main__":
    main()
