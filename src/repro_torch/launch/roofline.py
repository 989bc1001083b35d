"""Roofline analysis of the port's dry-run records (``launch.dryrun``).

Three terms per (arch x shape) cell on a mesh of H100s:

  compute    T_c = FLOPs_global / (devices * 989e12 bf16 FLOP/s)
  memory     T_m = bytes_global / (devices * 3.35e12 B/s HBM3)
  collective T_x = collective_bytes_per_device / 450e9 B/s NVLink

The rates are the NVIDIA H100 80GB HBM3 (SXM5) data sheet's ("NVIDIA H100
Tensor Core GPU Datasheet"): dense bf16 tensor cores and HBM3 as
``core/speedup.py`` takes them, and NVLink 4 at 900 GB/s, 450 GB/s a
direction. FLOPs and bytes come from ``profile_counts`` run on meta tensors;
the byte term is the un-fused per-op census unless the record carries the
fused one. The port has no HLO and so no collective census: a record
without ``collectives`` has its collective term reported as not measured,
never as 0, and the dominant term is taken over the measured ones.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.core.speedup import HBM_BW, PEAK_BF16_FLOPS

PEAK_FLOPS = PEAK_BF16_FLOPS  # 989e12 bf16 dense, per H100
LINK_BW = 450e9               # bytes/s, NVLink 4, one direction
DEVICE = "NVIDIA H100 80GB HBM3"

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dirname: str, mesh: str = "pod16x16") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, f"*__{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def analyze(rec: Dict) -> Dict:
    chips = rec["n_devices"]
    t_c = rec["jaxpr_flops"] / (chips * PEAK_FLOPS)
    nbytes = rec.get("jaxpr_bytes_fused", rec["jaxpr_bytes"])
    t_m = nbytes / (chips * HBM_BW)
    coll = rec.get("collectives")
    t_x: Optional[float] = (None if coll is None
                            else coll["total_bytes"] / LINK_BW)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    measured = {k: v for k, v in terms.items() if v is not None}
    dom = max(measured, key=measured.get)
    useful = rec["model_flops"] / max(rec["jaxpr_flops"], 1.0)
    t_ideal = rec["model_flops"] / (chips * PEAK_FLOPS)
    frac = t_ideal / max(measured[dom], 1e-30)
    mem = rec["memory"]
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "dominant": dom, "useful_ratio": useful,
        "roofline_frac": frac,
        "hbm_gb_per_dev": (mem["argument_bytes"]
                           + (mem.get("temp_bytes") or 0)) / 1e9,
    }


_ADVICE = {
    ("compute",): "raise useful-FLOP ratio (less remat recompute, tighter "
                  "capacity factor, fp8 matmul inputs)",
    ("memory",): "cut bytes: fuse elementwise chains, larger microbatch, "
                 "bf16 collectives/state, ring SWA cache",
    ("collective",): "reshard: keep FSDP gathers off the critical path, "
                     "bf16 gradient all-reduce, 2D all-gather",
}


def advice(dom: str) -> str:
    return _ADVICE[(dom,)]


def _s(v: Optional[float]) -> str:
    return "not measured" if v is None else f"{v:.3f}"


def table(rows: List[Dict]) -> str:
    rows = sorted(rows, key=lambda r: (r["arch"],
                                       SHAPE_ORDER.index(r["shape"])))
    out = ["| arch | shape | T_compute (s) | T_memory (s) | T_collective (s) "
           "| dominant | 6ND/counted | roofline frac | HBM GB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {_s(r['t_compute_s'])} | "
            f"{_s(r['t_memory_s'])} | {_s(r['t_collective_s'])} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.2f} | {r['hbm_gb_per_dev']:.1f} |")
    return "\n".join(out)


def main(argv=None):
    from repro_torch.launch.dryrun import OUT_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    recs = [r for r in load(args.dir, args.mesh)
            if r.get("ok") and r.get("jaxpr_flops") is not None]
    rows = [analyze(r) for r in recs]
    md = table(rows)
    print(f"rates: {DEVICE}, {PEAK_FLOPS:.3g} FLOP/s bf16, "
          f"{HBM_BW:.3g} B/s HBM3, {LINK_BW:.3g} B/s NVLink")
    print(md)
    doms: Dict[str, int] = {}
    for r in rows:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    print(f"\ndominant-term census: {doms}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
    return rows


if __name__ == "__main__":
    main()
