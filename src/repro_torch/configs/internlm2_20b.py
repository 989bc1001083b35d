"""internlm2-20b — dense llama-arch decoder, GQA kv=8.

[arXiv:2403.17297; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92544,
    rope_theta=1e6, grad_accum=8,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=1, head_dim=8, d_ff=128,
    vocab=256, dtype="float32", grad_accum=1,
)
