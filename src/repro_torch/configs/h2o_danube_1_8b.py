"""h2o-danube-1.8b — dense decoder, llama+mistral mix, sliding-window attn.

[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab=32000,
    sliding_window=4096, rope_theta=1e4, grad_accum=4,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=160,
    vocab=256, sliding_window=16, dtype="float32", grad_accum=1,
)
