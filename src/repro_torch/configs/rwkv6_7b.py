"""rwkv6-7b (Finch) — attention-free, data-dependent decay linear attention.

[arXiv:2404.05892; hf] 32L d_model=4096 d_ff=14336 vocab=65536; 64 heads
of size 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    attn_type="rwkv6", rope_type="none", grad_accum=8,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=160,
    vocab=256, dtype="float32", grad_accum=1,
)
