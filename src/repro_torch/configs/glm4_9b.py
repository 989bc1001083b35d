"""glm4-9b — dense decoder, GQA kv=2, partial RoPE, qkv bias.

[hf:THUDM/glm-4-9b; hf] 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=151552,
    qkv_bias=True, rope_fraction=0.5, rope_theta=1e4, grad_accum=8,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
    vocab=256, dtype="float32", grad_accum=1,
)
