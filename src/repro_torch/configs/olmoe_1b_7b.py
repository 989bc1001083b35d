"""olmoe-1b-7b — MoE decoder: 64 experts, top-8, MHA.

[arXiv:2409.02060; hf] 16L d_model=2048 16H (kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024, renormalize=False),
    rope_theta=1e4, grad_accum=4,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, renormalize=False),
    dtype="float32", grad_accum=1,
)
