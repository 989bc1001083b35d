"""hymba-1.5b — hybrid: parallel attention + Mamba heads per layer.

[arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16. Sliding-window attention everywhere except the
first/middle/last layers (global); meta-token mechanism is out of backbone
scope (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    attn_type="hymba", ssm=SSMConfig(state_dim=16, conv_width=4, expand=1),
    sliding_window=1024, global_layers=(0, 15, 31),
    rope_theta=1e4, grad_accum=8,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=80, n_heads=5, n_kv_heads=1, head_dim=16, d_ff=192,
    vocab=256, sliding_window=16, global_layers=(0, 2),
    ssm=SSMConfig(state_dim=8, conv_width=4, expand=1),
    dtype="float32", grad_accum=1,
)
