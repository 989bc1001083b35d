"""deepseek-v2-236b — MoE decoder with Multi-head Latent Attention.

[arXiv:2405.04434; hf] 60L d_model=5120 128H d_ff=1536 (per routed expert)
vocab=102400; MLA kv_lora=512 (q_lora=1536, rope_dim=64, nope=128, v=128);
2 shared + 160 routed experts, top-6; first layer dense (d_ff 12288).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, MLAConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab=102400,
    attn_type="mla",
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_k_dense=1, d_ff_dense=12288, renormalize=False),
    rope_theta=1e4, grad_accum=16,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
    vocab=256,
    mla=MLAConfig(q_lora=32, kv_lora=32, rope_head_dim=8, nope_head_dim=16,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2,
                  first_k_dense=1, d_ff_dense=128, renormalize=False),
    dtype="float32", grad_accum=1,
)
