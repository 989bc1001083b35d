"""deepseek-coder-33b — dense llama-arch decoder, GQA kv=8.

[arXiv:2401.14196; hf] 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab=32256,
    rope_theta=1e5, grad_accum=16,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8, d_ff=144,
    vocab=256, dtype="float32", grad_accum=1,
)
