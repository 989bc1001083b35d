"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.

[arXiv:2308.11596; hf] 24L (enc) + 24L (dec) d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206. Speech frontend is a STUB: input_specs() provides
precomputed frame embeddings (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab=256206,
    cross_attention=True, norm="layernorm", act="gelu",
    rope_theta=1e4, grad_accum=4,
)

SMOKE = CONFIG.replace(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, dtype="float32", grad_accum=1,
)
