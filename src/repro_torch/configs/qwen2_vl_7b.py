"""qwen2-vl-7b — VLM decoder backbone with M-RoPE.

[arXiv:2409.12191; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; M-RoPE sections (16, 24, 24); dynamic-resolution ViT frontend
is a STUB: input_specs() provides precomputed patch embeddings + 3D position
ids (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064,
    qkv_bias=True, rope_type="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1e6, input_mode="embeds", grad_accum=8,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
    vocab=256, mrope_sections=(2, 3, 3), dtype="float32", grad_accum=1,
)
