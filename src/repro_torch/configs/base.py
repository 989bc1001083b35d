"""Architecture config schema + the assigned input-shape set + registry
(same fields, shapes and configurations as the reference package's
``configs/base.py``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_k_dense: int = 0
    d_ff_dense: int = 0           # d_ff of the leading dense layers
    renormalize: bool = True
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int
    kv_lora: int
    rope_head_dim: int
    nope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    dt_rank: int = 0              # 0 -> ceil(d_model/16)
    expand: int = 1               # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    attn_type: str = "gqa"        # gqa | mla | rwkv6 | hymba
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "swiglu"
    rope_type: str = "rope"       # rope | mrope | none
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()   # layer indices using global attn
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    enc_layers: int = 0                   # encoder-decoder only
    cross_attention: bool = False
    input_mode: str = "tokens"            # tokens | embeds (stub frontends)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # execution knobs
    scan_layers: bool = True
    remat: bool = True
    grad_accum: int = 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


# the assigned LM shape set (identical for all 10 archs)
SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# archs with at least one sub-quadratic sequence-mixing path run long_500k;
# pure full-attention archs skip it
LONG_CONTEXT_ARCHS = ("hymba-1.5b", "h2o-danube-1.8b", "rwkv6-7b")

ARCH_IDS = (
    "hymba-1.5b", "glm4-9b", "deepseek-coder-33b", "internlm2-20b",
    "h2o-danube-1.8b", "olmoe-1b-7b", "deepseek-v2-236b", "rwkv6-7b",
    "seamless-m4t-large-v2", "qwen2-vl-7b",
)

# arch id -> module under repro_torch.configs
_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "glm4-9b": "glm4_9b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "internlm2-20b": "internlm2_20b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "rwkv6-7b": "rwkv6_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-vl-7b": "qwen2_vl_7b",
}


def get_config(arch_id: str, variant: str = "full") -> ArchConfig:
    """Load an architecture config: ``variant`` is "full" or "smoke"."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    if variant == "full":
        return mod.CONFIG
    if variant == "smoke":
        return mod.SMOKE
    raise ValueError(f"unknown variant {variant!r}")


def cells(arch_id: str):
    """The (shape, runnable) list for one arch — 4 assigned shapes with the
    long_500k skip rule applied."""
    out = []
    for s in SHAPES.values():
        runnable = (s.name != "long_500k") or (arch_id in LONG_CONTEXT_ARCHS)
        out.append((s, runnable))
    return out
