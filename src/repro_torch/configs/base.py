"""Architecture config schema + registry of the configurations ported so far
(same fields as the reference package's ``configs/base.py``)."""
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


ARCH_IDS = (
    "hymba-1.5b", "glm4-9b", "deepseek-coder-33b", "internlm2-20b",
    "h2o-danube-1.8b", "olmoe-1b-7b", "deepseek-v2-236b", "rwkv6-7b",
    "seamless-m4t-large-v2", "qwen2-vl-7b",
)

# arch id -> module under repro_torch.configs, for the configs ported so far
_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
}


def get_config(arch_id: str, variant: str = "full") -> ArchConfig:
    """Load an architecture config: ``variant`` is "full" or "smoke"."""
    if arch_id not in _MODULES:
        if arch_id in ARCH_IDS:
            raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                           f"{sorted(_MODULES)}")
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    if variant == "full":
        return mod.CONFIG
    if variant == "smoke":
        return mod.SMOKE
    raise ValueError(f"unknown variant {variant!r}")
