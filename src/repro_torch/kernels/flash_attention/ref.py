"""Plain PyTorch oracle for the flash-attention kernel: naive masked softmax
attention with the KV heads repeated to Hq, f32 math, output in ``v.dtype``.
Memory-hungry (it materialises the (B, Hq, S, S) scores) but obviously
right; the tests hold the kernel's plain versions and the reference
package's oracle against it at small shapes."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None, scale=None):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kr = torch.repeat_interleave(k, G, dim=1)
    vr = torch.repeat_interleave(v, G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     kr.to(torch.float32)) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((S, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (i >= j)
    if window is not None:
        mask = mask & ((i - j) < window)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        vr.to(torch.float32)).to(v.dtype)
