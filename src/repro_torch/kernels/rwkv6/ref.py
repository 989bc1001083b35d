"""Plain PyTorch oracle for the WKV6 recurrence: a Python loop over tokens.

Per (batch, head), with per-token, per-channel decay ``w_t`` in (0, 1):

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

All math in f32. The state update is elementwise (one product and one sum
per element, each rounded), so the CUDA kernel's state is bit-equal to this
loop's; ``y_t`` is a sum over the head dimension, taken in another order on
the card."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0):
    """r/k/v/w: (B, H, S, hd); u: (H, hd); s0: (B, H, hd, hd).
    Returns (y (B, H, S, hd) f32, sT (B, H, hd, hd) f32)."""
    f32 = torch.float32
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    u = u.to(f32)
    s = s0.to(f32)
    ys = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]          # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, :, t],
                               s + u[..., None] * kv))
        s = w[:, :, t, :, None] * s + kv
    if not ys:
        return r.new_zeros(r.shape), s.clone()
    return torch.stack(ys, dim=2), s
