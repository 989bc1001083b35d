"""The port's WKV6 recurrence (plain loop, and the custom op's CPU
registration that ``impl='interpret'`` runs) against the reference
package's oracle and its Pallas kernel in interpret mode, and the fused
quantize epilogue on ``y`` against the unfused op + ``quantize_dynamic``.

The CUDA kernel itself has no CPU mode: ``chip_smoke.py`` holds it against
the plain loop on the card. Inputs are made with numpy from a seed and
handed to both packages."""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core  # noqa: F401  (import order of the reference package)
from repro.kernels.rwkv6.kernel import wkv6_pallas
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref

from repro_torch.kernels.quantize_em.ops import IDENTITY_ROW, quantize_dynamic
from repro_torch.kernels.rwkv6 import ops as wops
from repro_torch.kernels.rwkv6.ref import wkv6_ref

# tests/test_kernels.py test_wkv6_pallas_vs_ref: B, H, S, hd, chunk
CASES = [(2, 3, 64, 16, 16), (1, 2, 128, 32, 64), (2, 1, 32, 8, 32),
         (1, 4, 64, 64, 64)]
CASE_IDS = ["x".join(map(str, c)) for c in CASES]

ROWS = [
    ("e8m15", [8, 15, 0, 1]), ("e8m10", [8, 10, 0, 1]),
    ("e8m7", [8, 7, 0, 1]), ("e8m5", [8, 5, 0, 1]), ("e8m3", [8, 3, 0, 1]),
    ("e8m2", [8, 2, 0, 1]), ("e5m2", [5, 2, 0, 1]), ("e4m3s", [4, 3, 1, 0]),
    ("e4m3fn", [4, 3, 0, 0]), ("e4m3fn+fault31", [4, 3, 0, 64]),
    ("identity", list(IDENTITY_ROW)),
]
ROW_IDS = [n for n, _ in ROWS]
ROW_VALS = [np.array(r, np.int32) for _, r in ROWS]


def make_inputs(B, H, S, hd, seed):
    r = np.random.RandomState(seed)
    rr, k, v = (r.randn(B, H, S, hd).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-r.randn(B, H, S, hd))) * 0.98 + 0.01) \
        .astype(np.float32)
    u = (r.randn(H, hd) * 0.1).astype(np.float32)
    s0 = (r.randn(B, H, hd, hd) * 0.1).astype(np.float32)
    return rr, k, v, w, u, s0


@functools.lru_cache(maxsize=None)
def case_data(i):
    B, H, S, hd, chunk = CASES[i]
    xs = make_inputs(B, H, S, hd, 2000 + i)
    js = [jnp.asarray(x) for x in xs]
    y_pal, s_pal = wkv6_pallas(*js, chunk=chunk, interpret=True)
    y_ref, s_ref = jax_wkv6_ref(*js)
    return xs, tuple(np.asarray(a) for a in (y_ref, s_ref, y_pal, s_pal))


def T(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_port_matches_reference(i, impl):
    """y and sT of each plain version of the port against the reference's
    oracle and its Pallas kernel body, at the reference's 1e-4."""
    xs, (y_ref, s_ref, y_pal, s_pal) = case_data(i)
    y, sT = wops.wkv6(*T(xs), chunk=CASES[i][-1], impl=impl)
    assert y.dtype == torch.float32 and sT.dtype == torch.float32
    assert tuple(y.shape) == y_ref.shape and tuple(sT.shape) == s_ref.shape
    for got, a, b in ((y, y_ref, y_pal), (sT, s_ref, s_pal)):
        got = got.numpy()
        assert np.abs(got - a).max() < 1e-4
        assert np.abs(got - b).max() < 1e-4


def test_bf16_inputs_are_widened():
    """r/k/v in bf16 and w in f32, as the model produces them: the same as
    widening first, and y / sT stay f32."""
    xs = T(make_inputs(1, 2, 32, 16, 3))
    lo = [x.to(torch.bfloat16) for x in xs[:3]] + xs[3:]
    y, sT = wops.wkv6(*lo, impl="interpret")
    y2, s2 = wkv6_ref(*[x.to(torch.float32) for x in lo])
    assert y.dtype == sT.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(sT, s2)


def test_chunk_invariance():
    """``chunk`` sets only the staging: the results do not depend on it,
    bit for bit (the reference holds its kernel to 1e-4 here)."""
    xs = T(make_inputs(1, 2, 128, 16, 7))
    outs = [wops.wkv6(*xs, chunk=c, impl="interpret") for c in (16, 32, 128)]
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])
    js = [jnp.asarray(x.numpy()) for x in xs]
    for c in (16, 32, 128):
        y_pal = np.asarray(wkv6_pallas(*js, chunk=c, interpret=True)[0])
        assert np.abs(outs[0][0].numpy() - y_pal).max() < 1e-4


def fused_args(seed=0):
    r = np.random.RandomState(seed)
    B, H, S, hd = 1, 2, 64, 16
    rr, k, v = (r.randn(B, H, S, hd).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-r.randn(B, H, S, hd)))).astype(np.float32)
    u = (r.randn(H, hd) * 0.1).astype(np.float32)
    s0 = np.zeros((B, H, hd, hd), np.float32)
    return rr, k, v, w, u, s0


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("row", ROW_VALS, ids=ROW_IDS)
def test_fused_equals_unfused_then_quantize(row, impl):
    """The row rounds y, bit for bit as ``quantize_dynamic`` on the unfused
    y; the recurrence state sT is untouched by it."""
    xs = T(fused_args())
    y_f, s_f = wops.wkv6(*xs, chunk=32, impl=impl, out_fmt=row)
    y, s = wops.wkv6(*xs, chunk=32, impl=impl)
    want = quantize_dynamic(y, row, impl="ref")
    assert torch.equal(y_f.view(torch.int32), want.view(torch.int32))
    assert torch.equal(s_f.view(torch.int32), s.view(torch.int32))


def grid_step(x, e: int, m: int):
    min_exp = 2 - (1 << (e - 1))
    ex = np.floor(np.log2(np.maximum(np.abs(x), 1e-45)))
    return np.exp2(np.maximum(ex, min_exp) - m)


@pytest.mark.parametrize("row", ROW_VALS, ids=ROW_IDS)
def test_fused_against_reference_kernel(row):
    """The port's fused y against the reference's fused Pallas kernel. The
    head-dimension sums are taken in another order, so the unrounded y
    differ by up to the reference's 1e-4; rounding onto a coarse grid maps
    two such values onto the same or a neighbouring grid point. sT is the
    same in both within 1e-4 and untouched by the row."""
    xs = fused_args()
    y, sT = wops.wkv6(*T(xs), chunk=32, impl="interpret", out_fmt=row)
    y_j, s_j = (np.asarray(a) for a in wkv6_pallas(
        *[jnp.asarray(x) for x in xs], chunk=32, interpret=True,
        out_fmt=jnp.asarray(row)))
    y = y.numpy()
    assert np.isfinite(y).all() and np.isfinite(y_j).all()
    assert np.abs(sT.numpy() - s_j).max() < 1e-4
    diff = np.abs(y - y_j)
    e, m = int(row[0]), int(row[1])
    if m >= 23:
        assert diff.max() < 1e-4
    else:
        step = grid_step(np.maximum(np.abs(y), np.abs(y_j)), e, m)
        assert (diff <= step + 1e-4).all()
        assert (diff == 0).mean() > 0.9


@pytest.mark.parametrize("hd,w_dtype,error", [
    (64, "float32", None), (8, "bfloat16", None), (128, "float32", ValueError),
    (12, "float32", ValueError), (16, "float16", TypeError),
], ids=["path", "small-bf16-w", "hd128", "hd12", "f16-w"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(hd, w_dtype,
                                                              error):
    """The CUDA wrapper's shape and dtype checks are plain Python: held here
    on CPU tensors, before any launch could be attempted."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    B, H, S = 1, 2, 8
    r, k, v = (torch.zeros(B, H, S, hd, dtype=torch.bfloat16)
               for _ in range(3))
    w = torch.zeros(B, H, S, hd, dtype=getattr(torch, w_dtype))
    u, s0 = torch.zeros(H, hd), torch.zeros(B, H, hd, hd)
    if error is None:
        wk.check_shapes(r, k, v, w, u, s0)
    else:
        with pytest.raises(error):
            wk.check_shapes(r, k, v, w, u, s0)
    with pytest.raises(ValueError):
        wk.check_shapes(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wk.wkv6_cuda(r, k, v, w, u, s0, None, 64)
