"""The port's WKV6 recurrence (plain loop, and the custom op's CPU
registration that ``impl='interpret'`` runs) against the reference
package's oracle and its Pallas kernel in interpret mode, and the fused
quantize epilogue on ``y`` against the unfused op + ``quantize_dynamic``.

The CUDA kernel itself has no CPU mode: ``chip_smoke.py`` holds it against
the plain loop on the card. Its order of operations is emulated here
(``kernel_order``) and held against the reference. Inputs are made with
numpy from a seed and handed to both packages."""
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


def kernel_order(r, k, v, w, u, s0, R=4):
    """f32 emulation of ``csrc/wkv6.cu``'s arithmetic: the hd / R lanes of a
    column each hold R contiguous state rows; a lane's y partial starts at
    v_j * (sum over its rows of (r_i u_i) k_i, an fma chain) and takes the
    fma chain r_i S_ij over its rows in order; the lanes' partials are
    summed in the kernel's shuffle tree (level l adds lanes g and g ^ 2^l,
    the pairwise tree over the lanes in order). The state update is the
    plain loop's. An fma is emulated in f64 and rounded once more to f32,
    which can differ from one rounding in the last bit in rare cases."""
    f32 = torch.float32
    r, k, v, w, u, s = (t.to(f32) for t in (r, k, v, w, u, s0))
    B, H, S, hd = r.shape
    G = hd // R

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).to(f32)

    ys = []
    for t in range(S):
        rt, kt, vt = (x[:, :, t].reshape(B, H, G, R) for x in (r, k, v))
        ru = rt * u.reshape(H, G, R)
        bp = torch.zeros(B, H, G, dtype=f32)
        for i in range(R):
            bp = fma(ru[..., i], kt[..., i], bp)
        p = v[:, :, t, None, :] * bp[..., None]              # (B, H, G, hd)
        s4 = s.reshape(B, H, G, R, hd)
        for i in range(R):
            p = fma(rt[..., i, None], s4[:, :, :, i], p)
        while p.shape[2] > 1:
            p = p[:, :, 0::2] + p[:, :, 1::2]
        ys.append(p[:, :, 0])
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(ys, dim=2), s


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_kernel_order_matches_reference(i):
    """The kernel's summation order (R = 4 rows a lane, the default tiling
    at every head dim) against the reference's oracle and its Pallas kernel
    in interpret mode at 1e-4; its state bit-equal to the port's loop."""
    xs, (y_ref, s_ref, y_pal, s_pal) = case_data(i)
    y, sT = kernel_order(*T(xs))
    for a in (y_ref, y_pal):
        assert np.abs(y.numpy() - a).max() < 1e-4
    assert np.abs(sT.numpy() - s_ref).max() < 1e-4
    assert torch.equal(sT, wkv6_ref(*T(xs))[1])


def path_like_inputs(B, H, S, hd, seed):
    """As ``chip_smoke.wkv_inputs`` makes them: r, k, v rounded to bf16,
    w = exp(-exp(0.5 n - 0.5)), u and s0 at 0.1 n."""
    g = np.random.RandomState(seed)
    rkv = [torch.from_numpy(g.randn(B, H, S, hd).astype(np.float32))
           .to(torch.bfloat16).to(torch.float32).numpy() for _ in range(3)]
    w = np.exp(-np.exp(g.randn(B, H, S, hd) * 0.5 - 0.5)).astype(np.float32)
    u = (g.randn(H, hd) * 0.1).astype(np.float32)
    s0 = (g.randn(B, H, hd, hd) * 0.1).astype(np.float32)
    return rkv + [w, u, s0]


@functools.lru_cache(maxsize=None)
def path_like_data():
    xs = path_like_inputs(1, 4, 1024, 64, 11)
    y_ref, s_ref = (np.asarray(a) for a in jax_wkv6_ref(
        *[jnp.asarray(x) for x in xs]))
    return xs, y_ref, s_ref


def test_kernel_order_path_like():
    """At a path-like shape (64 channels, 1024 tokens, the path's decays),
    the kernel's order (R = 4 rows a lane) within 1e-4 * max|y| of the
    reference's oracle; the state bit-equal to the port's plain loop."""
    xs, y_ref, s_ref = path_like_data()
    y, sT = kernel_order(*T(xs))
    tol = 1e-4 * np.abs(y_ref).max()
    assert np.abs(y.numpy() - y_ref).max() < tol
    assert torch.equal(sT, wkv6_ref(*T(xs))[1])
    assert np.abs(sT.numpy() - s_ref).max() < 1e-4 * np.abs(s_ref).max()


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


def _views(dtype):
    """Tensors of shape (1, 2, 8, 16), named by how they lie in memory."""
    x = torch.arange(1 * 8 * 2 * 16, dtype=torch.float32).to(dtype)
    big = torch.zeros(1, 2, 8, 17, dtype=dtype)
    big[..., 1:] = x.reshape(1, 2, 8, 16)
    flat = torch.zeros(x.numel() + 1, dtype=dtype)
    flat[1:] = x
    return {
        "heads-of-tokens": (x.reshape(1, 8, 2, 16).permute(0, 2, 1, 3), True),
        "contiguous": (x.reshape(1, 2, 8, 16), True),
        "odd-offset": (big[..., 1:], False),
        "misaligned-base": (flat[1:].reshape(1, 2, 8, 16), False),
        "last-axis-strided": (x.reshape(1, 2, 16, 8).transpose(-1, -2),
                              False),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(_views(torch.float32)))
def test_kernel_operand_alignment(name, dtype):
    """The kernel reads r / k / v / w in 16-byte loads: a view it can read
    (the path's (B, S, H, hd) tensors seen as (B, H, S, hd)) is passed as it
    is, any other is copied contiguous, to an aligned base, values equal."""
    from repro_torch.kernels.rwkv6 import kernel as wk
    t, as_is = _views(dtype)[name]
    got = wk.aligned(t)
    assert torch.equal(got, t)
    assert (got.data_ptr() == t.data_ptr()) == as_is
    per = 16 // got.element_size()
    assert got.stride(-1) == 1 and got.data_ptr() % 16 == 0
    assert all(s % per == 0 for s in got.stride()[:-1])
