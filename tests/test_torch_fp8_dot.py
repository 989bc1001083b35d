"""The native fp8 dot path of the port (``repro_torch.kernels.fp8_dot``,
``truncate(..., native_fp8=True)``) held to the reference package's
(``repro.kernels.fp8_dot``).

* The operand quantizer and the fp8 storage cast: bit for bit, over all
  65536 float16 bit patterns, saturating (``E4M3``) and not (``E4M3FN``).
* The plain ``fp8_dot_general``: the reference's values at ``rtol 1e-6,
  atol 1e-5``, as ``tests/test_fused_epilogue.py`` holds native against
  emulated (identical operand values; the f32 sums may run in another
  order).
* The kernel's operand layout on the CPU: ``pack_k_major`` writes each
  operand K-major, zero-padded to whole k-tiles, with the values
  ``encode_e4m3`` stores; ``fp8_dot_general`` goes through it on the plain
  path too, and the packed wrapper raises on what the kernel does not take.
* ``truncate(native_fp8=True)`` against the port's emulated path and the
  reference's native path, on the reference's toy dot and on the 2-layer
  smoke h2o-danube-1.8b loss under an e4m3 ``quantize_dot_inputs`` rule on
  ``**/mlp``.

The CUDA kernel has no CPU mode: ``chip_smoke.py`` holds it against the
plain version on the card, within ``K * 2^-23 * (|Aq| @ |Bq|)``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jc
from repro.kernels import fp8_dot as jf

import repro_torch.core as tc
from repro_torch.kernels import fp8_dot as tf
from repro_torch.kernels.quantize_em.ops import quantize

from test_torch_families import setup


def _all_f16() -> np.ndarray:
    return np.arange(65536, dtype=np.uint32).astype(np.uint16).view(
        np.float16).astype(np.float32)


@pytest.mark.parametrize("saturate", [True, False])
def test_operand_quantizer_bits_over_every_float16(saturate):
    x = _all_f16()
    want = np.asarray(jf.quantize_dot_operand(jnp.asarray(x),
                                              saturate=saturate))
    got = tf.quantize_dot_operand(torch.from_numpy(x),
                                  saturate=saturate).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("saturate", [True, False])
def test_storage_cast_bits_over_every_float16(saturate):
    """Every pre-rounded value, +/-inf (which pre-round to themselves) and
    NaN: the same fp8 byte, an inf stored as NaN."""
    x = _all_f16()
    jq = jf.quantize_dot_operand(jnp.asarray(x), saturate=saturate)
    want = np.asarray(jf.encode_e4m3(jq)).view(np.uint8)
    tq = tf.quantize_dot_operand(torch.from_numpy(x), saturate=saturate)
    got = tf.encode_e4m3(tq).view(torch.uint8).numpy()
    nan = np.isnan(x) | np.isinf(x) | ~np.isfinite(np.asarray(jq))
    np.testing.assert_array_equal(got[~nan], want[~nan])
    # fp8 NaN is s1111111; the sign bit of a NaN carries no value
    assert ((got[nan] & 0x7F) == 0x7F).all() and \
        ((want[nan] & 0x7F) == 0x7F).all()
    # the cast is exact on the grid: decoding gives the pre-rounded value
    back = tf.encode_e4m3(tq).to(torch.float32).numpy()
    np.testing.assert_array_equal(back[~nan], tq.numpy()[~nan])


def test_native_format_rule_is_the_reference():
    for spec in ("e4m3", "e4m3fn", "e4m3s", "e5m2", "e8m3"):
        fmt = tc.parse_format(spec)
        assert tf.is_native_fp8_format(fmt) == jf.is_native_fp8_format(
            jc.parse_format(spec)), spec
    for args in ((4, 3, False, True), (4, 3, True, False), (4, 2, True, False)):
        assert tf.is_native_fp8_format(tc.FPFormat(*args)) == \
            jf.is_native_fp8_format(jc.FPFormat(*args)), args
    assert tf.F8_DTYPE == torch.float8_e4m3fn


DOTS = {
    "mm": ((64, 40), (40, 24), (((1,), (0,)), ((), ()))),
    "bmm": ((3, 17, 33), (3, 33, 9), (((2,), (1,)), ((0,), (0,)))),
    "rhs_transposed": ((16, 48), (20, 48), (((1,), (1,)), ((), ()))),
    "two_contracting": ((2, 5, 6, 7), (6, 7, 2, 3),
                        (((2, 3), (0, 1)), ((0,), (2,)))),
}


@pytest.mark.parametrize("name", sorted(DOTS))
@pytest.mark.parametrize("saturate", [True, False])
def test_plain_fp8_dot_general_equals_the_reference(name, saturate):
    ls, rs, dn = DOTS[name]
    r = np.random.RandomState(len(name))
    a = (r.randn(*ls) * 40).astype(np.float32)
    b = (r.randn(*rs) * 40).astype(np.float32)
    a.flat[::17] = 1e4                      # out of e4m3's range
    want = np.asarray(jf.fp8_dot_general(jnp.asarray(a), jnp.asarray(b), dn,
                                         saturate=saturate))
    got = tf.fp8_dot_general(torch.from_numpy(a), torch.from_numpy(b), dn,
                             saturate=saturate).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert np.isnan(got).any() == (not saturate)


def test_fp8_dot_general_writes_the_out_dtype():
    a = torch.from_numpy(np.random.RandomState(0).randn(8, 16)
                         .astype(np.float32))
    dn = (((1,), (0,)), ((), ()))
    for dt in (torch.bfloat16, torch.float16, torch.float64):
        out = tf.fp8_dot_general(a, a.T.contiguous(), dn, out_dtype=dt)
        assert out.dtype == dt
        f32 = tf.fp8_dot_general(a, a.T.contiguous(), dn)
        assert torch.equal(out, f32.to(dt))


def test_cuda_impl_on_a_cpu_tensor_raises():
    a = torch.ones(4, 4)
    dn = (((1,), (0,)), ((), ()))
    with pytest.raises(ValueError, match="impl='cuda'"):
        tf.fp8_dot_general(a, a, dn, impl="cuda")
    q = tf.encode_e4m3(a)[None]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tf.fp8_dot_cuda(q, q)
    assert tf.fp8_dot_cuda.launches == 0


@pytest.mark.parametrize("k", [1, 100, 128, 131, 300])
@pytest.mark.parametrize("source", ["grid_f32", "fp8", "fp8_transposed"])
def test_packed_operands_decode_to_the_same_values(k, source):
    """K-major, contiguous, K padded with zeros to a whole k-tile, and the
    first K columns the bytes ``encode_e4m3`` stores (an inf as NaN),
    whatever the source's dtype and strides."""
    r = np.random.RandomState(k)
    x = torch.from_numpy((r.randn(3, 7, k) * 50).astype(np.float32))
    x[0, 1, 0] = float("inf")
    xq = tf.quantize_dot_operand(x)
    want = tf.encode_e4m3(xq).view(torch.uint8)
    if source == "grid_f32":
        src = xq
    elif source == "fp8":
        src = tf.encode_e4m3(xq)
    else:                       # (3, 7, k) as a transposed view
        src = tf.encode_e4m3(xq).transpose(1, 2).contiguous().transpose(1, 2)
    p = tf.pack_k_major(src)
    kp = tf.packed_k(k)
    assert p.dtype == tf.F8_DTYPE and p.is_contiguous()
    assert tuple(p.shape) == (3, 7, kp) and kp % tf.K_TILE == 0 and kp >= k
    bits = p.view(torch.uint8)
    assert torch.equal(bits[..., :k], want)
    assert not bits[..., k:].any()
    assert torch.isnan(p[0, 1, 0].float())


@pytest.mark.parametrize("name", ["mm", "bmm", "rhs_transposed"])
def test_fp8_dot_general_goes_through_the_pack(name, monkeypatch):
    """The plain path packs both operands as the card's path does -- the
    lhs as (batch, M, K), the rhs as (batch, N, K) -- and equals the
    reference."""
    ls, rs, dn = DOTS[name]
    r = np.random.RandomState(7)
    a = (r.randn(*ls) * 40).astype(np.float32)
    b = (r.randn(*rs) * 40).astype(np.float32)
    packed = []
    pack = tf.pack_k_major

    def spy(x):
        out = pack(x)
        packed.append((tuple(x.shape), tuple(out.shape)))
        return out

    monkeypatch.setattr(tf, "pack_k_major", spy)
    got = tf.fp8_dot_general(torch.from_numpy(a), torch.from_numpy(b),
                             dn).numpy()
    want = np.asarray(jf.fp8_dot_general(jnp.asarray(a), jnp.asarray(b), dn))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    (lc, rc), (lb, rb) = dn
    k = int(np.prod([ls[d] for d in lc]))
    nb = int(np.prod([ls[d] for d in lb]))
    m = int(np.prod(ls)) // (k * nb)
    n = int(np.prod(rs)) // (k * nb)
    assert packed == [((nb, m, k), (nb, m, tf.packed_k(k))),
                      ((nb, n, k), (nb, n, tf.packed_k(k)))]


def test_packed_wrapper_raises_on_what_the_kernel_does_not_take():
    p = tf.pack_k_major(tf.encode_e4m3(torch.ones(2, 8, 40)))
    q = tf.pack_k_major(tf.encode_e4m3(torch.ones(2, 5, 300)))
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tf.fp8_dot_packed(p.float(), p)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tf.fp8_dot_packed(p[0], p[0])
    with pytest.raises(ValueError, match="multiple of 128"):
        tf.fp8_dot_packed(p[..., :64].contiguous(), p[..., :64].contiguous())
    with pytest.raises(ValueError, match="packed K-major"):
        tf.fp8_dot_packed(p.transpose(0, 1).contiguous().transpose(0, 1), p)
    with pytest.raises(ValueError, match="do not contract"):
        tf.fp8_dot_packed(p, q)
    with pytest.raises(TypeError, match="f32/bf16/f16"):
        tf.fp8_dot_packed(p, p, torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tf.fp8_dot_packed(p, p)
    with pytest.raises(ValueError, match="route"):
        tf.mma_probe(p[0], p[0], "tf32", 1)
    assert tf.fp8_dot_cuda.launches == 0


def _toy_policy(pkg, fmt="E4M3"):
    rule = pkg.TruncationRule(fmt=getattr(pkg, fmt), scope="*",
                              ops=("dot_general",), quantize_dot_inputs=True)
    return pkg.TruncationPolicy(rules=(rule,))


@pytest.mark.parametrize("fmt", ["E4M3", "E4M3FN"])
def test_native_truncate_matches_emulated_and_the_reference(fmt):
    """The reference's ``test_native_fp8_truncate_matches_emulated``: a
    toy ``a @ b`` under an e4m3 dot-input rule, native against emulated in
    the port and against the reference's native path."""
    r = np.random.RandomState(3)
    a, b = r.randn(64, 32).astype(np.float32), \
        r.randn(32, 48).astype(np.float32)

    def f(x, y):
        return x @ y

    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    emu = tc.truncate(f, _toy_policy(tc, fmt), impl="ref")(ta, tb)
    nat = tc.truncate(f, _toy_policy(tc, fmt), impl="ref",
                      native_fp8=True)(ta, tb)
    np.testing.assert_allclose(nat.numpy(), emu.numpy(), rtol=1e-6,
                               atol=1e-5)
    jnat = jc.truncate(f, _toy_policy(jc, fmt), impl="ref",
                       native_fp8=True)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(nat.numpy(), np.asarray(jnat), rtol=1e-6,
                               atol=1e-5)


def test_non_native_rules_keep_the_emulated_path():
    """An IEEE-inf e4m3 rule, an e5m2 rule and a masked rule are not
    native: the native flag changes no bit."""
    r = np.random.RandomState(4)
    a = torch.from_numpy(r.randn(16, 8).astype(np.float32))
    b = torch.from_numpy(r.randn(8, 4).astype(np.float32))
    rules = [tc.TruncationRule(fmt=tc.FPFormat(4, 3), scope="*",
                               ops=("dot_general",), quantize_dot_inputs=True),
             tc.TruncationRule(fmt=tc.E5M2, scope="*", ops=("dot_general",),
                               quantize_dot_inputs=True),
             tc.TruncationRule(fmt=tc.E4M3, scope="*", ops=("dot_general",),
                               quantize_dot_inputs=True,
                               mask=tc.magnitude_below(1.0))]
    for rule in rules:
        pol = tc.TruncationPolicy(rules=(rule,))
        emu = tc.truncate(lambda x, y: x @ y, pol)(a, b)
        nat = tc.truncate(lambda x, y: x @ y, pol, native_fp8=True)(a, b)
        assert torch.equal(emu, nat), rule


def test_native_fp8_on_the_smoke_model_loss():
    """The 2-layer smoke h2o-danube-1.8b loss under an e4m3 dot-input rule
    on ``**/mlp``: native within ``rtol 1e-6`` of the port's emulated loss
    and of the reference's native loss (the MLP dots take the native path,
    every other op runs as it is)."""
    jm, jp, jb, tm, tp, tb = setup("h2o-danube-1.8b", B=2, S=16)

    def pol(pkg):
        return pkg.TruncationPolicy(rules=(pkg.TruncationRule(
            fmt=pkg.E4M3, scope="**/mlp", ops=("dot_general",),
            quantize_dot_inputs=True),))

    calls = []
    real = tf.fp8_aten_dot

    def spy(func, args, **kw):
        calls.append(func)
        return real(func, args, **kw)

    tf_mod = __import__("repro_torch.core.interpreter",
                        fromlist=["_fp8"])._fp8
    tf_mod.fp8_aten_dot = spy
    try:
        wrapped = tc.truncate(tm.loss, pol(tc), native_fp8=True)
        nat = wrapped(tp, tb)
        nat2 = wrapped(tp, tb)
    finally:
        tf_mod.fp8_aten_dot = real
    assert wrapped.n_traces == 1 and torch.equal(nat, nat2)
    # two MLP dots a layer (wi, wo), two layers, two calls
    assert len(calls) == 2 * 2 * 2
    emu = tc.truncate(tm.loss, pol(tc))(tp, tb)
    plain = tm.loss(tp, tb)
    jnat = jc.truncate(jm.loss, pol(jc), native_fp8=True)(jp, jb)
    np.testing.assert_allclose(float(nat), float(emu), rtol=1e-6)
    np.testing.assert_allclose(float(nat), float(jnat), rtol=1e-6)
    assert float(nat) != float(plain)
