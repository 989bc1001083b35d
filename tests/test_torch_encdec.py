"""The encoder-decoder family (seamless-m4t-large-v2: bidirectional encoder
over stub frame embeddings, causal decoder with cross-attention) against the
reference package's, on the same weights and batch: logits, loss, prefill,
site lists per scope, truncated losses (tolerances and the one listed site
difference as in ``test_torch_families.py``), trajectory steps and the
parameter tree."""
import numpy as np
import pytest

import jax

from repro_torch.models.convert import params_from_jax

from test_torch_families import (
    assert_same_sites, check_forward, check_truncated, prims_by_scope, setup,
    sweep_both,
)
from test_torch_ssm import _steps

ARCH = "seamless-m4t-large-v2"


def test_logits_loss_and_prefill():
    check_forward(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_site_lists_per_scope(dtype):
    jh, th = sweep_both(ARCH, dtype=dtype)
    assert_same_sites(jh, th)
    scopes = prims_by_scope(th)
    assert {"enc_layer/self_attn/qkv", "enc_norm/layernorm",
            "dec_layer/self_attn/mix", "dec_layer/cross_attn",
            "dec_layer/layernorm"} <= set(scopes)
    if dtype == "bfloat16":
        return
    # one layernorm's 17 sites, and 8 more for each further norm of a layer
    # (the jitted variance is one body the reference traces once)
    assert len(scopes["enc_norm/layernorm"]) == 17
    assert len(scopes["enc_layer/layernorm"]) == 17 + 8
    assert len(scopes["dec_layer/layernorm"]) == 17 + 2 * 8


@pytest.mark.parametrize("kind", ["everywhere", "scoped"])
def test_truncated_loss(kind):
    check_truncated(ARCH, kind, "e5m7", 7)


def test_trajectory_steps_are_encoder_then_decoder_layers():
    cfg = setup(ARCH)[3].cfg
    want = cfg.enc_layers + cfg.n_layers
    assert _steps(ARCH) == (want, want)


def test_params_from_jax_encdec_tree():
    _, jp, _, tm, tp, _ = setup(ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    assert set(tp) == {"embed", "enc_layers", "enc_norm", "dec_layers",
                       "final_norm", "lm_head"}
    np.testing.assert_array_equal(
        tp["dec_layers"]["cross_attn"]["wq"].numpy(),
        tree["dec_layers"]["cross_attn"]["wq"])
    enc = {k: v for k, v in tree["enc_layers"].items() if k != "norm2"}
    with pytest.raises(ValueError, match="enc_layers.*expected keys"):
        params_from_jax(dict(tree, enc_layers=enc), tm.cfg, "cpu")
    with pytest.raises(ValueError, match="expected keys"):
        params_from_jax(dict(tree, extra=tree["embed"]), tm.cfg, "cpu")
