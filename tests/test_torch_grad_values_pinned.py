"""The site differences pinned for the RWKV-6, MoE and encoder-decoder
families (``test_torch_grad_scopes.FAMILY_PINNED``) move no value: a
policy that rounds only the pinned primitives of a pinned scope, at e5m2,
gives gradients within ``test_torch_grad_values.py``'s measure (the losses
at rtol 1e-6, at most 1 % of a leaf's elements more than 1e-3 relative
apart). A pinned site that changed a value would change it in every
element downstream.

Not here: MLA's ``mla_mix`` row (the attention's pattern, shown on
olmoe-1b-7b and the cross attention; under ``mla_mix`` an fma ulp at the
block's inputs moves the model's loss, ``test_torch_grad_values_mla.py``)
and the encoder-decoder's ``dec_layer/layernorm`` ``add_any`` pair, which
does move values under a policy rounding ``add_any`` alone there (ROADMAP
Queue C 21)."""
import pytest

from test_torch_grad_scopes import FAMILY_PINNED
from test_torch_grad_values_families import assert_same_gradients


def _prims(arch, remat, scope):
    ref_only, port_only = FAMILY_PINNED[(arch, remat)][1][scope]
    return tuple(sorted(set(ref_only) | set(port_only)))


CASES = (
    ("rwkv6-7b", False, "layer/time_mix"),
    ("olmoe-1b-7b", False, "layer/attn/mix"),
    ("deepseek-v2-236b", True, "layer/moe/combine"),
    ("seamless-m4t-large-v2", True, "dec_layer/cross_attn"),
    ("seamless-m4t-large-v2", False, "enc_layer/layernorm"),
)


@pytest.mark.parametrize("arch,remat,scope", CASES)
def test_family_pinned_sites_change_no_value(arch, remat, scope):
    assert_same_gradients(arch, remat, scope, "e5m2",
                          _prims(arch, remat, scope))
