"""Truncated gradients of hymba-1.5b's Mamba and of seamless-m4t-large-v2
without ``remat`` equal to the reference's under policies that round one
primitive (ROADMAP Queue C 26 and 27).

``test_torch_grad_values_families.leaf_shares``' measure on the smoke
configs (B = 2, S = 16, e8m3): the losses equal at rtol 1e-6, and in every
gradient leaf at most 1 % of the elements more than 1e-3 relative from the
reference's. What differed before, and the repair of each:

  * hymba under ``layer/mamba`` rounding ``add_any`` alone (33 % of
    ``a_log``, ``dt_proj``, ``dt_bias``) or ``mul`` alone (9 % of
    ``dt_bias``): the recurrence read ``da[:, t]``, ``dbx[:, t]`` and
    ``Cc[:, t]`` step by step (and ``dt[:, sl]`` and the like chunk by
    chunk), whose cotangents autograd summed with ``add_any`` sites the
    reference's scans do not have (they stack them): the loops now take
    their inputs from one ``split`` / ``unbind``. The final state's and
    ``A``'s cotangent sums start at zero, as the scan transposes start them
    (``zero_cotangents``, ``loop_const``). ``softplus`` differentiated
    through ``log1p``'s and ``abs``'s derivatives (a ``div`` and ``add_any``
    sites), where the reference's custom JVP multiplies the cotangent by the
    residual ``exp(x - out)`` (``models.common._Softplus``);
  * hymba under ``**`` rounding ``add_any`` alone (99.6 % of the norms'
    scales): the reference scans a slice of the stacked layers per segment
    and indexes the stack for each global layer, so every stacked leaf's
    gradient is a sum of the segments' (``add_any`` sites at the root);
    the port unstacked the whole stack once (``models.transformer.forward``
    now slices per segment, as the reference does);
  * seamless without ``remat`` under ``dec_layer/cross_attn`` rounding
    ``add_any`` (98 % of every encoder leaf): the reference adds each
    decoder layer's cotangents of the encoder's output (v's, then k's) to a
    running sum that starts at zero, under the cross attention; autograd
    began the sum with the first term, unrounded
    (``models.encdec.forward``'s ``zero_cotangents``).

The hymba site differences left (``test_torch_grad_scopes.FAMILY_PINNED``)
move no value: ``test_hymba_pinned_sites_change_no_value``.
"""
import pytest

from test_torch_grad_scopes import FAMILY_PINNED
from test_torch_grad_values_families import assert_same_gradients


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("ops", [("add_any",), ("mul",)])
def test_hymba_mamba_under_one_primitive(ops, remat):
    assert_same_gradients("hymba-1.5b", remat, "layer/mamba", "e8m3", ops)


def test_hymba_everywhere_add_any():
    assert_same_gradients("hymba-1.5b", False, "**", "e8m3", ("add_any",))


@pytest.mark.parametrize("scope_", ["dec_layer/cross_attn", "dec_layer/**",
                                    "**"])
def test_seamless_without_remat_under_add_any(scope_):
    assert_same_gradients("seamless-m4t-large-v2", False, scope_, "e8m3",
                          ("add_any",))


@pytest.mark.parametrize("remat,scope_", [(False, "layer/mamba"),
                                          (True, "layer/mamba")])
def test_hymba_pinned_sites_change_no_value(remat, scope_):
    ref_only, port_only = FAMILY_PINNED[("hymba-1.5b", remat)][1][scope_]
    assert_same_gradients("hymba-1.5b", remat, scope_, "e5m2",
                          tuple(sorted(set(ref_only) | set(port_only))))
