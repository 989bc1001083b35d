"""Truncated gradients of the five families that agreed with the reference
before the repairs of ``test_torch_grad_values_families.py`` keep agreeing:
hymba-1.5b, qwen2-vl-7b, glm4-9b, internlm2-20b and deepseek-coder-33b,
each under its family's scope (``FAMILY_SCOPE``) at e5m7 and e8m3, with
``remat`` on and off, held to the same measure (the losses at rtol 1e-6,
at most 1 % of a leaf's elements more than 1e-3 relative apart). The key
bias ``bk`` of glm4-9b and qwen2-vl-7b has a true gradient of zero and is
compared at the scale of its largest element
(``test_torch_grad_values_families.ZERO_GRADIENT_LEAVES``)."""
import pytest

from test_torch_families import FAMILY_SCOPE
from test_torch_grad_values_families import assert_same_gradients

ARCHS = ("hymba-1.5b", "qwen2-vl-7b", "glm4-9b", "internlm2-20b",
         "deepseek-coder-33b")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("fmt", ["e5m7", "e8m3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_truncated_gradients_keep_equal_to_the_reference(arch, fmt, remat):
    assert_same_gradients(arch, remat, FAMILY_SCOPE[arch], fmt)
