"""The port's training loss, gradients and train step against the JAX
package's for the hybrid and MoE families (``tests/lm_train_parity.py``
sets out the inputs and the bars; the other families are in
``tests/test_torch_lm_train_parity.py``).  deepseek-v2's step runs MLA and
the MoE dispatch, whose capacity each microbatch computes from its own
token count.
"""

import pytest

import lm_train_parity as parity

ARCHS = ["jamba-v0.1-52b", "qwen3-moe-235b-a22b", "deepseek-v2-236b"]


@pytest.mark.parametrize("gather", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, gather):
    parity.check_loss_and_grads(arch, gather)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_mla_moe(microbatches):
    parity.check_train_step("deepseek-v2-236b", microbatches)
