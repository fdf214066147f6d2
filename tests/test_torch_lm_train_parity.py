"""The port's training loss, gradients and train step against the JAX
package's (``tests/lm_train_parity.py`` sets out the inputs and the bars):
the dense, SSM, VLM and audio families here, the hybrid and MoE families in
``tests/test_torch_lm_train_parity_moe.py``.
"""

import pytest

import lm_train_parity as parity

ARCHS = ["mamba2-370m", "deepseek-7b", "minitron-4b", "mistral-nemo-12b", "qwen3-32b",
         "internvl2-2b", "hubert-xlarge"]


@pytest.mark.parametrize("gather", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, gather):
    parity.check_loss_and_grads(arch, gather)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_dense(microbatches):
    parity.check_train_step("deepseek-7b", microbatches)
