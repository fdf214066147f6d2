"""The LM serve path on the card against the port on the CPU.

Every architecture's smoke config, with the same float32 weights on the
card and on the CPU: forward logits and aux, and for the models with a
decode step the prefill and four decode steps, within rtol/atol 1e-4
(``lm_perf.smoke_vs_cpu``); then the full-width checks of ``chip_smoke.py``
phase 15 at a small prompt.  They need a CUDA device and skip without one;
they import no JAX, so on the GPU machine they run without the suite's
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_lm_gpu.py
"""

import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import lm_perf

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_on_the_card_matches_the_cpu(cuda, arch):
    row = lm_perf.smoke_vs_cpu(arch, cuda)
    assert row["max_rel_err"]["forward"] <= lm_perf.F32_TOL


@pytest.mark.parametrize("arch", lm_perf.SERVE_ARCHS)
def test_full_width_serve_checks(cuda, arch):
    """Published widths, bfloat16, 2 prompts of 64 tokens, 8 new tokens."""
    row = lm_perf.serve_case(lm_perf.full_width(arch), device=cuda, batch=2, prompt_len=64,
                             new_tokens=8, chunk=32)
    assert row["max_rel_err_steps"] <= lm_perf.BF16_BAR
    torch.cuda.empty_cache()
