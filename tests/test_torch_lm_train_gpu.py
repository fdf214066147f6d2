"""The LM training path on the card.

Every architecture's smoke config: one train step on the card against the
port on the CPU with the same float32 weights and batch (float32 gather:
the loss within 1e-5, every gradient leaf within 1e-4 of its largest
entry), the card's gradients twice the same bits, and five steps with a
falling loss (``lm_perf.train_vs_cpu``); a resumed run bit-equal to an
unbroken one; and the full-width checks of ``chip_smoke.py`` phase 16 at a
small size (deepseek-7b's widths with 2 layers, 2 x 256 tokens).  They
need a CUDA device and skip without one; they import no JAX, so on the GPU
machine they run without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_lm_train_gpu.py
"""

import dataclasses

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
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch):
    row = lm_perf.train_vs_cpu(arch, cuda)
    assert row["max_grad_gap"] <= lm_perf.GRAD_BAR and row["runs_bit_equal"]


def test_resume_is_bit_equal_on_the_card(cuda, tmp_path):
    assert lm_perf.resume_check(str(tmp_path / "resume"), cuda)["bit_equal"]


def test_full_width_train_checks(cuda):
    """Published widths, 2 layers, bf16 cast: losses finite and falling,
    two runs bit-equal; the remat policies bit-equal."""
    cfg = dataclasses.replace(lm_perf.train_config("deepseek-7b"), n_layers=2)
    row = lm_perf.train_case(cfg, batch=2, seq=256, remat="dots", device=cuda)
    assert row["runs_bit_equal"] and row["losses"][-1] < row["losses"][0]
    assert lm_perf.remat_case(cfg, batch=2, seq=256, device=cuda)["bit_equal"]
    torch.cuda.empty_cache()
