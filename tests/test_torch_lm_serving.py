"""The port's serve path against the JAX package's, with the reference's
weights carried over (``from_jax_params``), for the five decode families of
``tests/test_serving.py`` at smoke width on the CPU.

Bars: prefill and every decode step's logits within rtol/atol 2e-4 of the
reference's ``model_forward`` over the whole sequence (the bar of
``tests/test_serving.py``); chunked prefill (chunk 16) within 3e-4 of the
flat prefill (that test's chunked bar); greedy tokens equal to the
reference ``generate``'s.  Each reference runs once per architecture.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.models.model import cache_init as j_cache_init
from repro.models.model import model_forward as j_forward
from repro.models.model import model_init as j_init
from repro.models.model import model_prefill as j_prefill
from repro.serving.engine import generate as j_generate
from repro_torch.configs import get_smoke_config
from repro_torch.launch import lm_perf
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import (
    cache_init,
    model_decode,
    model_init,
    model_prefill,
    model_prefill_chunked,
)
from repro_torch.models.weights import from_jax_params
from repro_torch.serving import ServeConfig, generate

ROOT = Path(__file__).resolve().parents[1]
DECODE_ARCHS = [
    "deepseek-7b",  # dense GQA
    "qwen3-32b",  # qk_norm
    "mamba2-370m",  # pure SSM state
    "jamba-v0.1-52b",  # hybrid + MoE
    "deepseek-v2-236b",  # MLA latent cache
]
CHUNKED_ARCHS = ["deepseek-7b", "mamba2-370m", "jamba-v0.1-52b", "deepseek-v2-236b"]
B, S_PROMPT, N_DEC = 2, 32, 4
TOL = dict(rtol=2e-4, atol=2e-4)
CHUNK_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module")
def lm():
    """Per architecture (built on first use): the reference's params, the
    port's model holding them, the token sequence and the reference's
    forward logits over it."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, tcfg = j_get_smoke(arch), get_smoke_config(arch)
            params = j_init(jcfg, jax.random.PRNGKey(0))
            model = from_jax_params(tcfg, jax.tree.map(np.asarray, params), "cpu")
            tokens = np.random.default_rng(0).integers(
                0, jcfg.vocab_size, (B, S_PROMPT + N_DEC)).astype(np.int32)
            ref, _ = jax.jit(lambda p, t: j_forward(jcfg, p, tokens=t))(params, jnp.asarray(tokens))
            built[arch] = (jcfg, tcfg, params, model, tokens, np.asarray(ref))
        return built[arch]

    return get


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_matches_reference_forward(lm, arch):
    _, cfg, _, model, tokens, ref = lm(arch)
    tok = torch.as_tensor(tokens)
    caches = cache_init(cfg, B, S_PROMPT + N_DEC, device="cpu")
    logits, caches = model_prefill(cfg, model, tok[:, :S_PROMPT], caches)
    np.testing.assert_allclose(logits.numpy(), ref[:, S_PROMPT - 1], err_msg="prefill", **TOL)
    for i in range(N_DEC):
        pos = S_PROMPT + i
        logits, caches = model_decode(cfg, model, tok[:, pos], caches, pos)
        np.testing.assert_allclose(logits.numpy(), ref[:, pos], err_msg=f"decode {i}", **TOL)


@pytest.mark.parametrize("arch", CHUNKED_ARCHS)
def test_chunked_prefill_matches_flat(lm, arch):
    jcfg, cfg, params, model, _, _ = lm(arch)
    s, chunk = 64, 16
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    ref, _ = j_prefill(jcfg, params, jnp.asarray(tokens), j_cache_init(jcfg, B, s + 4))
    tok = torch.as_tensor(tokens)
    flat, _ = model_prefill(cfg, model, tok, cache_init(cfg, B, s + 4, device="cpu"))
    chunked, caches = model_prefill_chunked(
        cfg, model, tok, cache_init(cfg, B, s + 4, device="cpu"), chunk)
    np.testing.assert_allclose(chunked.numpy(), flat.numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref), **CHUNK_TOL)
    # decode continues from the chunked caches
    logits, _ = model_decode(cfg, model, tok[:, -1], caches, s)
    assert torch.isfinite(logits).all()


def test_chunked_prefill_refuses_a_ragged_prompt(lm):
    _, cfg, _, model, tokens, _ = lm("deepseek-7b")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        model_prefill_chunked(cfg, model, torch.as_tensor(tokens), cache_init(
            cfg, B, 64, device="cpu"), 16)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_greedy_generate_matches_reference(lm, arch):
    jcfg, cfg, params, model, tokens, _ = lm(arch)
    prompt = tokens[:, :S_PROMPT]
    ref = np.asarray(j_generate(jcfg, params, jnp.asarray(prompt), n_tokens=6))
    got = generate(cfg, model, torch.as_tensor(prompt), n_tokens=6)
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_greedy_generation_is_deterministic(lm):
    _, cfg, _, model, tokens, _ = lm("mamba2-370m")
    prompt = torch.as_tensor(tokens[:1, :8])
    assert torch.equal(generate(cfg, model, prompt, 5), generate(cfg, model, prompt, 5))


def test_temperature_sampling_follows_its_seed(lm):
    _, cfg, _, model, tokens, _ = lm("deepseek-7b")
    prompt = torch.as_tensor(tokens[:, :8])

    def run(seed):
        return generate(cfg, model, prompt, 12, ServeConfig(temperature=1.5, seed=seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    # the first token is the prefill's argmax, whatever the temperature
    assert torch.equal(a[:, 0], generate(cfg, model, prompt, 1)[:, 0])


def test_generate_with_embeds_matches_reference():
    jcfg, cfg = j_get_smoke("internvl2-2b"), get_smoke_config("internvl2-2b")
    params = j_init(jcfg, jax.random.PRNGKey(0))
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    ref = j_generate(jcfg, params, jnp.asarray(prompt), 5, embeds=jnp.asarray(embeds))
    got = generate(cfg, model, torch.as_tensor(prompt), 5, embeds=torch.as_tensor(embeds))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- the CLI ------------------------------------------------------------------------


def test_serve_cli_smoke_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "deepseek-7b", "--smoke",
         "--device", "cpu", "--chunked-prefill", "16"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "deepseek-7b-smoke: prompt 64, generated 16" in proc.stdout
    assert "tok/s" in proc.stdout


def test_serve_cli_refuses_an_encoder_only_model():
    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only"):
        serve_cli.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def test_serve_cli_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "deepseek-7b", "--smoke"])


# --- the card's measurement helpers, rehearsed on the CPU ---------------------------


def test_decode_step_bytes_counts_the_reference_form():
    """deepseek-7b at B=4 and 528 cached positions: each matrix weight read
    as float32 and its bf16 copy written and read (8 bytes), the float32
    head, the embedding's rows, the vectors, the KV cache read to 529
    positions and written at one, the logits."""
    cfg = lm_perf.full_width("deepseek-7b")
    d, ff, v, n = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    matrices = n * (4 * d * d + 3 * d * ff)
    vectors = (2 * n + 1) * d
    kv = n * 2 * 4 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * 529
    fixed = d * v * 4 + 4 * d * 4 + vectors * 4 + kv + 4 * v * 4
    assert lm_perf.decode_step_bytes(cfg, 4, 528) == matrices * 8 + fixed
    assert lm_perf.decode_step_bytes(cfg, 4, 528, cast_per_call=False) == matrices * 2 + fixed


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-370m", "jamba-v0.1-52b"])
def test_serve_checks_pass_on_the_cpu(arch):
    """chip_smoke.py phase 15's serve checks at smoke width in bfloat16:
    the right decode within the bar, each planted fault outside it."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    model = model_init(cfg, 0, device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)))
    calls = []
    with torch.inference_mode():
        row = lm_perf.serve_checks(cfg, model, prompt, 5, 16, mark=lambda: calls.append(1))
    assert len(calls) == 6 and row["tokens"].shape == (2, 5)
    assert row["max_rel_err_steps"] <= lm_perf.BF16_BAR
    assert row["max_rel_err_chunked"] <= lm_perf.BF16_BAR
    faults = {"deepseek-7b": {"position_plus_one"}, "mamba2-370m": {"stale_ssm_state"},
              "jamba-v0.1-52b": {"position_plus_one", "stale_ssm_state"}}[arch]
    controls = row["controls"]
    assert set(controls) == faults | {"float32_max_rel_err"}
    assert controls["float32_max_rel_err"] <= lm_perf.DECODE_F32_BAR
    for name in faults:
        assert controls[name]["steps_missing_bar"] >= 1
        assert controls[name]["max_rel_err"] > lm_perf.DECODE_F32_BAR


def test_decode_controls_raise_when_the_fault_is_invisible(monkeypatch):
    """A control whose fault changes nothing stays within the bar, and
    raises: here the planted position shift is dropped."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-7b"), dtype="bfloat16")
    model = model_init(cfg, 0, device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    right = lm_perf.decode_steps
    monkeypatch.setattr(lm_perf, "decode_steps",
                        lambda cfg, model, prompt, tokens, **fault: right(cfg, model, prompt, tokens))
    with torch.inference_mode():
        tokens = generate(cfg, model, prompt, 4)
        with pytest.raises(AssertionError, match="position_plus_one stays within the bar"):
            lm_perf.decode_controls(cfg, model, prompt, tokens)


def test_serve_case_times_on_the_card_only():
    with pytest.raises(ValueError, match="serve_checks runs anywhere"):
        lm_perf.serve_case(get_smoke_config("deepseek-7b"), batch=1, prompt_len=8,
                           new_tokens=2, chunk=8, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-370m", "internvl2-2b", "hubert-xlarge"])
def test_smoke_vs_cpu_runs_on_the_cpu(arch):
    """Phase 15(c)'s comparison with the CPU as both sides: exact."""
    row = lm_perf.smoke_vs_cpu(arch, "cpu")
    assert row["max_rel_err"]["forward"] == 0.0
    assert row["max_rel_err"].get("serve", 0.0) == 0.0
