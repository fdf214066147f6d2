"""The port's whole models against the JAX package's, every architecture at
smoke width.

The reference's ``model_init(PRNGKey(0))`` weights go to numpy and into the
port through ``from_jax_params``; the same inputs (tokens; the VLM's
frontend embeddings before its tokens; the audio model's frames, as
``tests/test_arch_smoke.py`` builds them) go through both
``model_forward``s.  Bars: float32 logits within 1e-4 relative and
absolute (measured <= 1e-5 on the CPU) and the MoE aux metrics within 2e-5
(dropped_frac equal).  bfloat16 (deepseek-7b smoke): max |dlogit| <= 5e-2 *
max |logit| (measured 1.3e-2), and argmax equal wherever the reference's
top-2 gap exceeds twice that bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.data.synthetic import DataConfig, batch_for_step, frame_batch_for_step
from repro.models.model import model_forward as j_forward
from repro.models.model import model_init as j_init
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.model import Model, model_forward, model_init
from repro_torch.models.weights import from_jax_params

B, S = 2, 64
TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_BAR = 5e-2


def _inputs(cfg):
    """(tokens, embeds) as numpy, as tests/test_arch_smoke.py::_batch_for builds them."""
    if cfg.family == "audio":
        return None, frame_batch_for_step(DataConfig(cfg.vocab_size, B, S, seed=1), 0, cfg.d_model)["embeds"]
    if cfg.family == "vlm":
        nf = cfg.n_frontend_tokens
        tokens = batch_for_step(DataConfig(cfg.vocab_size, B, S - nf, seed=1), 0)["tokens"]
        embeds = np.random.default_rng(0).standard_normal((B, nf, cfg.d_model)).astype(np.float32)
        return tokens, embeds
    return batch_for_step(DataConfig(cfg.vocab_size, B, S, seed=1), 0)["tokens"], None


def _pair(jcfg, tcfg):
    params = j_init(jcfg, jax.random.PRNGKey(0))
    return params, from_jax_params(tcfg, jax.tree.map(np.asarray, params), "cpu")


def _run_both(jcfg, tcfg):
    params, model = _pair(jcfg, tcfg)
    tokens, embeds = _inputs(jcfg)
    ref, ref_aux = jax.jit(lambda p, t, e: j_forward(jcfg, p, tokens=t, embeds=e))(
        params,
        None if tokens is None else jnp.asarray(tokens),
        None if embeds is None else jnp.asarray(embeds),
    )
    got, aux = model_forward(
        tcfg, model,
        tokens=None if tokens is None else torch.as_tensor(tokens),
        embeds=None if embeds is None else torch.as_tensor(embeds),
    )
    return np.asarray(ref), ref_aux, got.numpy(), aux


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    jcfg, tcfg = j_get_smoke(arch), get_smoke_config(arch)
    ref, ref_aux, got, aux = _run_both(jcfg, tcfg)
    assert got.shape == ref.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got, ref, err_msg=arch, **TOL)
    assert sorted(aux) == sorted(ref_aux)
    for key in aux:
        if key == "dropped_frac":
            assert float(aux[key]) == float(ref_aux[key])
        else:
            np.testing.assert_allclose(float(aux[key]), float(ref_aux[key]), **AUX_TOL)


def test_bfloat16_forward_within_its_bar():
    jcfg = dataclasses.replace(j_get_smoke("deepseek-7b"), dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config("deepseek-7b"), dtype="bfloat16")
    ref, _, got, _ = _run_both(jcfg, tcfg)
    bar = BF16_BAR * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bar
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * bar
    assert np.array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_carried_weights_land_on_their_layers(arch):
    """Every reference weight lands in the port's module for its layer: the
    stacked period row p, block j is layer first_k_dense + p * period + j."""
    jcfg, tcfg = j_get_smoke(arch), get_smoke_config(arch)
    params, model = _pair(jcfg, tcfg)
    period = jcfg.block_pattern_period
    for i, blk in enumerate(model.blocks):
        if i < jcfg.first_k_dense:
            ref = params["prologue"][i]
        else:
            p, j = divmod(i - jcfg.first_k_dense, period)
            ref = jax.tree.map(lambda a: a[p], params["layers"][f"b{j}"])
        flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(ref)}
        ours = dict(blk.named_parameters())
        assert len(flat) == len(ours)
        for name, value in ours.items():
            key = "".join(f"['{part}']" for part in name.split("."))
            # a reference initialised under x64 holds float64 leaves; its
            # per-call cast to float32 is the carrier's rounding
            assert np.array_equal(value.numpy(), np.asarray(flat[key], np.float32)), (i, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_random_init_holds_the_reference_parameters(arch):
    """As many float32 weights as the reference's tree (the analytic
    param_count leaves out the norms of the final layer, qk-norm and MLA,
    and the conv biases), drawn the same for the same seed."""
    cfg = get_smoke_config(arch)
    model = model_init(cfg, 0, device="cpu")
    ref = j_init(j_get_smoke(arch), jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(leaf) for leaf in jax.tree.leaves(ref))
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in model.parameters())
    again = model_init(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_model_init_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_init(get_smoke_config("deepseek-7b"))
    assert isinstance(model_init(get_smoke_config("deepseek-7b"), device="cpu"), Model)


def test_tf32_is_refused(monkeypatch):
    cfg = get_smoke_config("deepseek-7b")
    model = model_init(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        model_forward(cfg, model, tokens=torch.zeros((1, 4), dtype=torch.long))
