"""The port's LM layers against the JAX package's, module by module.

Each case draws its inputs from a seed with numpy (or takes the JAX
package's own initialisation, carried over by name), runs the reference
function and the port's on them in float32 on the CPU, and compares.  Bars
(float32): 1e-5 relative and absolute for the elementwise layers and
attention (measured ~1e-7 to 1e-6); the JAX tests' own 2e-5 for MoE
(`tests/test_moe.py`) and 2e-4 for SSD (`tests/test_mamba2.py`).  The
metrics of a dropping MoE layer are equal, as counts are.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import load_module

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
SSD_TOL = dict(rtol=2e-4, atol=2e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# --- norm, rope, MLP ---------------------------------------------------------------


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, scale = _normal(rng, 2, 5, 48, scale=3.0), _normal(rng, 48)
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    _close(tlayers.rmsnorm(torch.as_tensor(scale), torch.as_tensor(x), 1e-6), ref)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta), ref)


def test_mlp():
    rng = np.random.default_rng(2)
    params = _np(jlayers.mlp_init(jax.random.PRNGKey(0), 32, 88))
    x = _normal(rng, 2, 7, 32)
    mlp = load_module(tlayers.MLP(32, 88, device="cpu"), params)
    _close(tlayers.mlp_apply(mlp, torch.as_tensor(x)), jlayers.mlp_apply(params, jnp.asarray(x)))


# --- blockwise attention -------------------------------------------------------------

# (causal, groups, sq, sk, q_offset, kv_valid_len, kv_block)
ATTN_CASES = {
    "causal": (True, 1, 24, 24, 0, None, 8),
    "bidirectional": (False, 1, 24, 24, 0, None, 8),
    "gqa4-causal": (True, 4, 24, 24, 0, None, 8),
    "gqa4-bidirectional": (False, 4, 17, 17, 0, None, 1024),
    "q-offset-decode": (True, 4, 1, 32, 20, 21, 16),
    "chunk-extend": (True, 1, 6, 40, 12, 18, 16),
    "sk-not-multiple": (True, 1, 23, 23, 0, None, 8),
    "kv-valid-padded": (False, 4, 5, 29, 0, 13, 8),
    "fully-masked-rows": (True, 1, 8, 16, -3, None, 8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blockwise_attention(case):
    causal, groups, sq, sk, q_offset, kv_valid_len, kv_block = ATTN_CASES[case]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    hkv, hd = 2, 16
    q = _normal(rng, 2, sq, hkv * groups, hd)
    k, v = _normal(rng, 2, sk, hkv, hd), _normal(rng, 2, sk, hkv, hd)
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, kv_block=kv_block)
    ref = jlayers.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tlayers.blockwise_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    _close(got, ref)
    if case == "fully-masked-rows":  # query rows 0..2 see no key: zeros, not NaN
        assert torch.all(got[:, :3] == 0)


# --- MoE -------------------------------------------------------------------------------


def _moe_cfg(cls, **kw):
    base = dict(
        name="moe-test", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=64, moe_experts=8, moe_top_k=2, moe_d_ff=64, dtype="float32",
    )
    base.update(kw)
    return cls(**base)


# (config overrides, x's key and shape): tests/test_moe.py's cases
MOE_CASES = {
    "unbounded": (dict(capacity_factor=8.0), 1, (2, 16)),
    "shared-expert": (dict(moe_shared_experts=1, capacity_factor=8.0), 1, (1, 8)),
    "dropping": (dict(capacity_factor=0.5), 2, (2, 32)),
}


def _moe_pair(case):
    kw, xkey, shape = MOE_CASES[case]
    jcfg, tcfg = _moe_cfg(JModelConfig, **kw), _moe_cfg(ModelConfig, **kw)
    params = _np(jmoe.moe_init(jcfg, jax.random.PRNGKey(0)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(xkey), (*shape, jcfg.d_model)))
    return jcfg, tcfg, params, x, load_module(tmoe.MoE(tcfg, device="cpu"), params)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply(case):
    jcfg, tcfg, params, x, moe = _moe_pair(case)
    ref, ref_m = jmoe.moe_apply(jcfg, params, jnp.asarray(x))
    got, got_m = tmoe.moe_apply(tcfg, moe, torch.as_tensor(x))
    _close(got, ref, **MOE_TOL)
    for key in ("aux_loss", "z_loss"):
        _close(got_m[key], ref_m[key], **MOE_TOL)
    assert float(got_m["dropped_frac"]) == float(ref_m["dropped_frac"])
    assert (float(got_m["dropped_frac"]) > 0) == (case == "dropping")


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ref_dense(case):
    jcfg, tcfg, params, x, moe = _moe_pair(case)
    ref = jmoe.moe_ref_dense(jcfg, params, jnp.asarray(x))
    _close(tmoe.moe_ref_dense(tcfg, moe, torch.as_tensor(x)), ref, **MOE_TOL)


def test_moe_capacity_formula():
    for n in (1, 7, 64, 1024, 4099):
        for cf in (0.5, 1.25, 8.0):
            assert tmoe._capacity(_moe_cfg(ModelConfig, capacity_factor=cf), n) == jmoe._capacity(
                _moe_cfg(JModelConfig, capacity_factor=cf), n
            )


def test_moe_tied_probabilities_pick_the_lower_expert():
    """A router with equal columns ties every token's probabilities: top-k
    takes the lower expert ids, as lax.top_k does."""
    jcfg, tcfg, params, x, moe = _moe_pair("unbounded")
    params = dict(params, router=np.repeat(params["router"][:, :1], jcfg.moe_experts, axis=1))
    moe = load_module(tmoe.MoE(tcfg, device="cpu"), params)
    _, _, _, top_i = tmoe._route(tcfg, moe, torch.as_tensor(x).reshape(-1, jcfg.d_model))
    assert torch.equal(top_i, torch.arange(jcfg.moe_top_k).expand_as(top_i))
    ref, _ = jmoe.moe_apply(jcfg, params, jnp.asarray(x))
    _close(tmoe.moe_apply(tcfg, moe, torch.as_tensor(x))[0], ref, **MOE_TOL)


# --- MLA ---------------------------------------------------------------------------------


@pytest.mark.parametrize("q_lora", [0, 48])
@pytest.mark.parametrize("sq,sk,valid", [(12, 12, 12), (1, 40, 30), (8, 2100, 2053)])
def test_mla_attend(q_lora, sq, sk, valid):
    jcfg = dataclasses.replace(j_get_smoke("deepseek-v2-236b"), q_lora_rank=q_lora)
    tcfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), q_lora_rank=q_lora)
    params = _np(jmla.mla_init(jcfg, jax.random.PRNGKey(3)))
    mla = load_module(tmla.MLA(tcfg, device="cpu"), params)
    rng = np.random.default_rng(sk)
    nh = jcfg.n_heads
    q_nope = _normal(rng, 2, sq, nh, jcfg.qk_nope_head_dim)
    q_rope = _normal(rng, 2, sq, nh, jcfg.qk_rope_head_dim)
    c_kv = _normal(rng, 2, sk, jcfg.kv_lora_rank)
    k_rope = _normal(rng, 2, sk, jcfg.qk_rope_head_dim)
    args = [q_nope, q_rope, c_kv, k_rope]
    ref = jmla._attend(jcfg, params, *map(jnp.asarray, args), kv_valid_len=valid)
    got = tmla._attend(tcfg, mla, *map(torch.as_tensor, args), kv_valid_len=valid)
    _close(got, ref)
    # the projections around it
    x = _normal(rng, 2, sq, jcfg.d_model)
    pos = np.broadcast_to(np.arange(valid - sq, valid), (2, sq)).astype(np.int32)
    for jf, tf in ((jmla._queries, tmla._queries), (jmla._latent_kv, tmla._latent_kv)):
        for r, g in zip(jf(jcfg, params, jnp.asarray(x), jnp.asarray(pos)),
                        tf(tcfg, mla, torch.as_tensor(x), torch.as_tensor(pos))):
            _close(g, r)


# --- Mamba-2 -----------------------------------------------------------------------------


def _ssd_cfgs(chunk=16):
    kw = dict(
        name="ssd-test", family="ssm", n_layers=1, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=64, ssm_state=16, ssm_expand=2, ssm_headdim=32, ssm_chunk=chunk,
        dtype="float32",
    )
    return JModelConfig(**kw), ModelConfig(**kw)


def _mamba_pair(seed=0):
    jcfg, tcfg = _ssd_cfgs()
    params = _np(jmamba.mamba_init(jcfg, jax.random.PRNGKey(seed)))
    params["conv_b"] = _normal(np.random.default_rng(seed), *params["conv_b"].shape, scale=0.1)
    params["dt_bias"] = _normal(np.random.default_rng(seed + 1), *params["dt_bias"].shape)
    return jcfg, tcfg, params, load_module(tmamba.Mamba2(tcfg, device="cpu"), params)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    jcfg, tcfg, params, mamba = _mamba_pair()
    rng = np.random.default_rng(5)
    cd = tmamba._conv_dim(tcfg)
    xbc = _normal(rng, 2, 11, cd)
    state = _normal(rng, 2, tcfg.ssm_conv - 1, cd) if with_state else None
    ref = jmamba._causal_conv(params, jnp.asarray(xbc), None if state is None else jnp.asarray(state))
    got = tmamba._causal_conv(
        mamba, torch.as_tensor(xbc), None if state is None else torch.as_tensor(state)
    )
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("length", [64, 53])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(length, with_state):
    jcfg, tcfg = _ssd_cfgs(16)
    rng = np.random.default_rng(length)
    B, H, P, N = 2, tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state
    x = _normal(rng, B, length, H, P)
    dt = rng.uniform(0.1, 0.9, (B, length, H)).astype(np.float32)
    a = (-rng.uniform(0.05, 1.0, (B, length, H))).astype(np.float32)
    b_mat, c_mat = _normal(rng, B, length, N), _normal(rng, B, length, N)
    init = _normal(rng, B, H, P, N) if with_state else None
    args = [x, dt, b_mat, c_mat, a]
    ref = jmamba._ssd_chunked(jcfg, *map(jnp.asarray, args),
                              None if init is None else jnp.asarray(init))
    got = tmamba._ssd_chunked(tcfg, *map(torch.as_tensor, args),
                              None if init is None else torch.as_tensor(init))
    for g, r in zip(got, ref):
        _close(g, r, **SSD_TOL)


def test_mamba_decode():
    jcfg, tcfg, params, mamba = _mamba_pair(1)
    rng = np.random.default_rng(7)
    cache = {
        "ssm": _normal(rng, 2, tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state),
        "conv": _normal(rng, 2, tcfg.ssm_conv - 1, tmamba._conv_dim(tcfg)),
    }
    x = _normal(rng, 2, 1, tcfg.d_model)
    ref_out, ref_cache = jmamba.mamba_decode(
        jcfg, params, jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    got_out, got_cache = tmamba.mamba_decode(
        tcfg, mamba, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in cache.items()})
    _close(got_out, ref_out)
    for key in ("ssm", "conv"):
        _close(got_cache[key], ref_cache[key])


def test_mamba_sequence_with_carried_state():
    jcfg, tcfg, params, mamba = _mamba_pair(2)
    rng = np.random.default_rng(8)
    cache = {
        "ssm": _normal(rng, 2, tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state),
        "conv": _normal(rng, 2, tcfg.ssm_conv - 1, tmamba._conv_dim(tcfg)),
    }
    x = _normal(rng, 2, 21, tcfg.d_model)
    ref_out, ref_cache = jmamba.mamba_extend(
        jcfg, params, jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    got_out, got_cache = tmamba.mamba_extend(
        tcfg, mamba, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in cache.items()})
    _close(got_out, ref_out, **SSD_TOL)
    for key in ("ssm", "conv"):
        _close(got_cache[key], ref_cache[key], **SSD_TOL)


# --- configs -------------------------------------------------------------------------------


def test_arch_ids_are_the_reference_list():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_config_matches_reference(arch):
    for ours, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()
        assert ours.block_pattern_period == ref.block_pattern_period
        assert [ours.layer_kind(i) for i in range(ours.n_layers)] == [
            ref.layer_kind(i) for i in range(ref.n_layers)]
        assert [ours.layer_has_moe(i) for i in range(ours.n_layers)] == [
            ref.layer_has_moe(i) for i in range(ref.n_layers)]
