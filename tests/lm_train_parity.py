"""The JAX package's loss, gradients and train step against the port's:
shared by ``tests/test_torch_lm_train_parity*.py``, which split the 10
architectures so that ``--dist loadfile`` spreads the JAX compiles.

The reference's ``model_init(PRNGKey(0))`` weights, cast to float32 (the
suite runs JAX with x64, so they are float64, which the reference's bf16
cast would skip and its optimizer would run in), go to the port through
``from_jax_params``; the batch is ``tests/test_arch_smoke.py``'s (B=2,
S=64; lm_perf.smoke_batch builds the same numpy arrays).

Bars.  Loss and gradients (``lm_loss``): the loss within rtol 1e-5; each
gradient leaf's max |dg| within 1e-4 of its largest entry in float32
gather, 1.6e-2 (two bf16 ulps) with the bf16 cast (measured on the CPU:
at most 2.3e-5 and 6.1e-3).  One whole train step from carried weights
and optimizer state (after two reference steps, so the moments and the
bias corrections are not trivial), float32 gather, lr 5e-3: ce_loss,
total_loss, grad_norm and lr within rtol 1e-5; every new weight within
0.5 lr of the reference's and at most 1e-3 of the entries off by more than
1e-2 lr (Adam's early steps are about lr wherever a gradient is not tiny,
so an entry whose gradient sits at the rounding noise can move by up to
2 lr between two implementations).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as j_get_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batch_for_step as j_batch_for_step
from repro.models.model import model_init as j_init
from repro.training.optimizer import OptimizerConfig as JOptimizerConfig
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro.training.train import TrainConfig as JTrainConfig
from repro.training.train import lm_loss as j_lm_loss
from repro.training.train import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch.lm_perf import smoke_batch
from repro_torch.models.weights import _flatten, _per_layer, from_jax_opt_state, from_jax_params
from repro_torch.training import OptimizerConfig, TrainConfig, batch_to, make_train_step

B, S = 2, 64
LOSS_RTOL = 1e-5
GRAD_BAR = {"float32": 1e-4, "bfloat16": 1.6e-2}
STEP_B, STEP_LR = 4, 5e-3


def f32_params(jcfg):
    return jax.tree.map(lambda x: x.astype(jnp.float32), j_init(jcfg, jax.random.PRNGKey(0)))


def flat(cfg, tree) -> dict:
    """A stacked JAX tree as the port's parameter names -> float32 numpy."""
    leaves = _flatten(_per_layer(cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), tree)),
                      "", {})
    return {k: v.numpy() for k, v in leaves.items()}


def _cast(params, gather):
    if gather == "float32":
        return params
    return jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if (x.ndim >= 2 and x.dtype == jnp.float32) else x,
        params)


def check_loss_and_grads(arch: str, gather: str) -> None:
    """The reference's value_and_grad of lm_loss on its (cast) tree against
    the port's TrainStep.grads on the same weights and batch."""
    jcfg, cfg = j_get_smoke(arch), get_smoke_config(arch)
    params = f32_params(jcfg)
    batch = smoke_batch(cfg, B, S)

    def ref(p, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: j_lm_loss(jcfg, q, b), has_aux=True)(_cast(p, gather))
        return loss, g

    loss, grads = jax.jit(ref)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")
    step = make_train_step(cfg, TrainConfig(param_gather_dtype=gather))
    metrics, got = step.grads(model, batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(metrics["total_loss"]), float(loss), rtol=LOSS_RTOL)
    want = flat(cfg, grads)
    assert sorted(want) == sorted(got)
    for name, r in want.items():
        g = np.zeros_like(r) if got[name] is None else got[name].float().numpy()
        gap = np.abs(g - r).max()
        assert gap <= GRAD_BAR[gather] * np.abs(r).max(), (arch, gather, name, gap, np.abs(r).max())


def check_train_step(arch: str, microbatches: int) -> None:
    """One whole train step of each package from the reference's weights
    and optimizer state after two of its steps (module docstring)."""
    jcfg, cfg = j_get_smoke(arch), get_smoke_config(arch)
    dc = JDataConfig(vocab_size=jcfg.vocab_size, batch=STEP_B, seq_len=S, seed=1)
    jt = JTrainConfig(param_gather_dtype="float32", microbatches=microbatches,
                      opt=JOptimizerConfig(lr=STEP_LR, warmup_steps=1, total_steps=50))
    step_j = jax.jit(j_make_train_step(jcfg, jt))
    params = f32_params(jcfg)
    opt = j_init_opt_state(jt.opt, params)
    for s in range(2):
        batch = {k: jnp.asarray(v) for k, v in j_batch_for_step(dc, s).items()}
        params, opt, _ = step_j(params, opt, batch)

    model = from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")
    state = from_jax_opt_state(cfg, jax.tree.map(np.asarray, opt), "cpu")
    assert int(state["count"]) == 2
    batch = j_batch_for_step(dc, 2)
    params, opt, ref = step_j(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    tt = TrainConfig(param_gather_dtype="float32", microbatches=microbatches,
                     opt=OptimizerConfig(lr=STEP_LR, warmup_steps=1, total_steps=50))
    model, state, got = make_train_step(cfg, tt)(model, state, batch_to(batch, "cpu"))

    assert int(state["count"]) == 3
    for key in ("ce_loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-5, err_msg=key)
    lr = float(ref["lr"])
    want = flat(cfg, params)
    off, total, worst = 0, 0, 0.0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name])
        worst = max(worst, float(diff.max()))
        off += int((diff > 1e-2 * lr).sum())
        total += diff.size
    assert worst <= 0.5 * lr, (arch, microbatches, worst / lr)
    assert off <= 1e-3 * total, (arch, microbatches, off, total)
