"""The port's training path on the CPU: the data streams, the schedule and
the optimizer against the JAX package's; the model on bf16 weights; the
remat policies; the train step's loss falling, resume and the train CLI.

Bars.  The data streams and the schedule: bit for bit.  ``apply_updates``
(three steps on random gradients, one weight with none): the learning rate
equal; the global norm within rtol 1e-6 (XLA's and torch's float32 sums
add in different orders; measured <= 7e-7); the weights, mu, nu and the
error-feedback residual within rtol R plus 1e-6 of the leaf's largest
entry, where R is 1e-6 with clipping inactive and 1e-6 plus twice the
norms' relative difference with it active (the clip scale carries that
difference into every gradient, and nu takes it squared).  The forward on
bf16 weights, and remat none, full and dots: bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_synthetic
from repro.training.optimizer import OptimizerConfig as JOptimizerConfig
from repro.training.optimizer import apply_updates as j_apply_updates
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro.training.optimizer import schedule as j_schedule
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data import DataConfig, batch_for_step, frame_batch_for_step
from repro_torch.launch import lm_perf
from repro_torch.launch import train as train_cli
from repro_torch.models import model as model_mod
from repro_torch.models.model import model_forward, model_init
from repro_torch.training import (
    OptimizerConfig,
    TrainConfig,
    apply_updates,
    batch_to,
    init_opt_state,
    make_train_step,
    schedule,
)
from repro_torch.training.train import compute_copy


@pytest.mark.parametrize("seed,host_id,step", [(0, 0, 0), (0, 0, 7), (3, 1, 2), (11, 2, 1000)])
def test_data_streams_bit_equal(seed, host_id, step):
    cfg = DataConfig(vocab_size=517, batch=3, seq_len=40, seed=seed, n_hosts=4, host_id=host_id)
    ref_cfg = j_synthetic.DataConfig(vocab_size=517, batch=3, seq_len=40, seed=seed, n_hosts=4,
                                     host_id=host_id)
    for got, ref in ((batch_for_step(cfg, step), j_synthetic.batch_for_step(ref_cfg, step)),
                     (frame_batch_for_step(cfg, step, 24),
                      j_synthetic.frame_batch_for_step(ref_cfg, step, 24))):
        assert sorted(got) == sorted(ref)
        for key in got:
            assert got[key].dtype == ref[key].dtype and np.array_equal(got[key], ref[key]), key


@pytest.mark.parametrize("opt", [
    dict(), dict(lr=5e-3, warmup_steps=1, total_steps=50), dict(lr=1e-3, warmup_steps=2,
                                                                total_steps=20),
    dict(lr=1e-3, warmup_steps=20, total_steps=40, min_lr_frac=0.05),
], ids=["default", "smoke", "cli", "example"])
def test_schedule_equals_reference(opt):
    ref_cfg, cfg = JOptimizerConfig(**opt), OptimizerConfig(**opt)
    for step in range(61):
        ref = np.asarray(j_schedule(ref_cfg, jnp.asarray(step, jnp.int32)))
        got = schedule(cfg, step)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        assert got.numpy().tobytes() == ref.tobytes(), (step, float(got), float(ref))


SHAPES = {"w": (48, 32), "b": (32,), "e": (3, 16, 8), "none": (16,)}


@pytest.mark.parametrize("compression", ["none", "bf16_ef"])
@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
def test_apply_updates_matches_reference(clip, compression):
    """Three steps on random gradients; ``none`` gets no gradient in the
    port and a zero one in the reference, and is still decayed."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    kw = dict(lr=5e-3, warmup_steps=1, total_steps=50, clip_norm=clip,
              grad_compression=compression)
    ref_cfg, cfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = j_init_opt_state(ref_cfg, ref_p)
    got_p = {k: torch.tensor(v) for k, v in params.items()}
    got_s = init_opt_state(cfg, got_p)
    step = jax.jit(lambda p, g, s: j_apply_updates(ref_cfg, p, g, s))
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        grads["none"][:] = 0.0
        before = got_p["none"].clone()
        ref_p, ref_s, ref_m = step(ref_p, {k: jnp.asarray(v) for k, v in grads.items()}, ref_s)
        got_p, got_s, got_m = apply_updates(
            cfg, got_p, {k: torch.tensor(v) for k, v in grads.items() if k != "none"}, got_s)
        assert float(got_m["lr"]) == float(ref_m["lr"])
        norm_gap = abs(float(got_m["grad_norm"]) / float(ref_m["grad_norm"]) - 1.0)
        assert norm_gap <= 1e-6
        rtol = 1e-6 + (2 * norm_gap if clip == 1.0 else 0.0)
        leaves = [("params", got_p, ref_p), ("mu", got_s["mu"], ref_s["mu"]),
                  ("nu", got_s["nu"], ref_s["nu"])]
        if compression == "bf16_ef":
            leaves.append(("ef", got_s["ef"], ref_s["ef"]))
        for what, got, ref in leaves:
            for k in SHAPES:
                r = np.asarray(ref[k])
                np.testing.assert_allclose(got[k].numpy(), r, rtol=rtol,
                                           atol=1e-6 * np.abs(r).max(), err_msg=f"{what}/{k}")
        # weight decay reaches the weight with no gradient
        assert not torch.equal(got_p["none"], before)
    assert int(got_s["count"]) == int(ref_s["count"]) == 3


def test_zero1_changes_nothing():
    params = {"w": torch.ones(8, 4)}
    grads = {"w": torch.full((8, 4), 0.5)}
    out = {}
    for zero1 in (False, True):
        cfg = OptimizerConfig(zero1=zero1)
        p = {"w": params["w"].clone()}
        p, state, _ = apply_updates(cfg, p, grads, init_opt_state(cfg, p))
        out[zero1] = (p["w"], state["mu"]["w"], state["nu"]["w"])
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


def _bf16_copy(cfg, model):
    copy = compute_copy(cfg, "cpu", torch.bfloat16)
    with torch.no_grad():
        for c, p in zip(copy.parameters(), model.parameters()):
            c.copy_(p)
    return copy


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_on_bf16_weights(arch):
    """The default TrainConfig's bf16 weights through model_forward: the
    same logits and aux bit for bit as float32 weights holding the same
    bf16-rounded values (every consumer casts the weight as the reference
    does; the head casts it up)."""
    cfg = get_smoke_config(arch)
    model = model_init(cfg, 0, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.copy_(p.to(torch.bfloat16))
    batch = batch_to(lm_perf.smoke_batch(cfg, 2, 32), "cpu")
    copy = _bf16_copy(cfg, model)
    assert {p.dtype for n, p in copy.named_parameters() if p.dim() >= 2} == {torch.bfloat16}
    with torch.no_grad():
        ref, ref_aux = model_forward(cfg, model, tokens=batch.get("tokens"),
                                     embeds=batch.get("embeds"))
        got, aux = model_forward(cfg, copy, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, ref)
    assert sorted(aux) == sorted(ref_aux) and all(torch.equal(aux[k], ref_aux[k]) for k in aux)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_bit_equal(arch, monkeypatch):
    """none, full and dots: the same loss and gradients bit for bit; dots
    saves the matrix products (aten.mm) and nothing else."""
    cfg = get_smoke_config(arch)
    model = model_init(cfg, 0, device="cpu")
    batch = batch_to(lm_perf.smoke_batch(cfg, 2, 64), "cpu")
    saved = set()
    policy = model_mod._dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out.name == "MUST_SAVE":
            saved.add(op)
        return out

    monkeypatch.setattr(model_mod, "_dots_policy", spy)
    runs = {}
    for remat in ("none", "full", "dots"):
        step = make_train_step(cfg, TrainConfig(remat=remat))
        runs[remat] = step.grads(model, batch)
    ref_metrics, ref_grads = runs["none"]
    for remat in ("full", "dots"):
        metrics, grads = runs[remat]
        assert torch.equal(metrics["total_loss"], ref_metrics["total_loss"]), remat
        for name, g in grads.items():
            assert (g is None and ref_grads[name] is None) or torch.equal(g, ref_grads[name]), name
    assert saved == {torch.ops.aten.mm.default}


def test_gradient_free_outside_the_step():
    """The master weights need no gradient before or after a step (float32
    gather differentiates them in place), and a served model stays so."""
    cfg = get_smoke_config("deepseek-7b")
    model = model_init(cfg, 0, device="cpu")
    batch = batch_to(lm_perf.smoke_batch(cfg, 2, 32), "cpu")
    for gather in ("float32", "bfloat16"):
        tcfg = TrainConfig(param_gather_dtype=gather)
        opt = init_opt_state(tcfg.opt, dict(model.named_parameters()))
        make_train_step(cfg, tcfg)(model, opt, batch)
        assert not any(p.requires_grad for p in model.parameters()), gather


def test_microbatches_must_divide_the_batch():
    cfg = get_smoke_config("deepseek-7b")
    model = model_init(cfg, 0, device="cpu")
    batch = batch_to(lm_perf.smoke_batch(cfg, 3, 32), "cpu")
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, TrainConfig(microbatches=2)).grads(model, batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_loss(arch):
    """tests/test_arch_smoke.py::test_train_step_decreases_loss on the port:
    the default TrainConfig (bf16 cast), lr 5e-3, five steps on one batch."""
    cfg = get_smoke_config(arch)
    model = model_init(cfg, 0, device="cpu")
    tcfg = TrainConfig(opt=OptimizerConfig(lr=5e-3, warmup_steps=1, total_steps=50))
    opt = init_opt_state(tcfg.opt, dict(model.named_parameters()))
    step = make_train_step(cfg, tcfg)
    batch = batch_to(lm_perf.smoke_batch(cfg, 2, 64), "cpu")
    losses = []
    for _ in range(5):
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["ce_loss"]))
        assert np.isfinite(losses[-1]), (arch, losses)
    assert losses[-1] < losses[0], (arch, losses)


def test_train_resume_equivalence(tmp_path):
    """tests/test_checkpoint.py::test_train_resume_equivalence on the port,
    bit for bit (lm_perf.resume_check, which chip_smoke.py runs on the card)."""
    row = lm_perf.resume_check(str(tmp_path / "resume"), "cpu")
    assert row == dict(restored_at=2, count=4, bit_equal=True)


def test_smoke_train_checks_run_on_the_cpu():
    """lm_perf.train_vs_cpu's checks with the CPU standing in for the card
    (chip_smoke.py phase 16c runs them on the card for every arch)."""
    row = lm_perf.train_vs_cpu("deepseek-v2-236b", "cpu")
    assert row["loss_rel_err"] == 0.0 and row["max_grad_gap"] == 0.0
    assert row["losses"][-1] < row["losses"][0]


def _cli(argv, capsys):
    train_cli.main(argv)
    return capsys.readouterr().out


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    """Microbatches, dots remat and bf16_ef at smoke width; checkpoints
    named by the updates they hold (count == step); a second run resumes
    from the newest and a third, with nothing left, saves nothing."""
    ckpt = str(tmp_path / "ck")
    args = ["--arch", "deepseek-7b", "--smoke", "--batch", "2", "--seq", "32", "--microbatches",
            "2", "--remat", "dots", "--grad-compression", "bf16_ef", "--ckpt-dir", ckpt,
            "--ckpt-every", "2", "--device", "cpu"]
    out = _cli(args + ["--steps", "3"], capsys)
    assert "trained 3 steps" in out
    out = _cli(args + ["--steps", "5"], capsys)
    assert "resumed at step 3" in out and "trained 2 steps" in out
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [3, 4, 5]
    for step in mgr.all_steps():
        arrays, _ = mgr.restore({"opt/count": (), "opt/ef/head.w": (128, 512)}, step=step)
        assert int(arrays["opt/count"]) == step
    out = _cli(args + ["--steps", "5"], capsys)
    assert "resumed at step 5" in out and "trained 0 steps" in out
    assert mgr.all_steps() == [3, 4, 5]


def test_train_cli_frames_and_refusals(tmp_path, capsys):
    out = _cli(["--arch", "hubert-xlarge", "--smoke", "--steps", "2", "--batch", "2", "--seq",
                "16", "--device", "cpu"], capsys)
    assert "trained 2 steps" in out
    nf = get_smoke_config("internvl2-2b").n_frontend_tokens
    with pytest.raises(SystemExit, match="frontend"):
        train_cli.main(["--arch", "internvl2-2b", "--smoke", "--seq", str(nf), "--device", "cpu"])


def test_train_cli_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "deepseek-7b", "--smoke", "--steps", "1"])


def test_checkpoint_holds_the_named_state(tmp_path):
    cfg = get_smoke_config("mamba2-370m")
    model = model_init(cfg, 0, device="cpu")
    opt = init_opt_state(OptimizerConfig(grad_compression="bf16_ef"),
                         dict(model.named_parameters()))
    mgr = CheckpointManager(str(tmp_path))
    train_cli.save_training(mgr, 1, model, opt, blocking=True)
    names = set(train_cli.training_state(model, opt))
    params = {n for n, _ in model.named_parameters()}
    assert names == ({f"params/{n}" for n in params} | {"opt/count"}
                     | {f"opt/{k}/{n}" for k in ("mu", "nu", "ef") for n in params})
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000001"))
