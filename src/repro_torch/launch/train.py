"""LM training launcher: the port of :mod:`repro.launch.train`, on one
device with random weights from seed 0 and the synthetic data stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --smoke \\
      --steps 20 [--microbatches 2] [--remat dots] [--grad-compression bf16_ef] \\
      [--ckpt-dir DIR --ckpt-every 50] --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --steps 20 --batch 4 --seq 512

Runs on the CUDA device unless ``--device cpu`` is given; without --smoke
the model has its published widths.  ``--zero1`` is accepted and changes
nothing on one device (``training/optimizer.py``).

Checkpoints hold ``params/<name>`` and ``opt/{mu,nu,ef}/<name>`` under the
port's per-layer parameter names, and ``opt/count``; the step a checkpoint
is named by is the number of updates it holds.  With ``--ckpt-dir`` the run
resumes from the newest checkpoint there.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.adaptive import resolve_device
from repro_torch.data import DataConfig, batch_for_step, frame_batch_for_step
from repro_torch.models.model import Model, model_init
from repro_torch.training import (
    OptimizerConfig,
    TrainConfig,
    batch_to,
    init_opt_state,
    make_train_step,
)


def build_batch(cfg, dc: DataConfig, step: int) -> dict:
    """The step's numpy batch: frames for audio, tokens otherwise."""
    if cfg.family == "audio":
        return frame_batch_for_step(dc, step, cfg.d_model)
    return batch_for_step(dc, step)


def training_state(model: Model, opt: dict) -> dict:
    """Every tensor of the training state by its checkpoint name (the
    module docstring)."""
    out = {f"params/{n}": p for n, p in model.named_parameters()}
    for key in ("mu", "nu", "ef"):
        for n, t in opt.get(key, {}).items():
            out[f"opt/{key}/{n}"] = t
    out["opt/count"] = opt["count"]
    return out


def save_training(mgr: CheckpointManager, step: int, model: Model, opt: dict, **kw) -> None:
    mgr.save(step, {n: t.detach().cpu().numpy() for n, t in training_state(model, opt).items()}, **kw)


@torch.no_grad()
def restore_training(mgr: CheckpointManager, model: Model, opt: dict) -> int:
    """Load the newest checkpoint into ``model`` and ``opt`` in place;
    returns its step."""
    state = training_state(model, opt)
    arrays, step = mgr.restore({n: tuple(t.shape) for n, t in state.items()})
    for name, t in state.items():
        t.copy_(torch.from_numpy(arrays[name]))
    return step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--grad-compression", default="none", choices=["none", "bf16_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "vlm" and args.seq <= cfg.n_frontend_tokens:
        raise SystemExit("--seq must exceed the VLM frontend token count")
    device = resolve_device(args.device)

    tcfg = TrainConfig(
        remat=args.remat,
        microbatches=args.microbatches,
        opt=OptimizerConfig(
            lr=args.lr,
            warmup_steps=max(2, args.steps // 10),
            total_steps=args.steps,
            zero1=args.zero1,
            grad_compression=args.grad_compression,
        ),
    )
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq)
    model = model_init(cfg, 0, device=device)
    opt = init_opt_state(tcfg.opt, dict(model.named_parameters()))
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    start = 0
    if mgr and mgr.latest_step() is not None:
        start = restore_training(mgr, model, opt)
        print(f"resumed at step {start}")

    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params on {device}")
    step_fn = make_train_step(cfg, tcfg)

    saved = start
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = batch_to(build_batch(cfg, dc, step), device)
        model, opt, metrics = step_fn(model, opt, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(
                f"step {step:4d} loss {float(metrics['ce_loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.2f}",
                flush=True,
            )
        if mgr and (step + 1) % args.ckpt_every == 0:
            save_training(mgr, step + 1, model, opt)
            saved = step + 1
    if mgr and saved < args.steps:
        save_training(mgr, args.steps, model, opt, blocking=True)
    if mgr:
        mgr.wait()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"trained {max(args.steps - start, 0)} steps in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
