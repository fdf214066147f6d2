"""End-to-end training driver on the PyTorch/CUDA port: train a dense LM
on the synthetic pipeline with checkpointing and resume.

The JAX example's program (``examples/train_lm.py``) on ``repro_torch``.
Defaults are CPU-sized (a ~10M model, 40 steps); ``--model 100m --steps
300`` is the full run on the card.  The checkpoint directory has no
default: a directory that holds checkpoints is resumed from, so pass a
fresh one to start over.

Run: PYTHONPATH=src python examples/torch_train_lm.py --ckpt-dir "$(mktemp -d)" [--steps N]
     [--model 10m|100m] [--device cpu]
"""

import argparse
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.adaptive import resolve_device
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.launch.train import restore_training, save_training
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import model_init
from repro_torch.training import (
    OptimizerConfig,
    TrainConfig,
    batch_to,
    init_opt_state,
    make_train_step,
)

MODELS = {
    # ~10M params: CPU-friendly demo
    "10m": ModelConfig(
        name="demo-10m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=4096, dtype="float32",
    ),
    # ~124M params: the deliverable-scale driver (same code path)
    "100m": ModelConfig(
        name="demo-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=3072, vocab_size=32768, dtype="bfloat16",
    ),
}


def main(device: str = "cuda", *, ckpt_dir: str, model: str = "10m", steps: int = 40,
         batch: int = 8, seq: int = 256, ckpt_every: int = 20) -> dict:
    """Train (resuming from ``ckpt_dir``'s newest checkpoint if there is
    one); returns the step it started from and each trained step's loss."""
    cfg = MODELS[model]
    dev = resolve_device(device)
    tcfg = TrainConfig(
        remat="none",
        opt=OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=steps),
    )
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq)
    mgr = CheckpointManager(ckpt_dir, keep=2)

    lm = model_init(cfg, 0, device=dev)
    opt = init_opt_state(tcfg.opt, dict(lm.named_parameters()))
    start = 0
    if mgr.latest_step() is not None:
        start = restore_training(mgr, lm, opt)
        print(f"resumed from checkpoint step {start}")

    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params on {dev}")
    step_fn = make_train_step(cfg, tcfg)

    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        lm, opt, metrics = step_fn(lm, opt, batch_to(batch_for_step(dc, step), dev))
        losses.append(metrics["ce_loss"])
        if step % 5 == 0 or step == steps - 1:
            tok_s = batch * seq * (step - start + 1) / (time.perf_counter() - t0)
            print(
                f"step {step:4d}  loss {float(metrics['ce_loss']):.4f}  "
                f"grad_norm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  {tok_s:,.0f} tok/s"
            )
        if (step + 1) % ckpt_every == 0:
            save_training(mgr, step + 1, lm, opt)
    if start < steps and steps % ckpt_every:
        save_training(mgr, steps, lm, opt, blocking=True)
    mgr.wait()
    print(f"done; checkpoints in {ckpt_dir}")
    return dict(start=start, losses=[float(x) for x in losses])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="10m", choices=list(MODELS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", required=True,
                    help="a fresh directory starts over; one with checkpoints is resumed from")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    main(a.device, ckpt_dir=a.ckpt_dir, model=a.model, steps=a.steps, batch=a.batch, seq=a.seq,
         ckpt_every=a.ckpt_every)
