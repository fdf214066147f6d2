"""LM serving launcher (batched prefill + decode): the port of
:mod:`repro.launch.serve`, with random weights from seed 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b --smoke \\
      --batch 4 --prompt-len 64 --new-tokens 32 [--chunked-prefill 16] --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --batch 4 --prompt-len 64 --new-tokens 16

Runs on the CUDA device unless ``--device cpu`` is given; without --smoke
the model has its published widths (deepseek-7b: 27.6 GB of float32
weights).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.adaptive import resolve_device
from repro_torch.models.model import (
    cache_init,
    model_decode,
    model_init,
    model_prefill,
    model_prefill_chunked,
)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--chunked-prefill", type=int, default=0, help="chunk size")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only (no decode step)")
    device = resolve_device(args.device)

    model = model_init(cfg, 0, device=device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)), device=device
    )
    caches = cache_init(cfg, args.batch, args.prompt_len + args.new_tokens, device=device)

    _sync(device)
    t0 = time.perf_counter()
    if args.chunked_prefill:
        logits, caches = model_prefill_chunked(cfg, model, prompt, caches, args.chunked_prefill)
    else:
        logits, caches = model_prefill(cfg, model, prompt, caches)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    token = torch.argmax(logits, dim=-1)
    out = [token]
    t0 = time.perf_counter()
    for i in range(args.new_tokens - 1):
        logits, caches = model_decode(cfg, model, token, caches, args.prompt_len + i)
        token = torch.argmax(logits, dim=-1)
        out.append(token)
    _sync(device)
    t_decode = time.perf_counter() - t0
    toks = torch.stack(out, dim=1).cpu().numpy()
    print(f"{cfg.name}: prompt {args.prompt_len}, generated {args.new_tokens} on {device}")
    print(f"sample[0]: {toks[0]}")
    print(
        f"prefill {t_prefill:.2f}s; decode {t_decode:.2f}s "
        f"({args.batch * (args.new_tokens - 1) / max(t_decode, 1e-9):,.1f} tok/s)"
    )


if __name__ == "__main__":
    main()
