"""Batched serving demo on the PyTorch/CUDA port: prefill a prompt batch,
then decode with the KV cache.

The JAX example's program (``examples/serve_lm.py``) on ``repro_torch``:
the chosen architecture's reduced smoke config with random weights from
seed 0 (the same code path serves the full config).

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--arch mamba2-370m] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.adaptive import resolve_device
from repro_torch.models.model import model_init
from repro_torch.serving import ServeConfig, generate


def main(device: str = "cuda", arch: str = "deepseek-7b", batch: int = 4,
         prompt_len: int = 32, new_tokens: int = 32, temperature: float = 0.0) -> dict:
    """Generate ``new_tokens`` for a random prompt batch; returns the
    tokens (numpy, (batch, new_tokens)), the seconds and tokens/s."""
    cfg = get_smoke_config(arch)
    if not cfg.has_decode:
        raise SystemExit(f"{arch} is encoder-only: no decode step")
    dev = resolve_device(device)
    model = model_init(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    t0 = time.perf_counter()
    out = generate(cfg, model, prompt, n_tokens=new_tokens,
                   scfg=ServeConfig(temperature=temperature)).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={batch} new_tokens={new_tokens} on {dev}")
    print(f"generated ids[0]: {out[0]}")
    print(f"{batch * new_tokens / dt:,.1f} tok/s ({dt:.2f}s incl. the first call)")
    return dict(tokens=out, seconds=dt, tokens_per_s=batch * new_tokens / dt)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    main(a.device, a.arch, a.batch, a.prompt_len, a.new_tokens, a.temperature)
