"""Check and measure the LM serve path on the card.

    python -m repro_torch.launch.lm_perf serve
    python -m repro_torch.launch.lm_perf smoke

``serve`` runs each of ``SERVE_ARCHS`` at its published widths with
bfloat16 activations, random weights from seed 0 and ``SERVE_SHAPE``
(:func:`serve_case`).  The checks (:func:`serve_checks`): greedy
``generate`` twice (the same tokens), then a flat prefill and the decode
steps on generate's tokens, each step's logits held to one
``model_forward`` over every token fed (:func:`check_logits`), chunked
prefill held to flat, and the decode steps again in float32 held to a
float32 forward at a bar that decodes with a planted fault are shown to
miss (:func:`decode_controls`).  The generate calls, the prefill and the
decode steps are timed with CUDA events, then one stretch of decode steps
is profiled and split by kind (:func:`decode_profile`).  It prints the
prefill seconds, decode ms per token, tokens per second, peak memory, the
weights' bytes and a decode step's byte bounds (:func:`decode_step_bytes`).

``smoke`` runs every architecture's smoke config on the card against the
port on the CPU with the same float32 weights (:func:`smoke_vs_cpu`).

``train`` checks and measures the training path (:func:`train_all`):
deepseek-7b at its published widths with its depth cut to fit one card,
and mamba2-370m whole, each trained on one repeated batch from
``batch_for_step`` (seed 0) with the default ``TrainConfig`` (the bf16
weight cast) and the remat of ``TRAIN_CASES``: every loss finite, the last
below the first, each step timed with CUDA events, and the same steps run
twice give the same bits (:func:`train_case`); the three remat policies
at ``REMAT_SHAPE`` give the same loss and gradients bit for bit, with the
bytes each keeps for the backward, its peak and its forward-backward time
(:func:`remat_case`); every
smoke config's train step on the card against the CPU in float32 gather,
twice the same bits on the card, and five steps with a falling loss
(:func:`train_vs_cpu`); and a resumed run bit-equal to an unbroken one
(:func:`resume_check`).

Each result is one JSON line with the card's name and power limit.  Needs
a CUDA device; ``chip_smoke.py`` phase 15 calls these functions.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.adaptive import resolve_device
from repro_torch.data import DataConfig, batch_for_step, frame_batch_for_step
from repro_torch.models.layers import ATTENTION_RANGE, act_dtype
from repro_torch.models.model import (
    Model,
    cache_init,
    model_decode,
    model_forward,
    model_init,
    model_prefill,
    model_prefill_chunked,
)
from repro_torch.perf.machine import PRESETS, card
from repro_torch.serving import generate
from repro_torch.training import (
    OPTIMIZER_RANGE,
    OptimizerConfig,
    TrainConfig,
    batch_to,
    init_opt_state,
    lm_loss,
    make_train_step,
)
from repro_torch.training.train import compute_copy

SERVE_ARCHS = ("deepseek-7b", "mamba2-370m")
SERVE_SHAPE = dict(batch=4, prompt_len=512, new_tokens=32, chunk=128)
PROFILE_STEPS = 8
# bfloat16 against the same model's forward: max |dlogit| <= BF16_BAR *
# max |logit|, argmax equal where the top-2 gap exceeds twice that (the bar
# of tests/test_torch_lm_model.py); float32 card against CPU: rtol = atol
BF16_BAR = 5e-2
F32_TOL = 1e-4
# float32 decode against a float32 forward, relative to max |logit|
# (decode_controls): the bar that a decode with a planted fault must miss
DECODE_F32_BAR = 1e-3
PEAK_HBM_BYTES = PRESETS["h100-sxm"]["mem_bw"]
# NVIDIA's H100 SXM data sheet: dense bf16 tensor-core rate
PEAK_BF16_FLOPS = 989e12
# aten ops whose kernels are matrix products; casts are kernels under
# aten::_to_copy; attention elementwise is any other kernel inside
# ATTENTION_RANGE (a forward, or its recomputation under remat); optimizer
# is every kernel of apply_updates (OPTIMIZER_RANGE)
MATMUL_OPS = frozenset({"aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::einsum"})


def decode_step_bytes(cfg, batch: int, kv_len: int, *, cast_per_call: bool = True) -> int:
    """The least bytes one decode step moves at cache length ``kv_len``.

    Every matrix weight (2-D or more, not the embedding or the head) is read
    once: as float32 and written and read again as the activation dtype
    when cast per call (the reference's form, 4 + 2 * itemsize bytes a
    weight), or read once as a kept copy (itemsize).  The float32 head is
    read once, the embedding's ``batch`` rows, the vectors once; each
    layer's cache is read up to ``kv_len`` positions and written at one;
    the Mamba states are read and written; the logits are written.
    """
    es = act_dtype(cfg).itemsize
    total = 0
    for name, p in Model(cfg, device="meta").named_parameters():
        n = p.numel()
        if name == "embed.table":
            total += batch * cfg.d_model * 4
        elif name == "head.w":
            total += n * 4
        elif p.dim() >= 2:
            total += n * ((4 + 2 * es) if cast_per_call else es)
        else:
            total += n * 4
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "ssm":
            ssm = batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
            conv = batch * (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * es
            total += 2 * (ssm + conv)
        elif cfg.use_mla:
            total += batch * (kv_len + 1) * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * es
        else:
            row = batch * cfg.n_kv_heads * cfg.resolved_head_dim * es
            total += 2 * row * (kv_len + 1)
    return total + batch * cfg.vocab_size * 4


def logits_gap(got, ref, bar: float) -> tuple[float, str | None]:
    """max |got - ref| / max |ref|, and why ``got`` misses ``ref`` at
    ``bar``: max |dlogit| above ``bar`` * max |logit|, or an argmax that
    differs where the top-2 gap exceeds twice that (None when within)."""
    got, ref = got.float(), ref.float()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not err <= bar * scale:
        return err / scale, f"max |dlogit| {err} above {bar * scale}"
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * bar * scale
    if not torch.equal(got.argmax(-1)[clear], ref.argmax(-1)[clear]):
        return err / scale, f"argmax differs where the top-2 gap exceeds {2 * bar * scale}"
    return err / scale, None


def check_logits(got, ref, cfg, what: str) -> float:
    """Hold ``got`` to ``ref`` at the bar of the activation dtype (float32:
    rtol = atol = F32_TOL; else :func:`logits_gap` at BF16_BAR); returns
    max |got - ref| / max |ref|."""
    if cfg.dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=F32_TOL, atol=F32_TOL, msg=what)
        return float((got - ref).abs().max() / ref.abs().max())
    rel, miss = logits_gap(got, ref, BF16_BAR)
    if miss:
        raise AssertionError(f"{what}: {miss}")
    return rel


# the kinds that a profiled decode step's and train step's kernels are split into
DECODE_KINDS = ("matmul", "cast", "attention_elementwise", "other")
TRAIN_KINDS = ("matmul", "cast", "attention_elementwise", "optimizer", "other")


def _kind(evt) -> str:
    """The kind of the kernels that ``evt`` launched, from its op chain."""
    names = []
    while evt is not None:
        names.append(evt.name)
        evt = evt.cpu_parent
    if OPTIMIZER_RANGE in names:
        return "optimizer"
    if MATMUL_OPS.intersection(names):
        return "matmul"
    if "aten::_to_copy" in names:
        return "cast"
    if ATTENTION_RANGE in names:
        return "attention_elementwise"
    return "other"


def _device_split(prof, wall: float, kinds: tuple) -> dict:
    """A profile's device time: busy seconds (the union of the kernels',
    copies' and fills' intervals), the idle share of the profiled wall (an
    upper bound: the profiler adds host time), and the kernels' seconds by
    each of ``kinds`` (from their op chains, :func:`_kind`)."""
    # a named range (record_function) also shows as a device event that
    # spans its kernels: counted neither as a kernel nor as busy time
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    ranges = {e.name() for e in device if e.is_user_annotation()}
    by_kind = dict.fromkeys(kinds, 0.0)
    for evt in prof.events():
        kernels = [k for k in evt.kernels if k.name not in ranges]
        if kernels:
            by_kind[_kind(evt)] += sum(k.duration for k in kernels) / 1e6
    spans = sorted((e.start_ns(), e.end_ns()) for e in device if not e.is_user_annotation())
    busy, reach = 0, None
    for lo, hi in spans:
        if reach is None or lo > reach:
            busy += hi - lo
            reach = hi
        elif hi > reach:
            busy += hi - reach
            reach = hi
    busy /= 1e9
    return dict(profiled_wall_s=wall, device_busy_s=busy,
                idle_share=(1.0 - busy / wall) if busy else None, device_s_by_kind=by_kind,
                kinds_sum_s=sum(by_kind.values()))


def decode_profile(cfg, model, prompt, tokens, steps: int = PROFILE_STEPS) -> dict:
    """``steps`` decode steps (after a fresh prefill) on the card under
    torch.profiler, split by :func:`_device_split` (matmul, cast, attention
    elementwise, other)."""
    from torch.profiler import ProfilerActivity, profile

    dev = model.device
    b, s = prompt.shape
    caches = cache_init(cfg, b, s + steps, device=dev)
    _, caches = model_prefill(cfg, model, prompt, caches)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            _, caches = model_decode(cfg, model, tokens[:, i], caches, s + i)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return dict(steps=steps, **_device_split(prof, wall, DECODE_KINDS))


def full_width(arch: str):
    """``arch`` at its published widths with bfloat16 activations."""
    return dataclasses.replace(get_config(arch), dtype="bfloat16")


def decode_steps(cfg, model, prompt, tokens, *, shift: int = 0, stale_ssm: bool = False) -> list:
    """A fresh prefill of ``prompt``, then one decode step for each of
    ``tokens``' columns but the last; returns each step's logits.

    ``shift`` and ``stale_ssm`` plant the faults of :func:`decode_controls`:
    every step at position ``pos + shift``, and every Mamba layer's step
    from the prefill's SSM state.
    """
    b, s = prompt.shape
    caches = cache_init(cfg, b, s + tokens.shape[1] + shift, device=model.device)
    _, caches = model_prefill(cfg, model, prompt, caches)
    stale = {i: caches[i]["ssm"] for i in range(cfg.n_layers)
             if stale_ssm and cfg.layer_kind(i) == "ssm"}
    out = []
    for i in range(tokens.shape[1] - 1):
        for j, state in stale.items():
            caches[j] = dict(caches[j], ssm=state)
        logits, caches = model_decode(cfg, model, tokens[:, i], caches, s + i + shift)
        out.append(logits)
    return out


def decode_controls(cfg, model, prompt, tokens) -> dict:
    """The decode steps in float32 (the same weights and code, without the
    bf16 rounding that BF16_BAR has to allow) held to a float32
    ``model_forward`` at DECODE_F32_BAR, and the same steps with a planted
    fault, each of which must miss that bar at some step.  Models with
    attention: every step one position late (its K/V written one slot off,
    the query's offset wrong).  Models with Mamba layers: every step from
    the prefill's SSM state.  Returns the right decode's largest relative
    error and, per fault, its largest and the steps that miss the bar."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    s = prompt.shape[1]
    ref, _ = model_forward(cfg, model, tokens=torch.cat([prompt, tokens[:, :-1]], dim=1))

    def gaps(**fault):
        steps = decode_steps(cfg, model, prompt, tokens, **fault)
        return [logits_gap(x, ref[:, s + i], DECODE_F32_BAR) for i, x in enumerate(steps)]

    for i, (_, why) in enumerate(right := gaps()):
        if why:
            raise AssertionError(f"{cfg.name} float32 decode step {i}: {why}")
    out = dict(float32_max_rel_err=max(rel for rel, _ in right))
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    faults = {}
    if kinds - {"ssm"}:
        faults["position_plus_one"] = dict(shift=1)
    if "ssm" in kinds:
        faults["stale_ssm_state"] = dict(stale_ssm=True)
    for name, fault in faults.items():
        found = gaps(**fault)
        missed = sum(why is not None for _, why in found)
        worst = max(rel for rel, _ in found)
        if not missed:
            raise AssertionError(
                f"{cfg.name}: decode with the fault {name} stays within the bar at every step "
                f"(max relative error {worst}): the bar cannot tell it from a right decode")
        out[name] = dict(max_rel_err=worst, steps_missing_bar=missed, steps=len(found))
    return out


def serve_checks(cfg, model, prompt, new_tokens: int, chunk: int, mark=lambda: None) -> dict:
    """The serve checks of the module docstring for ``model`` on ``prompt``;
    raises on any failed check.  Returns generate's tokens, the largest
    relative errors and the controls' (:func:`decode_controls`).

    ``mark`` is called at six points, for the card's timing: around the two
    ``generate`` calls (before, between, after), then before the flat
    prefill, between it and the decode steps, and after them.
    """
    arch = cfg.name
    b, s = prompt.shape
    mark()
    tokens = generate(cfg, model, prompt, new_tokens)
    mark()
    again = generate(cfg, model, prompt, new_tokens)
    mark()
    # a flat prefill, then the decode steps on generate's tokens
    caches = cache_init(cfg, b, s + new_tokens, device=model.device)
    mark()
    prefill_logits, caches = model_prefill(cfg, model, prompt, caches)
    mark()
    step_logits = []
    for i in range(new_tokens - 1):
        logits, caches = model_decode(cfg, model, tokens[:, i], caches, s + i)
        step_logits.append(logits)
    mark()
    del caches
    if not torch.equal(tokens, again):
        raise AssertionError(f"{arch}: greedy generate differs run to run")
    greedy = torch.stack([prefill_logits.argmax(-1)] + [x.argmax(-1) for x in step_logits], 1)
    if not torch.equal(greedy, tokens):
        raise AssertionError(f"{arch}: the decode loop's greedy tokens are not generate's")

    # one forward over every token fed holds the prefill and each step
    fed = torch.cat([prompt, tokens[:, :-1]], dim=1)
    ref, _ = model_forward(cfg, model, tokens=fed)
    errs = [check_logits(prefill_logits, ref[:, s - 1], cfg, f"{arch} prefill")]
    errs += [check_logits(x, ref[:, s + i], cfg, f"{arch} decode step {i}")
             for i, x in enumerate(step_logits)]
    del step_logits, ref
    controls = decode_controls(cfg, model, prompt, tokens)
    chunked, _ = model_prefill_chunked(
        cfg, model, prompt, cache_init(cfg, b, s, device=model.device), chunk)
    chunk_err = check_logits(chunked, prefill_logits, cfg, f"{arch} chunked prefill")
    return dict(tokens=tokens, max_rel_err_steps=max(errs), max_rel_err_prefill=errs[0],
                max_rel_err_chunked=chunk_err, controls=controls)


def serve_case(cfg, *, batch: int, prompt_len: int, new_tokens: int, chunk: int,
               device="cuda") -> dict:
    """:func:`serve_checks` for ``cfg`` with random weights from seed 0 on
    the card, timed with CUDA events, then :func:`decode_profile`; returns
    the measurements and the checks' errors."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"serve_case times on a CUDA device, not {dev}; serve_checks runs anywhere")
    torch.cuda.reset_peak_memory_stats(dev)
    model = model_init(cfg, 0, device=dev)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    marks = []

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    with torch.inference_mode():
        checks = serve_checks(cfg, model, prompt, new_tokens, chunk, mark)
        profile = decode_profile(cfg, model, prompt, checks.pop("tokens"))
    torch.cuda.synchronize(dev)
    generate_first_s, generate_s, _, prefill_s, decode_s = (
        a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:]))
    steps = new_tokens - 1
    mean_kv = prompt_len + (steps - 1) / 2  # the cache length averaged over the steps
    bound = decode_step_bytes(cfg, batch, int(round(mean_kv)))
    kept = decode_step_bytes(cfg, batch, int(round(mean_kv)), cast_per_call=False)
    return dict(
        arch=cfg.name, dtype=cfg.dtype, batch=batch, prompt_len=prompt_len,
        new_tokens=new_tokens, chunk=chunk, params=sum(p.numel() for p in model.parameters()),
        param_bytes=param_bytes, prefill_s=prefill_s, decode_ms_per_token=decode_s / steps * 1e3,
        tokens_per_s=batch * steps / decode_s, generate_first_s=generate_first_s,
        generate_s=generate_s, peak_bytes=torch.cuda.max_memory_allocated(dev),
        decode_step_bytes=bound, decode_bound_ms=bound / PEAK_HBM_BYTES * 1e3,
        decode_step_bytes_kept_copies=kept, decode_bound_kept_copies_ms=kept / PEAK_HBM_BYTES * 1e3,
        **checks, decode_profile=profile,
    )


def smoke_inputs(cfg, batch: int, seq: int, seed: int = 0):
    """(tokens, embeds) as numpy: the VLM's frontend embeddings precede its
    tokens; the audio model takes frames only."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return None, rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    nf = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    embeds = rng.standard_normal((batch, nf, cfg.d_model)).astype(np.float32) if nf else None
    return rng.integers(0, cfg.vocab_size, (batch, seq - nf)), embeds


def smoke_vs_cpu(arch: str, device="cuda", *, batch: int = 2, prompt: int = 32,
                 n_decode: int = 4) -> dict:
    """The smoke config with the same float32 weights on ``device`` and on
    the CPU: forward logits and aux, and (models with a decode step) the
    prefill and each decode step's logits, within F32_TOL; returns the
    largest differences."""
    cfg = get_smoke_config(arch)
    dev = resolve_device(device)
    cpu_model = model_init(cfg, 0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    tokens, embeds = smoke_inputs(cfg, batch, prompt + n_decode)

    def on(target):
        tok = None if tokens is None else torch.as_tensor(tokens, device=target)
        emb = None if embeds is None else torch.as_tensor(embeds, device=target)
        return tok, emb

    out = {}
    with torch.inference_mode():
        runs = {}
        for target, model in (("cpu", cpu_model), ("card", card_model)):
            tok, emb = on(model.device)
            logits, aux = model_forward(cfg, model, tokens=tok, embeds=emb)
            seq = [logits[:, -1]]
            if cfg.has_decode:
                nf = 0 if emb is None else emb.shape[1]
                caches = cache_init(cfg, batch, prompt + n_decode, device=model.device)
                head = tok[:, : prompt - nf]
                last, caches = model_prefill(cfg, model, head, caches, embeds=emb)
                seq.append(last)
                for i in range(n_decode):
                    pos = prompt + i
                    last, caches = model_decode(cfg, model, tok[:, pos - nf], caches, pos)
                    seq.append(last)
            runs[target] = (logits, aux, seq)
        (c_logits, c_aux, c_seq), (g_logits, g_aux, g_seq) = runs["cpu"], runs["card"]
        out["forward"] = check_logits(g_logits.cpu(), c_logits, cfg, f"{arch} forward")
        for key in c_aux:
            torch.testing.assert_close(g_aux[key].cpu(), c_aux[key], rtol=F32_TOL, atol=F32_TOL)
        out["serve"] = max(check_logits(g.cpu(), c, cfg, f"{arch} serve step {i}")
                           for i, (g, c) in enumerate(zip(g_seq, c_seq)))
    return dict(arch=arch, family=cfg.family, has_decode=cfg.has_decode,
                embeds=embeds is not None, max_rel_err=out)


# --- training ------------------------------------------------------------------

# deepseek-7b keeps TRAIN_LAYERS of its 30 layers: a weight costs 16 bytes
# in training (the float32 master, mu and nu, the bf16 copy and its bf16
# gradient), the embedding and head 0.839 B weights, a layer 0.2024 B.  At
# 8 layers the peak held 5.1 GB above those bytes (remat full, 2 x 2048):
# 17 layers, 68.5 GB of state and ~73.9 GB at the peak, is the most whose
# peak stays under 90 % of the card's 85.0 GB
TRAIN_LAYERS = 17
# (arch, batch, seq, remat) of the full-width training cases
TRAIN_CASES = (("deepseek-7b", 2, 2048, "full"), ("mamba2-370m", 4, 2048, "full"))
TRAIN_WARMUP, TRAIN_TIMED = 2, 4
# lr of the full-width cases: from the first step (warmup 1), decaying
# over a run of 100
TRAIN_OPT = OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=100)
# the remat comparison: deepseek-7b at the cut, where "none" fits too
REMAT_SHAPE = dict(batch=2, seq=1024)
# the smoke train checks: tests/test_arch_smoke.py's batch and optimizer
SMOKE_TRAIN = dict(batch=2, seq=64)
SMOKE_OPT = OptimizerConfig(lr=5e-3, warmup_steps=1, total_steps=50)
# float32 gather, card against CPU: loss within rtol LOSS_RTOL, every
# gradient leaf within GRAD_BAR * its largest entry on the CPU
LOSS_RTOL = 1e-5
GRAD_BAR = 1e-4


def train_config(arch: str):
    """``arch`` at its published widths with bfloat16 activations;
    deepseek-7b cut to TRAIN_LAYERS layers."""
    cfg = full_width(arch)
    if arch == "deepseek-7b":
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    return cfg


def smoke_batch(cfg, batch: int, seq: int, seed: int = 1) -> dict:
    """A numpy training batch as tests/test_arch_smoke.py builds it: frames
    for audio; for the VLM, frontend embeddings (default_rng(0)) before the
    tokens, with the frontend positions masked out of the loss."""
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq, seed=seed)
    if cfg.family == "audio":
        return frame_batch_for_step(dc, 0, cfg.d_model)
    if cfg.family != "vlm":
        return batch_for_step(dc, 0)
    nf = cfg.n_frontend_tokens
    tok = batch_for_step(dataclasses.replace(dc, seq_len=seq - nf), 0)
    embeds = np.random.default_rng(0).standard_normal((batch, nf, cfg.d_model)).astype(np.float32)
    zeros = np.zeros((batch, nf), np.int32)
    return {
        "tokens": tok["tokens"],
        "embeds": embeds,
        "labels": np.concatenate([zeros, tok["labels"]], axis=1),
        "loss_mask": np.concatenate(
            [zeros.astype(np.float32), np.ones_like(tok["labels"], np.float32)], axis=1),
    }


def train_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per matrix-product weight per
    token (the embedding is a gather, the conv depthwise: neither counts),
    attention's 12 * layers * heads * head_dim * seq per token (QK^T and PV
    over every key, forward and backward), and the SSD's contractions,
    three times their forward."""
    tokens = batch * seq
    weights = sum(p.numel() for n, p in Model(cfg, device="meta").named_parameters()
                  if p.dim() >= 2 and n != "embed.table" and not n.endswith("conv_w"))
    flops = 6.0 * weights * tokens
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "ssm":
            q, n, hp = min(cfg.ssm_chunk, seq), cfg.ssm_state, cfg.ssm_heads * cfg.ssm_headdim
            flops += 3.0 * tokens * (2 * q * (n + hp) + 4 * n * hp)
        elif cfg.use_mla:
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            flops += 6.0 * tokens * seq * cfg.n_heads * (qk + cfg.v_head_dim)
        else:
            flops += 12.0 * tokens * seq * cfg.n_heads * cfg.resolved_head_dim
    return flops


def _host_params(model) -> dict:
    return {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}


def _train_run(cfg, tcfg, batch, dev, warmup: int, timed: int, profiled: bool = False) -> dict:
    """Fresh weights from seed 0, ``warmup + timed`` steps on ``batch``,
    each step between two CUDA events; returns the per-step losses and
    grad norms, the timed steps' ms, the peak memory and the final weights
    on the host.  ``profiled``: then one more step under torch.profiler,
    split by :func:`_device_split`."""
    torch.cuda.reset_peak_memory_stats(dev)
    model = model_init(cfg, 0, device=dev)
    opt = init_opt_state(tcfg.opt, dict(model.named_parameters()))
    step = make_train_step(cfg, tcfg)
    losses, norms, events = [], [], []
    for _ in range(warmup + timed):
        events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()
        model, opt, metrics = step(model, opt, batch)
        events[-1][1].record()
        losses.append(metrics["ce_loss"])
        norms.append(metrics["grad_norm"])
    torch.cuda.synchronize(dev)
    out = dict(
        losses=[float(x) for x in losses], grad_norms=[float(x) for x in norms],
        step_ms=[a.elapsed_time(b) for a, b in events[warmup:]],
        first_step_ms=events[0][0].elapsed_time(events[0][1]),
        peak_bytes=torch.cuda.max_memory_allocated(dev),
        params=sum(p.numel() for p in model.parameters()),
        weights=_host_params(model),
    )
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(model, opt, batch)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        out["profile"] = _device_split(prof, wall, TRAIN_KINDS)
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def train_case(cfg, *, batch: int, seq: int, remat: str, device="cuda",
               warmup: int = TRAIN_WARMUP, timed: int = TRAIN_TIMED) -> dict:
    """Train ``cfg`` (random weights from seed 0, the default TrainConfig
    with ``remat`` and TRAIN_OPT) on one batch of ``batch_for_step``
    (seed 0) twice; raises unless every loss is finite, the last is below
    the first and the two runs give the same losses, grad norms and final
    weights bit for bit.  Returns the step time (median of the timed
    steps), tokens/s, peak memory, the model-FLOP share of the bf16
    peak, and the device split of one more step of the second run under
    torch.profiler."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"train_case times on a CUDA device, not {dev}")
    tcfg = TrainConfig(remat=remat, opt=TRAIN_OPT)
    data = batch_to(batch_for_step(DataConfig(cfg.vocab_size, batch, seq, seed=0), 0), dev)
    first = _train_run(cfg, tcfg, data, dev, warmup, timed)
    second = _train_run(cfg, tcfg, data, dev, warmup, timed, profiled=True)
    losses = first["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: the loss did not fall: {losses}")
    same = (losses == second["losses"] and first["grad_norms"] == second["grad_norms"]
            and all(torch.equal(w, second["weights"][n]) for n, w in first["weights"].items()))
    if not same:
        raise AssertionError(f"{cfg.name}: two runs of the same steps differ")
    step_s = float(np.median(first["step_ms"])) / 1e3
    flops = train_model_flops(cfg, batch, seq)
    return dict(
        arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype, batch=batch, seq=seq,
        remat=remat, param_gather_dtype=tcfg.param_gather_dtype, params=first["params"],
        losses=losses, grad_norms=first["grad_norms"], step_ms=first["step_ms"],
        step_ms_second_run=second["step_ms"], first_step_ms=first["first_step_ms"],
        step_s=step_s, tokens_per_s=batch * seq / step_s,
        peak_bytes=first["peak_bytes"], peak_bytes_second_run=second["peak_bytes"],
        model_flops=flops, model_flop_share=flops / step_s / PEAK_BF16_FLOPS,
        runs_bit_equal=True, profile=second["profile"],
    )


def remat_case(cfg, *, batch: int, seq: int, device="cuda", reps: int = 3) -> dict:
    """The loss and its gradients for ``cfg`` (seed 0 weights, the bf16
    compute copy) on one batch under each remat policy: the loss and every
    gradient must be bit-equal to "none"'s.  Returns, per policy, the bytes
    the forward keeps for the backward (allocated after the loss, less
    before it), the peak above the memory held before the call (the bf16
    gradients included) and the forward-backward ms (CUDA events; the
    median of ``reps`` calls after one warm-up)."""
    dev = resolve_device(device)
    model = model_init(cfg, 0, device=dev)
    copy = compute_copy(cfg, dev, torch.bfloat16)
    with torch.no_grad():
        for c, p in zip(copy.parameters(), model.parameters()):
            c.copy_(p)
    del model
    params = list(copy.parameters())
    data = batch_to(batch_for_step(DataConfig(cfg.vocab_size, batch, seq, seed=0), 0), dev)
    rows, ref = {}, None
    for policy in ("none", "full", "dots"):
        times, saved, peak = [], 0, 0
        for _ in range(1 + reps):
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, _ = lm_loss(cfg, copy, data, policy)
            saved = torch.cuda.memory_allocated(dev) - before
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated(dev) - before
        rows[policy] = dict(saved_bytes=saved, peak_above_resident_bytes=peak,
                            fwd_bwd_ms=float(np.median(times[1:])), fwd_bwd_ms_all=times)
        if ref is None:
            ref = (loss.detach(), grads)
        elif not (torch.equal(loss, ref[0]) and all(
                (g is None and r is None) or torch.equal(g, r) for g, r in zip(grads, ref[1]))):
            raise AssertionError(f"{cfg.name}: remat {policy} changes the loss or a gradient")
        del loss, grads
        torch.cuda.empty_cache()
    del copy, params, ref
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, batch=batch, seq=seq,
                policies=rows, bit_equal=True)


def _max_leaf_gap(got: dict, ref: dict) -> float:
    """The largest over leaves of max |got - ref| / max |ref| (a missing
    gradient is zero)."""
    worst = 0.0
    for n, r in ref.items():
        g = got[n]
        r = torch.zeros(()) if r is None else r.float().cpu()
        g = torch.zeros(()) if g is None else g.float().cpu()
        scale = float(r.abs().max())
        gap = float((g - r).abs().max())
        worst = max(worst, gap / scale if scale else gap)
    return worst


def train_vs_cpu(arch: str, device="cuda", *, steps: int = 5) -> dict:
    """The smoke config's train step with the same float32 weights and
    batch on ``device`` and on the CPU, in float32 gather: the loss within
    LOSS_RTOL and every gradient leaf within GRAD_BAR of its largest entry
    on the CPU; the step's gradients twice on ``device``, bit-equal; then
    ``steps`` steps on ``device`` on the same batch, every loss finite and
    the last below the first (tests/test_arch_smoke.py's check)."""
    cfg = get_smoke_config(arch)
    dev = resolve_device(device)
    tcfg = TrainConfig(param_gather_dtype="float32", opt=SMOKE_OPT)
    batch = smoke_batch(cfg, **SMOKE_TRAIN)
    cpu_model = model_init(cfg, 0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    cpu_metrics, cpu_grads = make_train_step(cfg, tcfg).grads(cpu_model, batch_to(batch, "cpu"))
    step = make_train_step(cfg, tcfg)
    data = batch_to(batch, dev)
    metrics, grads = step.grads(card_model, data)
    again_metrics, again = step.grads(card_model, data)
    loss, ref = float(metrics["total_loss"]), float(cpu_metrics["total_loss"])
    if not abs(loss - ref) <= LOSS_RTOL * abs(ref):
        raise AssertionError(f"{arch}: loss {loss} on the card against {ref} on the CPU")
    gap = _max_leaf_gap(grads, cpu_grads)
    if not gap <= GRAD_BAR:
        raise AssertionError(f"{arch}: a gradient leaf is {gap} of its scale off the CPU's")
    if not (torch.equal(again_metrics["total_loss"], metrics["total_loss"]) and all(
            (g is None and again[n] is None) or torch.equal(g, again[n]) for n, g in grads.items())):
        raise AssertionError(f"{arch}: the step's gradients differ run to run on the card")
    opt = init_opt_state(tcfg.opt, dict(card_model.named_parameters()))
    losses = []
    for _ in range(steps):
        card_model, opt, m = step(card_model, opt, data)
        losses.append(float(m["ce_loss"]))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: losses {losses}")
    return dict(arch=arch, family=cfg.family, loss_rel_err=abs(loss - ref) / abs(ref),
                max_grad_gap=gap, runs_bit_equal=True, losses=losses)


def resume_check(directory: str, device="cuda") -> dict:
    """tests/test_checkpoint.py::test_train_resume_equivalence on the port:
    deepseek-7b smoke (batch 2 of 32 tokens, data seed 7, lr 1e-3), four
    steps against two, a checkpoint saved (in ``directory``, which must be
    empty or absent) and restored into fresh weights and state, and two
    more; every weight must be bit-equal."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import restore_training, save_training

    cfg = get_smoke_config("deepseek-7b")
    dev = resolve_device(device)
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=32, seed=7)
    step = make_train_step(cfg, tcfg)

    def fresh():
        model = model_init(cfg, 0, device=dev)
        return model, init_opt_state(tcfg.opt, dict(model.named_parameters()))

    def run(model, opt, lo, hi):
        for s in range(lo, hi):
            model, opt, _ = step(model, opt, batch_to(batch_for_step(dc, s), dev))
        return model, opt

    p4, _ = run(*fresh(), 0, 4)
    p2, o2 = run(*fresh(), 0, 2)
    mgr = CheckpointManager(directory)
    save_training(mgr, 2, p2, o2, blocking=True)
    model, opt = fresh()
    at = restore_training(mgr, model, opt)
    resumed, opt = run(model, opt, at, 4)
    equal = all(torch.equal(a, b) for a, b in zip(p4.parameters(), resumed.parameters()))
    if not (at == 2 and int(opt["count"]) == 4 and equal):
        raise AssertionError("a resumed run differs from the unbroken one")
    return dict(restored_at=at, count=int(opt["count"]), bit_equal=equal)


def train_all(smi: str, resume_dir: str, device="cuda") -> list:
    """Every training check and measurement of the module docstring, one
    JSON-ready row each (the full-width cases, the remat comparison, each
    smoke config, the resume into ``resume_dir``, which must be empty or
    absent)."""
    rows = []
    for arch, batch, seq, remat in TRAIN_CASES:
        rows.append(dict(what="lm_train", card=smi, **train_case(
            train_config(arch), batch=batch, seq=seq, remat=remat, device=device)))
        if arch == "deepseek-7b":
            rows.append(dict(what="lm_train_remat", card=smi, **remat_case(
                train_config(arch), device=device, **REMAT_SHAPE)))
    for arch in ARCH_IDS:
        rows.append(dict(what="lm_train_smoke", card=smi, **train_vs_cpu(arch, device)))
    rows.append(dict(what="lm_train_resume", card=smi, **resume_check(resume_dir, device)))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("serve", "smoke", "train"))
    args = ap.parse_args(argv)
    smi = card()
    if args.what == "train":
        with tempfile.TemporaryDirectory() as tmp:
            for row in train_all(smi, os.path.join(tmp, "resume")):
                print(json.dumps(row), flush=True)
    elif args.what == "serve":
        for arch in SERVE_ARCHS:
            row = serve_case(full_width(arch), **SERVE_SHAPE)
            print(json.dumps(dict(row, card=smi)), flush=True)
            torch.cuda.empty_cache()
    else:
        for arch in ARCH_IDS:
            print(json.dumps(dict(smoke_vs_cpu(arch), card=smi)), flush=True)


if __name__ == "__main__":
    main()
