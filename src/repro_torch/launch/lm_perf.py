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

Each result is one JSON line with the card's name and power limit.  Needs
a CUDA device; ``chip_smoke.py`` phase 15 calls these functions.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.adaptive import resolve_device
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
# aten ops whose kernels are matrix products; casts are kernels under
# aten::_to_copy; attention elementwise is any other kernel inside
# ATTENTION_RANGE
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


def _kind(evt) -> str:
    """The kind of the kernels that ``evt`` launched, from its op chain."""
    names = []
    while evt is not None:
        names.append(evt.name)
        evt = evt.cpu_parent
    if MATMUL_OPS.intersection(names):
        return "matmul"
    if "aten::_to_copy" in names:
        return "cast"
    if ATTENTION_RANGE in names:
        return "attention_elementwise"
    return "other"


def decode_profile(cfg, model, prompt, tokens, steps: int = PROFILE_STEPS) -> dict:
    """``steps`` decode steps (after a fresh prefill) on the card under
    torch.profiler: the device seconds by kind (matmul, cast, attention
    elementwise, other), their sum, and the idle share of the profiled wall
    (an upper bound: the profiler adds host time)."""
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
    by_kind = dict.fromkeys(("matmul", "cast", "attention_elementwise", "other"), 0.0)
    for evt in prof.events():
        if evt.kernels:
            by_kind[_kind(evt)] += sum(k.duration for k in evt.kernels) / 1e6
    busy = sum(by_kind.values())
    return dict(steps=steps, profiled_wall_s=wall, device_busy_s=busy,
                idle_share=(1.0 - busy / wall) if busy else None, device_s_by_kind=by_kind)


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("serve", "smoke"))
    args = ap.parse_args(argv)
    smi = card()
    if args.what == "serve":
        for arch in SERVE_ARCHS:
            row = serve_case(full_width(arch), **SERVE_SHAPE)
            print(json.dumps(dict(row, card=smi)), flush=True)
            torch.cuda.empty_cache()
    else:
        for arch in ARCH_IDS:
            print(json.dumps(dict(smoke_vs_cpu(arch), card=smi)), flush=True)


if __name__ == "__main__":
    main()
