"""The restored shard points compute the same function over a real mesh.

Four gloo processes on the CPU (a ``FileStore`` under the test's tmp_path)
form a (data=2, model=2) ``DeviceMesh``; each builds the same smoke model
from one seed, lays its weights out by the rules
(``repro_torch.distributed.sharding.distribute_model``) and runs it as a
DTensor program inside ``mesh_rules``.  Against the same model with no mesh,
in float32:

- the forward's logits of deepseek-7b, qwen3-moe-235b-a22b and mamba2-370m
  within 1e-5 of max |logit|;
- a prefill and three decode steps under the decode cell's rules
  (``dryrun.cell_rules``), each step's logits within 1e-5 of max |logit|:
  deepseek-7b (the KV cache sharded on its heads), qwen3-moe-235b-a22b with
  one KV head (the heads do not divide the model axis, so the cache is
  sharded on its sequence: the flash-decoding combine and the offset cache
  write; the prompt and the steps cross the shards' boundary),
  deepseek-v2-236b (the MLA latent cache sharded on its rank) and
  mamba2-370m (the SSM states sharded on their heads);
- one train step of deepseek-7b, qwen3-moe-235b-a22b, mamba2-370m and
  deepseek-v2-236b: its loss within 1e-6 (relative), its gradients
  (float32 weights) within 1e-5 of the largest, and the update's
  global gradient norm within 1e-5.  (The weights after AdamW's first step
  are not compared: that step is ~lr · sign(g), so a gradient element at
  rounding level may flip a whole step.)

The fake-process-group dry run checks shapes and layouts only; this checks
the numbers.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import traceback

import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4
FORWARD_ARCHS = ("deepseek-7b", "qwen3-moe-235b-a22b", "mamba2-370m")
# one family each: dense, MoE, SSM, MLA with MoE
TRAIN_ARCHS = ("deepseek-7b", "qwen3-moe-235b-a22b", "mamba2-370m", "deepseek-v2-236b")
# arch -> config changes: one KV head, so that qwen3-moe's cache is sharded
# on its sequence over the model axis of 2
DECODE_ARCHS = {
    "deepseek-7b": {},
    "qwen3-moe-235b-a22b": {"n_kv_heads": 1},
    "deepseek-v2-236b": {},
    "mamba2-370m": {},
}
PROMPT, STEPS, CACHE = 14, 3, 24  # the cache's two sequence shards hold 12 each


def _worker(rank: int, store_path: str, out) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from torch.distributed.tensor import distribute_tensor

        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed.sharding import (
            ShardingCtx,
            distribute,
            distribute_model,
            mesh_rules,
        )
        from repro_torch.launch.dryrun import cache_spec_tree, cell_rules
        from repro_torch.launch.shapes import ShapeSpec
        from repro_torch.models.model import (
            cache_init,
            model_decode,
            model_forward,
            model_init,
            model_prefill,
        )
        from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
        from repro_torch.training.train import TrainConfig, make_train_step

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {}
        for arch in FORWARD_ARCHS:
            cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
            model = model_init(cfg, 0, device="cpu")
            tok = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
            with torch.no_grad():
                ref, _ = model_forward(cfg, model, tokens=tok)
                distribute_model(model, mesh)
                with mesh_rules(mesh):
                    got, _ = model_forward(cfg, model, tokens=distribute(tok, "batch", "seq"))
                got = got.full_tensor()
            res[arch] = float((got - ref).abs().max() / ref.abs().max())

        shape = ShapeSpec("decode", CACHE, 4, "decode")
        for arch, changes in DECODE_ARCHS.items():
            cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **changes)
            model = model_init(cfg, 0, device="cpu")
            tok = torch.randint(
                0, cfg.vocab_size, (4, PROMPT + STEPS), generator=torch.Generator().manual_seed(3)
            )
            rules = cell_rules(cfg, shape, mesh)
            ctx = ShardingCtx(mesh, rules)
            with torch.no_grad():
                caches = cache_init(cfg, 4, CACHE, device="cpu")
                ref = [model_prefill(cfg, model, tok[:, :PROMPT], caches)[0]]
                for i in range(STEPS):
                    ref.append(model_decode(cfg, model, tok[:, PROMPT + i], caches, PROMPT + i)[0])
                distribute_model(model, mesh, rules)
                plain = cache_init(cfg, 4, CACHE, device="cpu")
                caches = [
                    {
                        n: distribute_tensor(x, mesh, ctx.placements(spec), src_data_rank=None)
                        for (n, x), spec in zip(c.items(), specs.values())
                    }
                    for c, specs in zip(plain, cache_spec_tree(plain, ctx, rules))
                ]
                with mesh_rules(mesh, rules):
                    got = [model_prefill(cfg, model, distribute(tok[:, :PROMPT], "batch", "seq"), caches)[0]]
                    for i in range(STEPS):
                        token = distribute(tok[:, PROMPT + i], "batch")
                        got.append(model_decode(cfg, model, token, caches, PROMPT + i)[0])
            res[f"decode/{arch}"] = {
                "errs": [float((g.full_tensor() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)],
                "cache_layouts": sorted(
                    {f"{n}: {tuple(x.placements)}" for c in caches for n, x in c.items()}
                ),
            }

        for arch in TRAIN_ARCHS:
            cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
            g = torch.Generator().manual_seed(2)
            batch = {
                "tokens": torch.randint(0, cfg.vocab_size, (4, 32), generator=g),
                "labels": torch.randint(0, cfg.vocab_size, (4, 32), generator=g),
            }
            # float32 weights in the step too, so that the gradients are float32
            tcfg = TrainConfig(remat="full", param_gather_dtype="float32",
                               opt=OptimizerConfig(warmup_steps=1))
            plain = model_init(cfg, 0, device="cpu")
            step = make_train_step(cfg, tcfg)
            _, ref_g = step.grads(plain, batch)
            _, _, ref_m = step(plain, init_opt_state(tcfg.opt, dict(plain.named_parameters())), batch)
            model = distribute_model(model_init(cfg, 0, device="cpu"), mesh)
            with mesh_rules(mesh):
                sharded = {k: distribute(v, "batch", "seq") for k, v in batch.items()}
                step = make_train_step(cfg, tcfg)
                _, got_g = step.grads(model, sharded)
                opt = init_opt_state(tcfg.opt, dict(model.named_parameters()))
                _, _, got_m = step(model, opt, sharded)
            row = {}
            for key in ("total_loss", "grad_norm"):
                ref = float(ref_m[key])
                row[key] = abs(float(got_m[key].full_tensor()) - ref) / abs(ref)
            scale = max(float(g.abs().max()) for g in ref_g.values() if g is not None)
            row["grads"] = max(
                float((got_g[n].full_tensor() - g).abs().max()) for n, g in ref_g.items() if g is not None
            ) / scale
            res[f"train/{arch}"] = row
        if rank == 0:
            out.put(("ok", res))
    except Exception:  # noqa: BLE001 — reported to the test, which fails on it
        out.put(("error", f"rank {rank}: {traceback.format_exc()}"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=_worker, args=(r, store, out)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        status, value = out.get(timeout=240)
    except queue.Empty:
        status, value = "error", "no result within 240 s"
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    assert status == "ok", value
    assert all(not p.is_alive() for p in procs)
    return value


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_sharded_forward_matches_one_device(results, arch):
    assert results[arch] <= 1e-5, results


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_matches_one_device(results, arch):
    row = results[f"decode/{arch}"]
    assert len(row["errs"]) == 1 + STEPS, row
    assert max(row["errs"]) <= 1e-5, row


def test_decode_caches_take_each_sharded_layout(results):
    """The decode cases do reach the layouts they are meant to check."""
    layouts = {arch: " ".join(results[f"decode/{arch}"]["cache_layouts"]) for arch in DECODE_ARCHS}
    # (data, model): K/V on their heads; on their sequence; the latent on its rank
    assert "k: (Shard(dim=0), Shard(dim=2))" in layouts["deepseek-7b"], layouts
    assert "k: (Shard(dim=0), Shard(dim=1))" in layouts["qwen3-moe-235b-a22b"], layouts
    assert "c_kv: (Shard(dim=0), Shard(dim=2))" in layouts["deepseek-v2-236b"], layouts
    assert "ssm: (Shard(dim=0), Shard(dim=1))" in layouts["mamba2-370m"], layouts


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_one_device(results, arch):
    row = results[f"train/{arch}"]
    assert row["total_loss"] <= 1e-6, row
    assert row["grads"] <= 1e-5, row
    assert row["grad_norm"] <= 1e-5, row
