"""The port's examples, run in process on the CPU: the three quadrature
examples, and the two LM examples (serving, training with resume).

``examples/torch_{quickstart,distributed_quadrature,batch_service}.py``
are the JAX examples' programs on ``repro_torch``; each ``main(device=
"cpu")`` finishes in seconds.  Each result is held to its bar: the true
relative error within 5 rel_tol on one device, 10 rel_tol over ranks, and
the service's 10 max(error, budget).
"""

import os
import runpy

import pytest

_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _main(name):
    return runpy.run_path(os.path.join(_EXAMPLES, name))["main"]


def test_quickstart(capsys):
    out = _main("torch_quickstart.py")(device="cpu")
    for case in ("f4", "banana"):
        assert out[case]["result"].status == "converged"
        assert out[case]["true_rel_err"] <= 5 * out[case]["rel_tol"], case
    assert "custom banana, d=2" in capsys.readouterr().out


def test_banana_reference_value():
    exact = runpy.run_path(os.path.join(_EXAMPLES, "torch_quickstart.py"))["banana_exact"]()
    assert exact == pytest.approx(0.4287206694209, abs=1e-12)


def test_distributed_quadrature(capsys):
    out = _main("torch_distributed_quadrature.py")(device="cpu")
    for redis in ("ring", "off"):
        res = out[redis]["result"]
        assert res.status == "converged" and res.n_devices == 8
        assert out[redis]["true_rel_err"] <= 10 * out[redis]["rel_tol"]
    assert out["ring"]["mean_imbalance"] < out["off"]["mean_imbalance"]
    assert "redistribution=off" in capsys.readouterr().out


def test_batch_service(capsys):
    out = _main("torch_batch_service.py")(device="cpu")
    assert len(out["batch"]) == len(out["served"]) == 24
    assert all(r.status == "converged" for r in out["batch"] + out["served"])
    assert out["worst_vs_bar"] <= 10
    for a, b in zip(out["batch"], out["served"]):
        assert (a.integral, a.n_evals) == (b.integral, b.n_evals)
    assert "integrate_batch: 24 problems" in capsys.readouterr().out


def test_serve_lm(capsys):
    """examples/torch_serve_lm.py: greedy tokens of the deepseek-7b smoke
    config, the same as the port's generate on the same weights and prompt."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import model_init
    from repro_torch.serving import generate

    out = _main("torch_serve_lm.py")(device="cpu", new_tokens=8)
    assert out["tokens"].shape == (4, 8)
    cfg = get_smoke_config("deepseek-7b")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)))
    ref = generate(cfg, model_init(cfg, 0, device="cpu"), prompt, 8).numpy()
    assert np.array_equal(out["tokens"], ref)
    assert "arch=deepseek-7b-smoke" in capsys.readouterr().out


def test_train_lm_trains_and_resumes(tmp_path, capsys):
    """examples/torch_train_lm.py at a CPU size (the 10m model, 4 x 64
    tokens): the loss falls over 12 steps; run again to 16 steps it resumes
    from the checkpoint at step 12."""
    train = _main("torch_train_lm.py")
    kw = dict(device="cpu", ckpt_dir=str(tmp_path / "ck"), batch=4, seq=64, ckpt_every=8)
    first = train(steps=12, **kw)
    assert first["start"] == 0 and len(first["losses"]) == 12
    assert first["losses"][-1] < first["losses"][0]
    again = train(steps=16, **kw)
    assert again["start"] == 12 and len(again["losses"]) == 4
    assert "resumed from checkpoint step 12" in capsys.readouterr().out
