"""The port's CLIs: --strict (the cases of ``tests/test_chaos.py``), the
telemetry flags, --request, the window flags, and the refused Pallas flags.

The CLIs run in process through ``main(argv)`` on the CPU (``--device
cpu``); the telemetry files they write are checked by
``python -m repro_torch.telemetry.check`` (and by the JAX checker).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import integrate as integrate_cli
from repro_torch.launch import serve_quad

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv, capsys):
    """(exit code, stdout, stderr) of ``main(argv)`` run in process."""
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    out = capsys.readouterr()
    return code, out.out, out.err


def _integrate(capsys, *args):
    return _run(integrate_cli.main, ["--device", "cpu", *args], capsys)


def _serve(capsys, *args):
    return _run(serve_quad.main, ["--device", "cpu", *args], capsys)


# --- launch/integrate --strict ---------------------------------------------------------

_GAUSS = ("--integrand", "genz_gaussian", "--d", "2", "--capacity", str(1 << 10))


def test_strict_passes_on_converged_run(capsys):
    code, out, err = _integrate(capsys, "--strict", *_GAUSS, "--rel-tol", "1e-4")
    assert code == 0, err[-4000:]
    assert "STRICT" not in err and "[converged]" in out


def test_strict_fails_on_unconverged_run(capsys):
    code, out, err = _integrate(capsys, "--strict", *_GAUSS, "--rel-tol", "1e-10",
                                "--max-iters", "2")
    assert code == 1, (code, err[-2000:])
    assert "STRICT" in err
    assert "max_iters" in err  # names the status and a fix hint
    assert "[max_iters]" in out  # the result line still prints


def test_strict_without_flag_exits_zero_on_unconverged(capsys):
    code, out, err = _integrate(capsys, *_GAUSS, "--rel-tol", "1e-10", "--max-iters", "2")
    assert code == 0, err[-4000:]
    assert "[max_iters]" in out


# --- launch/serve_quad --strict and --chaos-fail-device ----------------------------------

_SERVE_ARGS = (
    "--d", "2",
    "--n-requests", "8",
    "--batch-slots", "8",
    "--rel-tol", "1e-3",
    "--capacity", str(1 << 10),
    "--max-iters", "80",
)


def test_serve_strict_degraded_run_exits_zero_with_provenance(capsys):
    code, out, err = _serve(capsys, *_SERVE_ARGS, "--devices", "2",
                            "--chaos-fail-device", "1:2", "--strict")
    assert code == 0, (out + err)[-4000:]
    assert "STRICT-DEGRADED" in out, out[-4000:]
    assert "retried_from=device_lost" in out
    assert "evacuated=readmit" in out
    assert "STRICT:" not in out


def test_serve_strict_fails_on_unconverged_run(capsys):
    code, out, err = _serve(capsys, "--d", "2", "--n-requests", "2", "--batch-slots", "2",
                            "--rel-tol", "1e-12", "--capacity", str(1 << 9),
                            "--max-iters", "2", "--strict")
    assert code == 1, (code, out[-2000:])
    assert "STRICT:" in out
    assert "max_iters" in out


def test_serve_chaos_flag_validation(capsys):
    code, _, err = _serve(capsys, *_SERVE_ARGS, "--chaos-fail-device", "0:2")
    assert code != 0


# --- telemetry files --------------------------------------------------------------------


def _check(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.telemetry.check", *args],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)


def test_integrate_trace_and_metrics_pass_the_checker(capsys, tmp_path):
    from repro.telemetry.check import check_metrics as jcheck_metrics
    from repro.telemetry.check import check_trace as jcheck_trace

    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    code, out, err = _integrate(capsys, "--integrand", "f4", "--d", "3", "--rel-tol", "1e-6",
                                "--trace", trace, "--metrics", metrics, "--telemetry-summary",
                                "--strict")
    assert code == 0, err
    assert f"wrote Chrome trace: {trace}" in out and "core.eval" in out  # the summary
    proc = _check("--trace", trace, "--metrics", metrics)
    assert proc.returncode == 0, proc.stderr
    assert "telemetry check OK" in proc.stdout
    assert jcheck_trace(trace) == [] and jcheck_metrics(metrics) == []


def test_distributed_and_vegas_runs_record(capsys, tmp_path):
    from repro_torch.telemetry import read_jsonl
    from repro_torch.telemetry.check import main as check_main

    metrics = str(tmp_path / "d.jsonl")
    code, _, err = _integrate(capsys, "--devices", "3", "--integrand", "f6", "--d", "3",
                              "--rel-tol", "1e-4", "--capacity", "2048", "--metrics", metrics)
    assert code == 0, err
    names = {e["name"] for e in read_jsonl(metrics)}
    assert {"dist.dispatch", "dist.work_imb", "dist.iter"} <= names
    trace = str(tmp_path / "v.json")
    code, _, err = _integrate(capsys, "--backend", "vegas", "--d", "4", "--integrand",
                              "genz_gaussian", "--rel-tol", "1e-2", "--mc-samples", "2048",
                              "--trace", trace)
    assert code == 0, err
    assert check_main(["--trace", trace]) == 0
    assert any(e.get("name") == "mc.iterate" for e in json.load(open(trace))["traceEvents"])


def test_serve_trace_and_metrics_pass_the_checker(capsys, tmp_path):
    trace, metrics = str(tmp_path / "q.json"), str(tmp_path / "q.jsonl")
    code, out, err = _serve(capsys, *_SERVE_ARGS, "--devices", "4", "--chaos-fail-device",
                            "2:3:9", "--n-requests", "16", "--trace", trace, "--metrics",
                            metrics, "--strict", "--telemetry-summary")
    assert code == 0, (out + err)[-4000:]
    assert "service.dispatches" in out  # the summary table
    proc = _check("--trace", trace, "--metrics", metrics, "--devices", "4",
                  "--expect-flow-name", "service.evacuate")
    assert proc.returncode == 0, proc.stderr


# --- --request, the window flags, the refused flags ----------------------------------------


def _result_lines(out):
    return sorted(line.split("] ", 1)[1] for line in out.splitlines() if line.startswith("["))


def test_serve_request_specs(capsys):
    specs = ["genz_gaussian:5,5:0.3,0.7", "genz_gaussian:8,2:0.5,0.5"]
    argv = ["--d", "2", "--rel-tol", "1e-8", "--batch-slots", "2", "--validate"]
    for spec in specs:
        argv += ["--request", spec]
    for rule in ("genz_malik", "gauss_kronrod"):
        code, out, err = _serve(capsys, *argv, "--rule", rule)
        assert code == 0, err
        lines = _result_lines(out)
        assert len(lines) == 2 and all("[converged]" in l for l in lines), out
        assert f"rule={rule}" in out
    code, _, err = _serve(capsys, "--d", "2", "--request", "monomial:1,2")
    assert code != 0


@pytest.mark.parametrize("flag", ["--no-eval-window", "--no-advance-window"])
def test_integrate_window_flags_keep_the_bits(capsys, flag):
    args = ("--integrand", "f4", "--d", "3", "--rel-tol", "1e-6", "--capacity", "4096")
    _, on, _ = _integrate(capsys, *args)
    code, off, err = _integrate(capsys, *args, flag)
    assert code == 0, err
    assert off.splitlines()[0] == on.splitlines()[0]


def test_serve_advance_window_off_keeps_the_bits(capsys):
    args = ("--d", "2", "--n-requests", "6", "--batch-slots", "2", "--rel-tols", "1e-3,1e-7")
    _, on, _ = _serve(capsys, *args)
    code, off, err = _serve(capsys, *args, "--no-advance-window")
    assert code == 0, err
    assert _result_lines(off) == _result_lines(on) and len(_result_lines(on)) == 6


@pytest.mark.parametrize("flag", ["--use-kernel", "--interpret", "--no-interpret"])
@pytest.mark.parametrize("cli", ["integrate", "serve_quad"])
def test_pallas_flags_are_refused(capsys, cli, flag):
    main = integrate_cli.main if cli == "integrate" else serve_quad.main
    code, _, err = _run(main, ["--device", "cpu", flag], capsys)
    assert code == 2 and "out of scope" in err, err[-500:]
