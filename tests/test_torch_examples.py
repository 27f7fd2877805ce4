"""The port's twins of the JAX package's example drivers
(``src/repro_torch/examples/``), on the CPU at small sizes.

* Every twin runs on ``cuda`` unless asked for the CPU, and raises here
  without a card before it does any work.
* The seeded DES is the reference's, number for number: ``latency_study``'s
  table and ``serve_parm``'s sim replay equal the lines the reference
  examples print in the same process, and so does ``serve_lm``'s
  token-level DES once it prices a token at the reference's rates (the twin
  prices it on the H100's data sheet, the reference on its own
  accelerator's; at equal rates the roofline arithmetic is the same
  expression, so the service time is equal too, not close).
* The model-running twins: the quickstart's A_a >= 0.95 and its rebuilt
  class printed; ``serve_parm`` answers every query, some through parity;
  ``serve_lm`` finishes every request with rebuilt steps;
  ``train_parity_lm``'s losses are finite and its parity MSE falls.
* Nothing under ``src/repro_torch/`` imports the JAX package or JAX.
"""
import ast
import contextlib
import importlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
TWINS = ("quickstart", "serve_parm", "latency_study", "serve_lm",
         "train_parity_lm")


@pytest.fixture(autouse=True)
def _one_thread():
    """The twins' models are tiny: one intra-op thread runs them fastest,
    and keeps them fast beside the other test workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twin(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _run_reference(name, argv, monkeypatch):
    """``examples/<name>.py``'s main() with ``argv``: its printed lines."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue().splitlines()


def _run_twin(name, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _twin(name).main([*argv, "--device", "cpu"])
    return out, buf.getvalue().splitlines()


# --------------------------------------------------------------------------
def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 60
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert {f.stem for f in files} >= set(TWINS)


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_cuda_and_raises_without_a_card(name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        _twin(name).main([])


# --------------------------------------------------------------------------
# the DES against the reference examples
# --------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--n", "3000"],
    ["--n", "3000", "--r", "2", "--scenario", "crash"],
    ["--n", "3000", "--qps", "520", "--batch-size", "4"],
    ["--smoke", "--controller", "threshold", "--scenario", "bursty"],
    ["--n", "2000", "--scheme", "learned", "--m", "8"],
], ids=["default", "crash-r2", "batched", "controller", "learned"])
def test_latency_study_table_equals_reference(argv, monkeypatch):
    want = _run_reference("latency_study", argv, monkeypatch)
    rows, got = _run_twin("latency_study", argv)
    assert got == want
    assert set(rows) == {"none", "equal_resources", "parm", "approx_backup",
                         "replication"}
    for strat, row in rows.items():
        line = next(ln for ln in got if ln.startswith(f"{strat:18s} "))
        assert f"{row['p999_ms']:7.1f}ms" in line


def test_serve_parm_serves_and_its_sim_replay_equals_reference(monkeypatch):
    argv = ["--n", "24", "--straggle-ms", "400"]
    want = _run_reference("serve_parm", argv, monkeypatch)
    out, got = _run_twin("serve_parm", argv)
    sim = [ln for ln in got if ln.startswith("sim replay")]
    assert sim == [ln for ln in want if ln.startswith("sim replay")]
    assert sim == [f"sim replay of the same spec: {out['sim_summary']}"]
    assert out["answered"] == 24 == sum(out["completed_by"].values())
    assert out["completed_by"].get("parity", 0) > 0
    assert out["accuracy"]["model"] > 0.9


def test_serve_lm_serves_and_its_des_equals_reference(monkeypatch):
    from repro_torch.launch.roofline import Hardware
    import repro.launch.roofline as jroof
    tokens = 2000
    want = _run_reference("serve_lm", ["--requests", "2", "--max-new", "3",
                                       "--sim-tokens", str(tokens)],
                          monkeypatch)
    out, got = _run_twin("serve_lm", ["--requests", "2", "--max-new", "3",
                                      "--sim-tokens", str(tokens)])
    assert out["done"] == 2 and len(out["requests"]) == 2
    assert all(len(r["tokens"]) == 3 for r in out["requests"])
    assert out["reconstructed_steps"] > 0
    assert out["sim_step_ms"] > 0 and out["sim_coded"].startswith("[sim]")

    rates = Hardware(peak_flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW,
                     link_bw=jroof.LINK_BW, name="the reference's")
    step_ms, coded, uncoded = _twin("serve_lm").sim_study(tokens, "cpu",
                                                          rates)
    assert f"sim: qwen3-moe-235b decode step = {step_ms:.2f}ms " \
           f"(roofline, kv_len=4096, tp=8)" in want
    assert f"sim coded:   {coded.summary()}" in want
    assert f"sim uncoded: {uncoded.summary()}" in want


# --------------------------------------------------------------------------
# the model-running twins
# --------------------------------------------------------------------------
def test_quickstart_trains_and_rebuilds():
    out, lines = _run_twin("quickstart", [])
    assert out["A_a"] >= 0.95
    assert f"true class of X2:           {out['true_class']} " \
           f"(label {out['label']})" in lines
    assert f"reconstructed prediction:   {out['reconstructed_class']}" \
        in lines
    assert np.isfinite(out["l2_gap"])


def test_train_parity_lm_losses_finite_and_mse_falls():
    out, lines = _run_twin("train_parity_lm", ["--steps", "4",
                                               "--parity-steps", "12"])
    mse = out["parity_mse"]
    assert len(mse) == 12 and len(out["deployed_losses"]) == 4
    assert np.isfinite(mse + out["deployed_losses"]).all()
    assert np.mean(mse[-3:]) < np.mean(mse[:3])
    assert 0.0 <= out["agreement"] <= 1.0
    assert lines[-1].startswith("degraded-mode top-1 agreement")


def test_latency_study_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.latency_study",
         "--smoke", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.splitlines()[2].split()[0] == "strategy"
