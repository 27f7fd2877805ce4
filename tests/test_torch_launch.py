"""The port's launch layer (``launch/steps.py``, ``launch/train.py``,
``launch/serve.py``) against the JAX package, on the CPU.

Parameter counts are compared exactly.  The launcher's train step, with and
without gradient accumulation, is held against the reference's
(``shard_logits=False``: one card has no mesh) over three steps: losses
within 1e-5 relative, parameters within 1e-6, with Adam's eps at 1e-3 for
the reason ``tests/test_torch_train.py`` gives.  The two launchers run end
to end with ``--device cpu`` at tiny sizes; the train launcher's logged
losses are those of ``train_lib.make_train_step`` on the same data.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.training import optim as joptim
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, tree_leaves
from repro_torch.data.pipeline import lm_batches
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain_launch
from repro_torch.models import transformer as T
from repro_torch.training import optim as toptim
from repro_torch.training import train_lib as ttrain

DENSE = ["smollm-135m", "qwen2-0.5b", "qwen3-4b", "olmo-1b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_param_counts_equal_reference(arch, reduced):
    """``param_shapes`` builds on the meta device (nothing allocated, even
    for qwen3-4b's 4.4 B parameters) and counts what the reference
    counts."""
    jcfg = jbase.get_config(arch, reduced=reduced)
    tcfg = tbase.get_config(arch, reduced=reduced)
    shapes = tsteps.param_shapes(tcfg)
    assert all(leaf.device.type == "meta" for leaf in tree_leaves(shapes))
    jshapes = jsteps.param_shapes(jcfg)
    assert tsteps.n_params_of(shapes) == jsteps.n_params_of(jshapes)
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == \
        [tuple(j.shape) for j in jax.tree.leaves(jshapes)]
    n = tsteps.n_params_of(shapes)
    assert dataclasses.asdict(tsteps.pick_opt_config(tcfg, n)) == \
        dataclasses.asdict(jsteps.pick_opt_config(jcfg, n))
    if arch == "qwen2-0.5b" and not reduced:
        assert n == 494_032_768


def test_pick_opt_config_switches_to_bf16_moments():
    cfg = tbase.get_config("qwen2-0.5b")
    assert tsteps.pick_opt_config(cfg, 4e10).moment_dtype == "bfloat16"
    assert tsteps.pick_opt_config(cfg, 4e9).moment_dtype == "float32"


@pytest.mark.parametrize("microbatch", [0, 2])
def test_launcher_train_step_equals_reference(microbatch):
    jcfg = jbase.get_config("qwen2-0.5b", reduced=True)
    tcfg = tbase.get_config("qwen2-0.5b", reduced=True)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jopt = joptim.AdamConfig(lr=1e-3, eps=1e-3)
    topt = toptim.AdamConfig(lr=1e-3, eps=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, shard_logits=False,
                                           microbatch=microbatch))
    tstep = tsteps.make_train_step(tcfg, topt, microbatch=microbatch)
    js, ts = joptim.adam_init(jp, jopt), toptim.adam_init(tp, topt)
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
        jp, js, jl = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tl = tstep(tp, ts, {"tokens": torch.tensor(toks)})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-6)


def test_microbatch_equals_whole_batch():
    """Two accumulated halves give the whole batch's loss and update."""
    cfg = tbase.get_config("smollm-135m", reduced=True)
    opt = toptim.AdamConfig(lr=1e-3, eps=1e-3)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 8)))
    out = []
    for microbatch in (0, 2):
        p = T.init_params(cfg, 0, device="cpu")
        step = tsteps.make_train_step(cfg, opt, microbatch=microbatch)
        p, _, loss = step(p, toptim.adam_init(p, opt), {"tokens": toks})
        out.append((float(loss), [x.detach().clone()
                                  for x in tree_leaves(p)]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.make_train_step(cfg, opt, microbatch=3)(
            p, toptim.adam_init(p, opt), {"tokens": toks})


@pytest.mark.parametrize("microbatch", ["0", "2"])
def test_train_launcher_on_cpu_writes_a_reference_checkpoint(
        tmp_path, capsys, microbatch):
    """``launch/train.main`` trains, logs, and writes a checkpoint the JAX
    package's ``checkpoint/io.load`` reads back into its own tree.  As in
    the reference launcher, ``--microbatch`` is parsed and unused: every
    step is ``train_lib.make_train_step(remat=False)``, and the logged
    losses are that step's on the same parameters and data."""
    path = tmp_path / "ckpt.npz"
    params = ttrain_launch.main([
        "--device", "cpu", "--arch", "qwen2-0.5b", "--steps", "3",
        "--batch", "2", "--seq", "8", "--log-every", "1",
        "--microbatch", microbatch, "--ckpt", str(path)])
    out = capsys.readouterr().out
    assert "arch=qwen2-0.5b-reduced params~1,313,024 on cpu" in out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    tcfg = tbase.get_config("qwen2-0.5b", reduced=True)
    want_p = T.init_params(tcfg, 0, device="cpu")
    opt = toptim.AdamConfig(lr=3e-3, grad_clip=1.0)
    step = ttrain.make_train_step(tcfg, opt, remat=False)
    state = toptim.adam_init(want_p, opt)
    want = []
    for toks in lm_batches(tcfg.vocab, 2, 8, 3, seed=0):
        want_p, state, m = step(want_p, state,
                                {"tokens": torch.as_tensor(toks[:, :8])})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, atol=5e-5)
    like = JT.init_params(jbase.get_config("qwen2-0.5b", reduced=True),
                          jax.random.PRNGKey(1))
    loaded, meta = jio.load(str(path), like)
    assert meta["step"] == 3
    for t, j in zip(tree_leaves(params), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def test_train_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain_launch.main(["--steps", "1"])


def test_serve_launcher_on_cpu_answers_every_query(capsys):
    """``launch/serve.main`` trains a deployed LM, distils a parity LM and
    serves through ``deploy(..., engine="threads")`` with instance 0 late
    by 400 ms: every query is answered, and some are rebuilt from the
    parity output."""
    futs, stats = tserve.main([
        "--device", "cpu", "--n", "12", "--train-steps", "2",
        "--parity-steps", "2", "--seq", "8", "--straggle-ms", "400"])
    out = capsys.readouterr().out
    assert "deployed qwen2-0.5b-reduced: loss" in out
    assert "parity model: final distill MSE" in out
    assert len(futs) == 12 and all(f.done() for f in futs)
    assert sum(stats["completed_by"].values()) == 12
    assert stats["completed_by"].get("parity", 0) > 0
    assert "predictions reconstructed from parity outputs" in out
    for f in futs:
        assert np.all(np.isfinite(f.result(0)))
