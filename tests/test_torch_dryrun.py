"""The port's launch layer across processes, on the CPU: a (2, 2)
("data", "model") mesh over four gloo processes, and the dry run.

* A sharded forward and one sharded ``launch.steps.make_train_step``
  (``shard_logits=True``) on reduced qwen2-0.5b and deepseek-moe-16b, placed
  by ``ShardingRules``, against the unsharded port in the same processes:
  logits atol 2e-5, loss rtol 1e-5, updated parameters atol 1e-6, fp32.
  deepseek's MoE layers take the expert-parallel path there (the model axis
  divides its four experts), whose router loss is, as in the reference, the
  mean of each data shard's own loss; the unsharded step it is held to
  computes that mean from the shards' halves of the batch (the global
  path's router loss over the whole batch is another number).
* ``models.moe._moe_fwd_ep`` against the reference's ``_moe_fwd_ep`` (output
  and aux, atol 1e-5), with ``fsdp_params`` True and False; the reference
  runs in a subprocess over four forced host devices and hands its result
  back in an ``.npz``.
* ``python -m repro_torch.launch.dryrun --mesh test`` for the reference's
  two pairs (``tests/test_distributed.py``).

Each process group meets at a ``FileStore`` under the test's ``tmp_path``
(no port: several test workers run at once).  This module imports no JAX:
the spawned workers import it.
"""
import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import traceback

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
FWD_TOL, LOSS_RTOL, PARAM_TOL, EP_TOL = 2e-5, 1e-5, 1e-6, 1e-5


# --------------------------------------------------------------------------
# four gloo processes
# --------------------------------------------------------------------------
def _worker(name, rank, root, args):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    try:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(root, "store"), WORLD), rank=rank,
            world_size=WORLD)
        try:
            out = globals()[name](make_test_mesh((2, 2)), *args)
            if rank == 0:
                np.savez(os.path.join(root, "out.npz"), **out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _run(name, tmp_path, *args):
    """``name(mesh, *args)`` on every rank; rank 0's dict of arrays."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(name, r, str(tmp_path), args))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    errors = [(tmp_path / f"error{r}.txt") for r in range(WORLD)]
    for p in procs:
        if p.is_alive():
            p.kill()
    msgs = [e.read_text() for e in errors if e.exists()]
    assert not msgs and all(p.exitcode == 0 for p in procs), \
        "\n".join(msgs) or [p.exitcode for p in procs]
    return dict(np.load(tmp_path / "out.npz"))


def _clone(tree):
    from repro_torch.convert import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def _full(x):
    from torch.distributed.tensor import DTensor
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().float().numpy()


def _sharded_model(mesh, arch):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.distributed.logical import logical_rules, rules_for_mesh
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.training.loss import lm_loss
    from repro_torch.training.optim import AdamConfig, adam_init, adam_update
    from repro_torch.training.train_lib import grad_cfg, value_and_grad

    cfg = get_config(arch, reduced=True).replace(attn_backend="torch")
    params = T.init_params(cfg, 0, device="cpu")
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 16)), dtype=torch.int32)
    opt_cfg = AdamConfig(lr=1e-3, eps=1e-3)

    with torch.no_grad():
        logits, _ = T.forward(cfg, params, tokens=toks)
    plain = _clone(params)
    rules = ShardingRules(mesh)
    if cfg.n_experts:
        fcfg = grad_cfg(cfg)
        shards = toks.chunk(rules.axis_sizes["data"])

        def loss_fn(p, batch):
            logits, _ = T.forward(fcfg, p, tokens=toks, remat=True)
            aux = torch.stack([T.forward(fcfg, p, tokens=t)[1]
                               for t in shards]).mean()
            return lm_loss(logits, toks, aux, cfg.router_aux_coef)
        loss, grads = value_and_grad(loss_fn, plain, {"tokens": toks})
        plain, _ = adam_update(grads, adam_init(plain, opt_cfg), plain,
                               opt_cfg)
    else:
        step = ST.make_train_step(cfg, opt_cfg, shard_logits=False)
        plain, _, loss = step(plain, adam_init(plain, opt_cfg),
                              {"tokens": toks})
    specs = rules.params(params)
    sharded = rules.distribute(_clone(params), specs)
    opt = rules.distribute(adam_init(params, opt_cfg),
                           rules.opt_state(None, specs))
    batch = rules.distribute({"tokens": toks},
                             rules.batch_specs({"tokens": toks}))
    lrules, sizes = rules_for_mesh(mesh)
    with logical_rules(lrules, sizes, mesh), implicit_replication():
        with torch.no_grad():
            slogits, _ = T.forward(cfg, sharded, tokens=batch["tokens"])
        sstep = ST.make_train_step(cfg, opt_cfg, shard_logits=True,
                                   batch_axes=rules.batch_axes)
        sharded, _, sloss = sstep(sharded, opt, batch)
    out = {"logits": _full(logits), "sharded_logits": _full(slogits),
           "loss": _full(loss), "sharded_loss": _full(sloss),
           "sharded_leaves": np.array(sum(
               type(x).__name__ == "DTensor" for x in tree_leaves(sharded)))}
    for i, (a, b) in enumerate(zip(tree_leaves(plain),
                                   tree_leaves(sharded))):
        out[f"p{i}"], out[f"s{i}"] = _full(a), _full(b)
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b"])
def test_sharded_forward_and_train_step_equal_unsharded(arch, tmp_path):
    out = _run("_sharded_model", tmp_path, arch)
    n = len([k for k in out if k.startswith("p")])
    assert int(out["sharded_leaves"]) == n > 0
    np.testing.assert_allclose(out["sharded_logits"], out["logits"],
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(out["sharded_loss"], out["loss"],
                               rtol=LOSS_RTOL)
    for i in range(n):
        np.testing.assert_allclose(out[f"s{i}"], out[f"p{i}"],
                                   atol=PARAM_TOL, rtol=0)


# --------------------------------------------------------------------------
# the expert-parallel MoE against the reference's
# --------------------------------------------------------------------------
_JAX_EP = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.distributed.logical import rules_for_mesh
    from repro.launch.mesh import make_test_mesh
    from repro.models.moe import _moe_fwd_ep
    root, fsdp = sys.argv[1], sys.argv[2] == "1"
    data = np.load(root + "/in.npz")
    cfg = get_config("deepseek-moe-16b", reduced=True)
    p = {k: jnp.asarray(data[k]) for k in ("router", "w1", "w3", "w2")}
    p["shared"] = {k: jnp.asarray(data["shared_" + k])
                   for k in ("w1", "w3", "w2")}
    mesh = make_test_mesh((2, 2), ("data", "model"))
    rules, sizes = rules_for_mesh(mesh)
    rules["fsdp_params"] = fsdp
    with mesh:
        out, aux = _moe_fwd_ep(cfg, p, jnp.asarray(data["x"]), rules, sizes,
                               mesh)
    np.savez(root + "/ref.npz", out=np.asarray(out), aux=np.asarray(aux))
""")


def _moe_ep(mesh, root, fsdp):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.logical import rules_for_mesh
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import moe
    data = np.load(os.path.join(root, "in.npz"))
    cfg = get_config("deepseek-moe-16b", reduced=True)
    p = {k: torch.tensor(data[k]) for k in ("router", "w1", "w3", "w2")}
    p["shared"] = {k: torch.tensor(data["shared_" + k])
                   for k in ("w1", "w3", "w2")}
    rules = ShardingRules(mesh, fsdp_params=fsdp)
    placed = rules.distribute({"moe": p}, rules.params({"moe": p}))["moe"]
    x = torch.tensor(data["x"])
    x = rules.distribute(x, rules.batch_specs({"x": x})["x"])
    lrules, sizes = rules_for_mesh(mesh)
    lrules["fsdp_params"] = fsdp
    with implicit_replication(), torch.no_grad():
        out, aux = moe._moe_fwd_ep(cfg, placed, x, lrules, sizes, mesh)
    return {"out": _full(out), "aux": _full(aux)}


@pytest.mark.parametrize("fsdp", [True, False])
def test_moe_fwd_ep_equals_reference(fsdp, tmp_path):
    from repro_torch.configs.base import get_config
    cfg = get_config("deepseek-moe-16b", reduced=True)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    SF = cfg.n_shared_experts * F
    rng = np.random.default_rng(7)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    np.savez(tmp_path / "in.npz", router=w(D, E), w1=w(E, D, F),
             w3=w(E, D, F), w2=w(E, F, D), shared_w1=w(D, SF),
             shared_w3=w(D, SF), shared_w2=w(SF, D),
             x=rng.standard_normal((4, 16, D)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run([sys.executable, "-c", _JAX_EP, str(tmp_path),
                          "1" if fsdp else "0"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = np.load(tmp_path / "ref.npz")
    got = _run("_moe_ep", tmp_path, str(tmp_path), fsdp)
    np.testing.assert_allclose(got["out"], want["out"], atol=EP_TOL, rtol=0)
    np.testing.assert_allclose(got["aux"], want["aux"], atol=EP_TOL, rtol=0)


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"),
    ("mamba2-780m", "decode_32k"),
])
def test_dryrun_small_mesh(arch, shape, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "test", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with open(tmp_path / f"{arch}__{shape}__test.json") as f:
        res = json.load(f)
    assert res["chips"] == 4 and res["roofline"]["flops_per_device"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert res["roofline"]["hardware"]["name"].startswith("NVIDIA H100")
    mem = res["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] > 0
    assert res["roofline"]["coll_bytes_per_device"] > 0
