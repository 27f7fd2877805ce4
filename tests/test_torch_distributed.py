"""The launch and distributed layer of the port (``distributed/``,
``launch/{mesh,steps,roofline,dryrun}.py``, ``GenerationSpec.mesh``)
against the JAX package, on the CPU.

Spec arithmetic is compared spec for spec: ``logical_spec`` against the
spec the reference's ``constrain`` hands ``jax.lax.with_sharding_constraint``
(captured as ``tests/test_distributed.py`` captures it), ``param_spec`` /
``cache_specs`` / ``batch_specs`` / ``logits_spec`` against the reference's
``PartitionSpec``s on the production mesh sizes (stand-in meshes: no device
is needed for the arithmetic), and the meta-tensor input and cache specs
against the reference's ``ShapeDtypeStruct``s.  The prefill, decode and
coded-serve steps run on reduced plans in fp32 with the reference's
parameters carried over by ``params_from_numpy`` (logit tolerance 2e-3, as
``tests/test_torch_lm.py``), and once more under launcher rules on a
one-rank mesh, where they must not change a bit.  The cross-process cases
(a 4-process gloo mesh, the dry run) are ``tests/test_torch_dryrun.py``.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.distributed import logical as jlogical
from repro.distributed import sharding as jsharding
from repro.launch import dryrun as jdryrun
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, tree_leaves
from repro_torch.distributed import logical as tlogical
from repro_torch.distributed.sharding import ShardingRules, \
    tree_map_with_path
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as T
from repro_torch.serving.api import BatchingPolicy, deploy_lm
from repro_torch.serving.generation import GenerationSpec

LOGITS = 2e-3
SIZES = {"pod": {"data": 16, "model": 16},
         "multipod": {"pod": 2, "data": 16, "model": 16},
         "serve8": {"data": 32, "model": 8}}
STEP_ARCHS = ["qwen2-0.5b", "deepseek-moe-16b", "mamba2-780m",
              "llama-3.2-vision-11b", "seamless-m4t-medium"]


def _spec(p):
    """A reference PartitionSpec, or a port's spec, as a tuple in
    PartitionSpec's canonical form (a one-axis tuple entry is the axis
    name; the two mean the same placement)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


# --------------------------------------------------------------------------
# logical rules
# --------------------------------------------------------------------------
# (shape, logical axes): the annotations the models make, at full-size
# shapes (B 256 x S 4096 train, 32 x 32768 prefill, 128 decode, B 1 long)
CASES = [
    ((256, 4096, 896), ("batch", None, None)),
    ((256, 4096, 14), ("batch", None, "heads")),
    ((32, 32768, 16, 128), ("batch", None, "heads", None)),
    ((256, 4096, 2, 7, 64), ("batch", None, "kv_heads", None, None)),
    ((128, 2, 7, 4096), ("batch", "kv_heads", None, None)),
    ((128, 32768, 2, 64), ("batch", "seq", "kv_heads", None)),
    ((1, 524288, 8, 128), ("batch", "seq", "kv_heads", None)),
    ((1048576, 2048), ("tokens", None)),
    ((64, 40960, 2048), ("experts", "capacity", None)),
    ((256, 4096, 151936), ("batch", None, "vocab")),
    ((32, 128, 64, 256, 256), ("batch", None, "heads", None, None)),
    ((6, 48, 64, 64), ("batch", "heads", None, None)),
]


def _ref_spec(shape, axes, rules, sizes, monkeypatch):
    captured = {}

    def fake_wsc(x, spec):
        captured["spec"] = spec
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", fake_wsc)
    with jlogical.logical_rules(rules, sizes):
        jlogical.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), axes)
    return _spec(captured["spec"])


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_logical_spec_equals_reference(case, mesh, monkeypatch):
    shape, axes = CASES[case]
    sizes = SIZES[mesh]
    rules = dict(jlogical.DEFAULT_LOGICAL)
    if "pod" in sizes:
        rules["batch"] = rules["tokens"] = ("pod", "data")
    assert dict(tlogical.DEFAULT_LOGICAL) == dict(jlogical.DEFAULT_LOGICAL)
    want = _ref_spec(shape, axes, rules, sizes, monkeypatch)
    assert tlogical.logical_spec(shape, axes, rules, sizes) == want
    with tlogical.logical_rules(rules, sizes):
        assert tlogical.logical_spec(shape, axes) == want
    flat = [a for e in want if e for a in ((e,) if isinstance(e, str)
                                            else e)]
    assert len(flat) == len(set(flat))       # no mesh axis used twice


def test_logical_axis_reuse_guard_as_reference(monkeypatch):
    rules, sizes = {"batch": ("data",), "seq": ("data",)}, {"data": 16}
    want = _ref_spec((16, 32), ("batch", "seq"), rules, sizes, monkeypatch)
    assert tlogical.logical_spec((16, 32), ("batch", "seq"), rules,
                                 sizes) == want == ("data", None)


def test_rules_for_mesh_as_reference():
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
        tmesh = SimpleNamespace(mesh_dim_names=axes, shape=shape)
        assert tlogical.rules_for_mesh(tmesh) == \
            jlogical.rules_for_mesh(jmesh)


def test_constrain_is_identity_without_rules_and_on_plain_tensors():
    tlogical.clear_rules()
    x = torch.ones((4, 8))
    assert tlogical.constrain(x, ("batch", None)) is x
    with tlogical.logical_rules(dict(tlogical.DEFAULT_LOGICAL),
                                {"data": 2, "model": 2}):
        assert tlogical.constrain(x, ("batch", None)) is x
        assert tlogical.constrain_spec(x, ("data", None)) is x
    assert tlogical.state() == (None, None, None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tlogical.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tlogical.placements((None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    assert tlogical.placements((), mesh) == (Replicate(),) * 3


# --------------------------------------------------------------------------
# ShardingRules
# --------------------------------------------------------------------------
@pytest.fixture
def ref_named(monkeypatch):
    """The reference's NamedSharding as a holder of its spec: the stand-in
    mesh has no devices to build one over."""
    monkeypatch.setattr(jsharding, "NamedSharding",
                        lambda mesh, spec: SimpleNamespace(spec=spec))


def _rules(mesh, fsdp_params):
    shape = tuple(SIZES[mesh].values())
    axes = tuple(SIZES[mesh])
    jr = jsharding.ShardingRules(
        SimpleNamespace(axis_names=axes, devices=np.empty(shape)),
        fsdp_params=fsdp_params)
    tr = ShardingRules(SimpleNamespace(mesh_dim_names=axes, shape=shape),
                       fsdp_params=fsdp_params)
    return jr, tr


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    return (jsteps.param_shapes(jbase.get_config(arch)),
            tsteps.param_shapes(tbase.get_config(arch)))


def _ref_specs(tree, fn):
    from jax.tree_util import tree_flatten_with_path
    leaves, _ = tree_flatten_with_path(tree)
    return {jsharding._path_str(path): _spec(fn(path, leaf))
            for path, leaf in leaves}


def _port_specs(shapes, specs):
    """{path: spec} of a spec tree over the tree ``shapes`` (a spec, a
    tuple, is a leaf there)."""
    out = {}

    def walk(path, leaf):
        spec = specs
        for key in path.split("/"):
            spec = spec[key if isinstance(spec, dict) else int(key)]
        out[path] = _spec(spec)
    tree_map_with_path(walk, shapes)
    return out


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_spec_equals_reference(arch, mesh, fsdp):
    jr, tr = _rules(mesh, fsdp)
    jshapes, tshapes = _param_shapes(arch)
    want = _ref_specs(jshapes, jr.param_spec)
    got = _port_specs(tshapes, tr.params(tshapes))
    assert got == want
    assert all(leaf.device.type == "meta" for leaf in tree_leaves(tshapes))
    opt = tr.opt_state(None, tr.params(tshapes))
    assert opt["mu"] is opt["nu"] and opt["step"] == ()


def _decode_pairs():
    return [(a, s) for a in tbase.ARCH_IDS for s, sh in tbase.SHAPES.items()
            if sh.kind == "decode"]


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("pair", _decode_pairs(), ids=lambda p: "-".join(p))
def test_cache_specs_equal_reference(pair, mesh, ref_named):
    arch, shape = pair
    jr, tr = _rules(mesh, True)
    jcfg, _ = jdryrun.adapt_config(arch, shape)
    tcfg, _ = tdryrun.adapt_config(arch, shape)
    jcache = jsteps.cache_shapes(jcfg, shape)
    tcache = tsteps.cache_shapes(tcfg, shape)
    want = {}
    from jax.tree_util import tree_flatten_with_path
    for path, leaf in tree_flatten_with_path(jr.cache_specs(jcache))[0]:
        want[jsharding._path_str(path)] = _spec(leaf.spec)
    assert _port_specs(tcache, tr.cache_specs(tcache)) == want


@pytest.mark.parametrize("mesh", ["pod", "multipod", "serve8"])
def test_batch_and_logits_specs_equal_reference(mesh, ref_named):
    jr, tr = _rules(mesh, True)
    for arch in tbase.ARCH_IDS:
        for shape, sh in tbase.SHAPES.items():
            jcfg, _ = jdryrun.adapt_config(arch, shape)
            tcfg, _ = tdryrun.adapt_config(arch, shape)
            want = {k: _spec(v.spec) for k, v in jr.batch_specs(
                jsteps.input_specs(jcfg, shape)).items()}
            got = tr.batch_specs(tsteps.input_specs(tcfg, shape))
            assert {k: _spec(v) for k, v in got.items()} == want
            assert _spec(tr.logits_spec(sh.global_batch, tcfg.vocab)) == \
                _spec(jr.logits_spec(sh.global_batch, jcfg.vocab).spec)
            assert _spec(tr.activations(sh.global_batch)) == _spec(
                jr.activations(sh.global_batch).spec)
    for axes in (("data",), ("pod", "data")):
        assert _spec(tsteps.logits_pspec(axes)) == _spec(
            jsteps.logits_pspec(axes))


# --------------------------------------------------------------------------
# input specs and cache shapes
# --------------------------------------------------------------------------
def _leaves_meta(tree):
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in tree_leaves(tree)]


def _leaves_ref(tree):
    return [(tuple(x.shape), str(np.dtype(x.dtype)))
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_input_specs_and_cache_shapes_equal_reference(arch):
    for shape, sh in tbase.SHAPES.items():
        jcfg, jnotes = jdryrun.adapt_config(arch, shape)
        tcfg, tnotes = tdryrun.adapt_config(arch, shape)
        assert tnotes[1:] == jnotes
        jb, tb = jsteps.input_specs(jcfg, shape), tsteps.input_specs(tcfg,
                                                                      shape)
        assert sorted(tb) == sorted(jb)
        assert _leaves_meta(tb) == _leaves_ref(jb)
        assert all(x.device.type == "meta" for x in tree_leaves(tb))
        jc = jsteps.coded_input_specs(jcfg, shape, k=3)
        assert _leaves_meta(tsteps.coded_input_specs(tcfg, shape, k=3)) == \
            _leaves_ref(jc)
        if sh.kind == "decode":
            tc = tsteps.cache_shapes(tcfg, shape)
            assert _leaves_meta(tc) == _leaves_ref(
                jsteps.cache_shapes(jcfg, shape))
            assert all(x.device.type == "meta" for x in tree_leaves(tc))


# --------------------------------------------------------------------------
# the prefill, decode and coded-serve steps
# --------------------------------------------------------------------------
def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jax cfg, torch cfg, jax params, torch params, numpy params) of the
    reduced plan, every leaf perturbed (zero biases and unit scales would
    hide a wiring fault)."""
    jcfg = jbase.get_config(arch, reduced=True)
    tcfg = tbase.get_config(arch, reduced=True)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (_np(a) + 0.01 * rng.standard_normal(
        a.shape)).astype(np.float32), JT.init_params(jcfg,
                                                      jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"), tree)


def _batch(cfg, seed, B=2, S=12):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["cross_embeds"] = 0.5 * rng.standard_normal(
            (B, cfg.n_modality_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = 0.5 * rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_decode_steps_equal_reference(arch, backend):
    jcfg, tcfg, jp, tp, _ = _model(arch)
    tcfg = tcfg.replace(attn_backend=backend)
    batch = _batch(jcfg, 1)
    jlog, jcache = jsteps.make_prefill_step(jcfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlog, tcache = tsteps.make_prefill_step(tcfg)(tp, _torch_batch(batch))
    _close(tlog, jlog, LOGITS)
    for got, want in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        _close(got, want, LOGITS)

    # one decode step at the prompt's length, from a cache prefilled with
    # room for it
    S = batch["tokens"].shape[1]
    ctx = {"cross_embeds": batch["frames"]} if jcfg.enc_dec else \
        {"cross_embeds": batch["cross_embeds"]} if jcfg.family == "vlm" \
        else {}
    _, jcache = JT.prefill(jcfg, jp, tokens=jnp.asarray(batch["tokens"]),
                           cache_len=S + 4, **{
                               k: jnp.asarray(v) for k, v in ctx.items()})
    tok = np.array([[3], [7]], np.int32)
    jlog, _ = jsteps.make_decode_step(jcfg, S)(
        jp, jcache, {"token": jnp.asarray(tok)})
    with torch.no_grad():
        _, tcache = T.prefill(tcfg, tp, tokens=torch.tensor(batch["tokens"]),
                              cache_len=S + 4, **{
                                  k: torch.tensor(v) for k, v in ctx.items()})
        tlog, _ = tsteps.make_decode_step(tcfg, S)(
            tp, tcache, {"token": torch.tensor(tok)})
    _close(tlog, jlog, LOGITS)


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_coded_serve_step_equals_reference(arch, k, optimized):
    jcfg, tcfg, jp, tp, _ = _model(arch)
    rng = np.random.default_rng(k)
    toks = rng.integers(0, jcfg.vocab, (k, 2, 10)).astype(np.int32)
    jstep = jsteps.make_coded_serve_step(jcfg, k=k, optimized=optimized)
    tstep = tsteps.make_coded_serve_step(tcfg, k=k, optimized=optimized)
    if jcfg.family == "vlm" or jcfg.enc_dec:
        # the step takes no context: both packages refuse the plan
        with pytest.raises(Exception):
            jstep(jp, {"tokens": jnp.asarray(toks)})
        with pytest.raises(ValueError, match="cross_embeds"):
            tstep(tp, {"tokens": torch.tensor(toks)})
        return
    jlog, _ = jstep(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlog, extra = tstep(tp, {"tokens": torch.tensor(toks)})
    assert tuple(tlog.shape) == (2, 1, tcfg.vocab) and extra == {}
    _close(tlog, jlog, LOGITS)


# --------------------------------------------------------------------------
# one-rank mesh: the launch steps and deploy_lm under launcher rules
# --------------------------------------------------------------------------
@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (1, 1) ("data", "model") mesh over a one-rank gloo group, torn
    down after the test (the card's is NCCL: ``launch.mesh.card_world``)."""
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_test_mesh((1, 1))
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_steps_are_bit_equal(one_rank_mesh):
    mesh = one_rank_mesh
    _, tcfg, _, tp, _ = _model("qwen2-0.5b")
    rules = ShardingRules(mesh, fsdp_params=False)
    placed = rules.distribute(tp, rules.params(tp))
    assert all(a is b for a, b in zip(tree_leaves(placed), tree_leaves(tp)))
    batch = _torch_batch(_batch(tcfg, 2))
    lrules, sizes = tlogical.rules_for_mesh(mesh)
    with torch.no_grad():
        plain = tsteps.make_prefill_step(tcfg)(tp, batch)
        with tlogical.logical_rules(lrules, sizes, mesh):
            ruled = tsteps.make_prefill_step(tcfg)(placed, batch)
            coded = [tsteps.make_coded_serve_step(tcfg, 2, opt)(
                placed, {"tokens": torch.stack([batch["tokens"]] * 2)})[0]
                for opt in (False, True)]
    for a, b in zip(tree_leaves(ruled), tree_leaves(plain)):
        assert torch.equal(a, b)
    _close(coded[1], coded[0], LOGITS)


def test_deploy_lm_on_a_one_rank_mesh_serves_the_same_tokens(one_rank_mesh):
    _, tcfg, _, tp, _ = _model("qwen2-0.5b")
    prompts = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12], [13, 14]]

    def serve(mesh):
        spec = GenerationSpec(cfg=tcfg, params=tp, k=2, r=1,
                              batching=BatchingPolicy(max_size=2),
                              max_seq_len=16, max_new_tokens=4,
                              straggle_ms=10_000.0, mesh=mesh, device="cpu")
        with deploy_lm(spec) as sess:
            futs = [sess.submit(p) for p in prompts]
            assert sess.wait_all(timeout=60.0)
            return [f.result() for f in futs]
    assert serve(one_rank_mesh) == serve(None)


def test_generation_spec_refuses_a_sharded_mesh():
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    with fake_world(4):
        mesh = make_test_mesh((2, 2))
        with pytest.raises(ValueError, match="B.4"):
            GenerationSpec(mesh=mesh, device="cpu")


def _op_calls(x, kv):
    """Each op of ``kernels/ops.py`` with ``x`` (a [1, 2, 16] tensor or a
    DTensor of one) as its first tensor argument; ``kv`` [1, 8, 1, 16]."""
    return {
        "parity_encode_op": lambda: ops.parity_encode_op(x, [1.0]),
        "parity_decode_op": lambda: ops.parity_decode_op(
            x[0], kv[:, :2, 0], 0),
        "fused_encode_forward_op": lambda: ops.fused_encode_forward_op(
            x, [[1.0]], kv[0, :, 0].T[None]),
        "multigroup_decode_op": lambda: ops.multigroup_decode_op(
            x, kv[:, :2, 0].reshape(1, 1, 2, 16), [0], [1.0]),
        "berrut_encode_op": lambda: ops.berrut_encode_op(x, [[1.0]]),
        "learned_project_op": lambda: ops.learned_project_op(
            x, [[1.0]]),
        "flash_attention_op": lambda: ops.flash_attention_op(
            x.reshape(1, 2, 1, 16), kv, kv),
        "decode_attention_op": lambda: ops.decode_attention_op(
            x, kv, kv, 3),
    }


@pytest.mark.parametrize("name", sorted(_op_calls(None, None)))
def test_every_op_refuses_a_dtensor(name, one_rank_mesh):
    """A kernel op handed a DTensor raises (no local shard, no plain
    fallback), even on a mesh of one device; the plain tensor runs."""
    from torch.distributed.tensor import DTensor, Replicate
    assert {n for n in dir(ops) if n.endswith("_op")} == set(
        _op_calls(None, None))
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 2, 16), generator=g)
    kv = torch.randn((1, 8, 1, 16), generator=g)
    dx = DTensor.from_local(x, one_rank_mesh, [Replicate(), Replicate()])
    with torch.no_grad():
        assert torch.isfinite(_op_calls(x, kv)[name]()).all()
        with pytest.raises(RuntimeError, match=f"{name} takes no DTensor"):
            _op_calls(dx, kv)[name]()


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------
def test_collective_bytes_equals_reference_parser():
    hlo = """
      %ag = bf16[16,128]{1,0} all-gather(bf16[2,128]{1,0} %x), dims={0}
      %ar.1 = f32[1024]{0} all-reduce(f32[1024]{0} %y), to_apply=%sum
      %a2a = (bf16[4,8]{1,0}, bf16[4,8]{1,0}) all-to-all(%p, %q)
      %cp = u32[2]{0} collective-permute(u32[2]{0} %z)
      %rs = f32[8,4]{1,0} reduce-scatter(f32[64,4]{1,0} %w), dimensions={0}
      %not_a_collective = f32[999999]{0} add(f32[1]{0} %a, f32[1]{0} %b)
    """
    C = troof.Collective
    records = [C("all-gather", [((16, 128), torch.bfloat16)]),
               C("all-reduce", [((1024,), torch.float32)]),
               C("all-to-all", [((4, 8), torch.bfloat16)] * 2),
               C("collective-permute", [((2,), torch.uint32)]),
               C("reduce-scatter", [((8, 4), torch.float32)])]
    assert troof.collective_bytes(records) == jroof.collective_bytes(hlo)


def test_roofline_terms_follow_reference_arithmetic():
    hw = troof.H100_SXM
    r = troof.Roofline(hw.peak_flops, hw.hbm_bw * 2, hw.link_bw * 0.5, {},
                       {}, 256)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert abs(r.collective_s - 0.5) < 1e-9
    assert r.dominant == "memory"
    j = jroof.Roofline(jroof.PEAK_FLOPS, jroof.HBM_BW * 2, 0.0, {}, {}, 256)
    tj = troof.Roofline(j.flops_per_device, j.bytes_per_device, 0.0, {}, {},
                        256, troof.Hardware(jroof.PEAK_FLOPS, jroof.HBM_BW,
                                            jroof.LINK_BW))
    d, e = tj.as_dict(), j.as_dict()
    assert {k: d[k] for k in e} == e and d["hardware"]["link_bw"] == \
        jroof.LINK_BW


def test_analyze_of_one_matmul():
    m, k, n = 32, 48, 40
    a, b = torch.ones((m, k)), torch.ones((k, n), dtype=torch.float32)
    with troof.Trace() as trace:
        (a @ b)
    roof = troof.analyze(trace, 1)
    assert roof.flops_per_device == 2 * m * n * k
    assert roof.bytes_per_device == (m * k + k * n + m * n) * 4
    assert roof.coll_bytes_per_device == 0 and trace.ops == 1
