"""The port's cross attention and encoder-decoder path (``models/layers.py``
``cross_attention_fwd``, ``models/transformer.py`` with ``run_encoder`` and
the VLM and encoder-decoder layer plans, the train step and launcher that
carry their context) against the JAX package, on the CPU.

Reduced llama-3.2-vision-11b (a self-attention layer and a cross-attention
layer per period, 16 stub patch embeddings) and seamless-m4t-medium (two
bidirectional encoder layers, two decoder layers that cross-attend to the
encoder's output over 16 stub frames), fp32.  The same seeded numpy inputs
and parameters go through both packages; parameters are carried across with
``params_from_numpy``.  Each model case runs on both of the port's backends
("kernels": B7 / B8's plain versions on the CPU; "torch"); cross attention
and the encoder take the block scan on both, as in the reference.
Tolerances: logits 2e-3 (``LOGITS`` of ``test_torch_lm.py``), caches,
attention outputs and the encoder's output 2e-5, losses 1e-5 relative and
parameters after one Adam step at eps 1e-3 1e-6 (as
``test_torch_train.py`` explains); exact for shapes, dtypes and counts.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.training import optim as joptim
from repro.training import train_lib as jtrain
from repro_torch.checkpoint import io as tio
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, params_to_numpy, \
    tree_leaves, tree_map
from repro_torch.data.pipeline import lm_batches
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain_launch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import optim as toptim
from repro_torch.training import train_lib as ttrain

LOGITS = 2e-3
TOL = 2e-5
LR, EPS, PARAM_TOL = 1e-3, 1e-3, 1e-6
ARCHS = ["llama-3.2-vision-11b", "seamless-m4t-medium"]
BACKENDS = ["kernels", "torch"]
# full width: jax.eval_shape of the reference's init_params, and its
# roofline estimate, which counts no encoder and no cross layer beyond the
# self-attention count
FULL_PARAMS = {"llama-3.2-vision-11b": 9_775_190_016,
               "seamless-m4t-medium": 877_107_200}
FULL_ESTIMATE = {"llama-3.2-vision-11b": 9_774_825_472,
                 "seamless-m4t-medium": 726_036_480}


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol, rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else _np(got)
    np.testing.assert_allclose(got, _np(want), atol=atol, rtol=rtol)


def _cfgs(arch, **kw):
    return jbase.get_config(arch, reduced=True).replace(**kw), \
        tbase.get_config(arch, reduced=True).replace(**kw)


def _noisy(tree, seed, scale=0.01):
    """A JAX tree with every leaf perturbed (zero biases and unit scales
    would hide a wiring fault): (jax tree, torch tree)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (_np(a) + scale * rng.standard_normal(
        a.shape)).astype(np.float32), tree)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def models():
    """Per arch: (jax cfg, torch cfg, jax params, torch params), built
    once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jp, tp = _noisy(JT.init_params(jcfg, jax.random.PRNGKey(0)), 0)
        out[arch] = (jcfg, tcfg, jp, tp)
    return out


_REF = {}


def _ref(key, fn):
    """The reference's result for ``key``, computed once for the module
    (both backends of the port are held against it)."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


def _jit_decode(jcfg):
    """The reference's ``decode_step`` compiled once for every position."""
    return _ref(("jit decode", jcfg.name), lambda: jax.jit(
        lambda p, c, pos, tok: JT.decode_step(jcfg, p, c, pos, token=tok)))


def _inputs(cfg, seed, B=2, S=12, n_ctx=None):
    """Tokens [B, S] and the context [B, n_ctx, D] (n_modality_tokens by
    default), numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ctx = 0.5 * rng.standard_normal(
        (B, n_ctx or cfg.n_modality_tokens, cfg.d_model))
    return toks, ctx.astype(np.float32)


def _dtypes(tree):
    return [str(t.dtype).removeprefix("torch.") for t in tree_leaves(tree)]


# --------------------------------------------------------------------------
# plans, trees, full-width shapes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("role", ["decoder", "encoder"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_plan_equals_reference(arch, role):
    for reduced in (False, True):
        assert T.layer_plan(tbase.get_config(arch, reduced), role) == \
            JT.layer_plan(jbase.get_config(arch, reduced), role)
    plan = T.layer_plan(tbase.get_config(arch), role)
    if role == "encoder":
        assert all(not s["causal"] and not s["cross"] for s in plan)
    elif arch == "llama-3.2-vision-11b":
        assert [s["mixer"] for s in plan] == ["attn"] * 4 + ["none"]
        assert [s["cross"] for s in plan] == [False] * 4 + [True]
    else:
        assert plan == ({"mixer": "attn", "cross": True, "ffn": "mlp",
                         "causal": True},)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_trees_equal_reference(arch):
    """Shapes and dtypes (bf16) of the parameter tree, the encoder subtree
    included, and of ``init_cache``, whose cross entries hold
    n_modality_tokens rows and are all a VLM cross layer holds."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp = jsteps.param_shapes(jcfg)
    tp = T.init_params(tcfg, 0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: a.shape, jp)
    assert _dtypes(tp) == [str(j.dtype) for j in jax.tree.leaves(jp)]
    assert T.param_count(tp) == jsteps.n_params_of(jp)
    assert ("encoder" in tp) == (arch == "seamless-m4t-medium")
    if "encoder" in tp:
        assert set(tp["encoder"]) == {"blocks", "final_norm"}
        assert tp["encoder"]["blocks"][0]["attn"]["wq"].shape[0] == \
            tcfg.n_enc_layers // tcfg.period
    cross = [layer["cross"] for layer in tp["blocks"] if "cross" in layer]
    assert cross and all("cross_norm" in c for c in cross)
    cache = T.init_cache(tcfg, 3, 20, device="cpu")
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 3, 20))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix(
        "torch.")), cache) == jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                           jcache)
    for spec, layer in zip(T.layer_plan(tcfg), cache):
        if spec["cross"]:
            assert layer["cross"]["k"].shape[2] == tcfg.n_modality_tokens
        if spec["mixer"] == "none":
            assert set(layer) == {"cross"}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_counts(arch):
    """The full-size trees on the meta device against the reference's
    ``jax.eval_shape``, leaf by leaf, and the exact counts; the roofline's
    estimate stays the reference's, which leaves out the encoder and the
    cross layers' own weights."""
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    shapes = tsteps.param_shapes(tcfg)
    assert all(leaf.device.type == "meta" for leaf in tree_leaves(shapes))
    jshapes = jsteps.param_shapes(jcfg)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_leaves(shapes)] == \
        [(tuple(j.shape), str(j.dtype)) for j in jax.tree.leaves(jshapes)]
    assert tsteps.n_params_of(shapes) == jsteps.n_params_of(jshapes) == \
        FULL_PARAMS[arch]
    assert troof.estimate_param_count(tcfg) == FULL_ESTIMATE[arch]


# --------------------------------------------------------------------------
# cross attention and the encoder
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flavour", [{}, {"qkv_bias": True,
                                          "qk_norm": True}])
@pytest.mark.parametrize("from_cache", [False, True])
def test_cross_attention_fwd_matches_reference(from_cache, flavour):
    """From the embeddings (q, k, v through ``_qkv``, no RoPE) and from
    cached K/V (q only, with the bias and ``q_norm``): output and (k, v)."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-11b", **flavour)
    jp, tp = _noisy(JL.init_attention(jcfg, jax.random.PRNGKey(3),
                                      cross=True), 3, scale=0.05)
    assert set(tp) == set(jp) and "cross_norm" in tp
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    if from_cache:
        _, (k, v) = JL.cross_attention_fwd(jcfg, jp, jnp.asarray(x),
                                           jnp.asarray(ctx))
        jarg, targ = (k, v), (torch.tensor(_np(k)), torch.tensor(_np(v)))
    else:
        jarg, targ = jnp.asarray(ctx), torch.tensor(ctx)
    jo, (jk, jv) = JL.cross_attention_fwd(jcfg, jp, jnp.asarray(x), jarg,
                                          from_cache=from_cache)
    to, (tk, tv) = L.cross_attention_fwd(tcfg, tp, torch.tensor(x), targ,
                                         from_cache=from_cache)
    for got, want in ((to, jo), (tk, jk), (tv, jv)):
        _close(got, want, TOL, TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_encoder_matches_reference(models, backend):
    jcfg, tcfg, jp, tp = models["seamless-m4t-medium"]
    _, frames = _inputs(jcfg, 5, n_ctx=11)
    want = _ref("encoder", lambda: JT.run_encoder(jcfg, jp,
                                                  jnp.asarray(frames)))
    got = T.run_encoder(tcfg.replace(attn_backend=backend), tp,
                        torch.tensor(frames))
    assert got.shape == (2, 11, tcfg.d_model)
    _close(got, want, TOL, TOL)


# --------------------------------------------------------------------------
# forward / prefill / decode against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch, backend):
    jcfg, tcfg, jp, tp = models[arch]
    toks, ctx = _inputs(jcfg, 1)
    want, jaux = _ref(("forward", arch), lambda: JT.forward(
        jcfg, jp, tokens=jnp.asarray(toks), cross_embeds=jnp.asarray(ctx)))
    got, aux = T.forward(tcfg.replace(attn_backend=backend), tp,
                         tokens=torch.tensor(toks),
                         cross_embeds=torch.tensor(ctx))
    _close(got, want, LOGITS)
    assert float(aux) == float(jaux) == 0.0
    last, _ = T.forward(tcfg.replace(attn_backend=backend), tp,
                        tokens=torch.tensor(toks),
                        cross_embeds=torch.tensor(ctx),
                        unembed_last_only=True)
    _close(last[:, 0], want[:, -1], LOGITS)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(models, arch, backend):
    """``prefill`` logits and every cache entry (the cross K/V included),
    then four ``decode_step``s with a scalar pos and, on a copy of the
    cache, with a [B] pos: logits and caches after each step against the
    reference's, and the cross caches as prefill left them."""
    jcfg, tcfg, jp, tp = models[arch]
    tcfg = tcfg.replace(attn_backend=backend)
    toks, ctx = _inputs(jcfg, 2)
    P, S = 8, 16

    def reference():
        last, cache = JT.prefill(jcfg, jp, tokens=jnp.asarray(toks[:, :P]),
                                 cross_embeds=jnp.asarray(ctx), cache_len=S)
        steps, step_cache = [], cache
        step = _jit_decode(jcfg)
        for t in range(P, P + 4):
            logits, step_cache = step(jp, step_cache, jnp.int32(t),
                                      jnp.asarray(toks[:, t:t + 1]))
            steps.append((logits, step_cache))
        return last, cache, steps

    jlast, jcache, jsteps_ = _ref(("decode", arch), reference)
    tlast, cache = T.prefill(tcfg, tp, tokens=torch.tensor(toks[:, :P]),
                             cross_embeds=torch.tensor(ctx), cache_len=S)
    _close(tlast, jlast, LOGITS)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, cache)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jcache))
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        _close(a, b, TOL, TOL)
    cross = [layer["cross"] for layer in cache if "cross" in layer]
    kept = [tree_map(torch.clone, c) for c in cross]
    vcache = tree_map(torch.clone, cache)
    for t, (jl, jcache) in zip(range(P, P + 4), jsteps_):
        tok = toks[:, t:t + 1]
        tl, cache = T.decode_step(tcfg, tp, cache, t, token=torch.tensor(tok))
        vl, vcache = T.decode_step(tcfg, tp, vcache,
                                   torch.full((2,), t, dtype=torch.int32),
                                   token=torch.tensor(tok))
        _close(tl, jl, LOGITS)
        _close(vl, jl, LOGITS)
        for a, v, b in zip(tree_leaves(cache), tree_leaves(vcache),
                           jax.tree.leaves(jcache)):
            _close(a, b, TOL, TOL)
            _close(v, b, TOL, TOL)
    for c, k in zip(cross, kept):
        for name in "kv":
            assert torch.equal(c[name], k[name])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_token_by_token_decode_matches_forward(models, arch, backend):
    """Prefill then decode token by token reproduces the teacher-forced
    logits (the reference's ``tests/test_prefill_decode.py`` property),
    and the decode reads the context from the cache only."""
    _, tcfg, _, tp = models[arch]
    tcfg = tcfg.replace(attn_backend=backend)
    toks, ctx = _inputs(tcfg, 3, S=14)
    toks, ctx = torch.tensor(toks), torch.tensor(ctx)
    P = 8
    with torch.inference_mode():
        full, _ = T.forward(tcfg, tp, tokens=toks, cross_embeds=ctx)
        last, cache = T.prefill(tcfg, tp, tokens=toks[:, :P],
                                cross_embeds=ctx, cache_len=14)
        torch.testing.assert_close(last[:, 0], full[:, P - 1], atol=LOGITS,
                                   rtol=0)
        for t in range(P, 14):
            logits, new = T.decode_step(tcfg, tp, cache, t,
                                        token=toks[:, t:t + 1])
            assert new is cache
            torch.testing.assert_close(logits[:, 0], full[:, t],
                                       atol=LOGITS, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_cache_rows_follow_the_context_as_in_reference(models, arch):
    """``prefill`` caches as many cross rows as the context gives (the
    encoder's output has the frames' length), ``init_cache`` holds
    n_modality_tokens: both as in the reference.  A decode over a prefill
    cache of another length runs in both packages alike."""
    jcfg, tcfg, jp, tp = models[arch]
    toks, ctx = _inputs(jcfg, 6, n_ctx=5)
    _, jcache = JT.prefill(jcfg, jp, tokens=jnp.asarray(toks[:, :6]),
                           cross_embeds=jnp.asarray(ctx), cache_len=8)
    _, cache = T.prefill(tcfg, tp, tokens=torch.tensor(toks[:, :6]),
                         cross_embeds=torch.tensor(ctx), cache_len=8)
    rows = {tuple(layer["cross"]["k"].shape) for layer in cache
            if "cross" in layer}
    assert rows == {(tcfg.n_groups, 2, 5, tcfg.n_kv_heads,
                     tcfg.resolved_head_dim)}
    assert [tuple(a.shape) for a in tree_leaves(cache)] == \
        [a.shape for a in jax.tree.leaves(jcache)]
    jl, _ = _jit_decode(jcfg)(jp, jcache, jnp.int32(6),
                              jnp.asarray(toks[:, 6:7]))
    tl, _ = T.decode_step(tcfg, tp, cache, 6, token=torch.tensor(toks[:, 6:7]))
    _close(tl, jl, LOGITS)
    zero = T.init_cache(tcfg, 2, 8, device="cpu")
    assert {tuple(layer["cross"]["k"].shape) for layer in zero
            if "cross" in layer} == {(tcfg.n_groups, 2,
                                      tcfg.n_modality_tokens,
                                      tcfg.n_kv_heads,
                                      tcfg.resolved_head_dim)}


@pytest.mark.parametrize("arch", ARCHS)
def test_missing_context_raises(models, arch):
    _, tcfg, _, tp = models[arch]
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="cross_embeds"):
        T.forward(tcfg, tp, tokens=toks)
    with pytest.raises(ValueError, match="cross_embeds"):
        T.prefill(tcfg, tp, tokens=toks, cache_len=8)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def _train_batch(cfg, seed, B=2, S=8):
    """tokens [B, S] and, as the reference's launcher builds them,
    ``cross_embeds`` [B, n_modality_tokens, D] (vlm) or ``frames``
    [B, S, D] (enc-dec), numpy."""
    toks, ctx = _inputs(cfg, seed, B, S,
                        n_ctx=S if cfg.enc_dec else None)
    return {"tokens": toks, ("frames" if cfg.enc_dec else "cross_embeds"):
            0.04 * ctx}


@pytest.mark.parametrize("builder", ["train_lib", "launch.steps"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(models, arch, builder):
    """One step of ``train_lib.make_train_step`` (remat) or the launcher's
    ``launch.steps.make_train_step`` with the context in the batch, against
    the reference's ``train_lib.make_train_step`` (whose loss the
    reference's launcher step computes too, without ``shard_logits``): loss
    and every parameter after the update."""
    jcfg, tcfg, jp, tp = models[arch]
    tp = tree_map(torch.clone, tp)
    jopt = joptim.AdamConfig(lr=LR, eps=EPS)
    topt = toptim.AdamConfig(lr=LR, eps=EPS)
    batch = _train_batch(jcfg, 7)
    jp, _, jm = _ref(("train", arch), lambda: jax.jit(
        jtrain.make_train_step(jcfg, jopt))(
            jp, joptim.adam_init(jp, jopt), jax.tree.map(jnp.asarray, batch)))
    if builder == "train_lib":
        tstep = ttrain.make_train_step(tcfg, topt)
    else:
        tstep = tsteps.make_train_step(tcfg, topt)
    tp, _, tm = tstep(tp, toptim.adam_init(tp, topt),
                      {key: torch.tensor(x) for key, x in batch.items()})
    tloss = tm["loss"] if builder == "train_lib" else tm
    np.testing.assert_allclose(float(tloss), float(jm["loss"]), rtol=1e-5)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert torch.isfinite(t).all()
        _close(t, j, PARAM_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_context_gradients_equal_with_and_without_remat(models, arch):
    """The encoder's output (seamless) and the patch embeddings (llama)
    enter every checkpointed group through its context, not as an argument
    of the checkpoint: the encoder's and cross layers' leaves get the same
    gradients with remat as without, and none of them is zero."""
    _, tcfg, _, tp = models[arch]
    tp = tree_map(torch.clone, tp)
    batch = {key: torch.tensor(x)
             for key, x in _train_batch(tcfg, 8).items()}
    grads = {}
    for remat in (False, True):
        _, grads[remat] = ttrain.value_and_grad(
            ttrain.lm_loss_fn(tcfg, remat), tp, batch)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    grad_of = {id(leaf): g for leaf, g in zip(tree_leaves(tp), grads[True])}
    cross = [layer["cross"] for layer in tp["blocks"] if "cross" in layer]
    # a cross layer normalises with cross_norm; its "norm" is unused, as
    # in the reference
    unused = {id(c["norm"]["scale"]) for c in cross}
    for leaf in tree_leaves(tp.get("encoder", {})) + tree_leaves(cross):
        assert bool(grad_of[id(leaf)].abs().max() > 0) == \
            (id(leaf) not in unused)


# --------------------------------------------------------------------------
# checkpoint and launcher
# --------------------------------------------------------------------------
def test_checkpoint_round_trip_of_the_encoder_decoder_tree(models, tmp_path):
    """The seamless tree (encoder subtree and cross leaves) through
    ``params_to_numpy`` and both packages' ``checkpoint/io`` in both
    directions, every value kept."""
    jcfg, tcfg, jp, tp = models["seamless-m4t-medium"]
    back = params_to_numpy(tp)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, _np(b))
    tio.save(tmp_path / "t.npz", tp, step=2)
    loaded, meta = tio.load(tmp_path / "t.npz",
                            T.init_params(tcfg, 9, device="cpu"))
    jloaded, _ = jio.load(str(tmp_path / "t.npz"), jp)
    jio.save(str(tmp_path / "j.npz"), jp)
    from_j, _ = tio.load(tmp_path / "j.npz",
                         T.init_params(tcfg, 9, device="cpu"))
    assert meta["step"] == 2
    assert len(tree_leaves(loaded)) == len(jax.tree.leaves(jp))
    for a, b, c, want in zip(tree_leaves(loaded), jax.tree.leaves(jloaded),
                             tree_leaves(from_j), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), _np(want))
        np.testing.assert_array_equal(_np(b), _np(want))
        np.testing.assert_array_equal(c.numpy(), _np(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_cpu(arch, capsys):
    """``launch/train.main`` at reduced size: the logged losses are those
    of ``train_lib.make_train_step`` on the same tokens and the same stub
    context (0.02 N(0, 1) from a generator seeded by the step)."""
    ttrain_launch.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    cfg = tbase.get_config(arch, reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    opt = toptim.AdamConfig(lr=3e-3, grad_clip=1.0)
    step = ttrain.make_train_step(cfg, opt, remat=False)
    state = toptim.adam_init(params, opt)
    want = []
    for i, toks in enumerate(lm_batches(cfg.vocab, 2, 8, 2, seed=0)):
        n = 8 if cfg.enc_dec else cfg.n_modality_tokens
        ctx = 0.02 * torch.randn((2, n, cfg.d_model),
                                 generator=torch.Generator().manual_seed(i))
        batch = {"tokens": torch.as_tensor(toks[:, :8]),
                 ("frames" if cfg.enc_dec else "cross_embeds"): ctx}
        params, state, m = step(params, state, batch)
        want.append(float(m["loss"]))
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, want, atol=5e-5)


def test_config_fields_equal_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            t = dataclasses.asdict(tbase.get_config(arch, reduced))
            j = dataclasses.asdict(jbase.get_config(arch, reduced))
            t.pop("attn_backend"), j.pop("attn_backend")
            assert t == j
