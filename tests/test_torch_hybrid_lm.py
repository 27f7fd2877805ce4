"""The port's MoE, SSM and hybrid decoder stacks (``models/transformer.py``
with ``models/moe.py`` and ``models/mamba.py``) against the JAX package, on
the CPU: whole models, their train steps, their caches in coded serving,
their full-size shapes, and their mixed-dtype parameter trees.

Reduced deepseek-moe-16b (MoE with a shared expert), qwen3-moe-235b-a22b
(MoE, qk-norm), mamba2-780m (SSM) and jamba-1.5-large-398b (mamba + MLP and
attention + MoE layers).  The same seeded numpy inputs and parameters go
through both packages; parameters are carried across with
``params_from_numpy``.  Tolerances: 2e-5 for logits, aux and caches (fp32;
measured differences are ~5e-6), 1e-5 relative for losses and 1e-6 for the
parameters after three Adam steps at eps 1e-3 (as ``test_torch_train.py``
explains), 2e-3 for the reference's decode-against-forward property (as
``tests/test_prefill_decode.py``), exact for shapes, dtypes and counts.
"""
import dataclasses
import math

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
from repro.training import train_lib as jtrain
from repro_torch.checkpoint import io as tio
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, params_to_numpy, \
    tree_leaves
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as T
from repro_torch.serving.api import BatchingPolicy, deploy_lm
from repro_torch.serving.generation import GenerationSession, GenerationSpec
from repro_torch.serving.scenarios import instance_id
from repro_torch.training import optim as toptim
from repro_torch.training import train_lib as ttrain

TOL = 2e-5
PROP = 2e-3
LR, EPS, PARAM_TOL = 1e-3, 1e-3, 1e-6
ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b", "mamba2-780m",
         "jamba-1.5-large-398b"]


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _cfgs(arch, **kw):
    return jbase.get_config(arch, reduced=True).replace(**kw), \
        tbase.get_config(arch, reduced=True).replace(**kw)


_MODELS = {}


def _model(arch, **kw):
    """The reference's parameters for reduced ``arch`` (its config fields
    replaced by ``kw`` in both packages) with every leaf perturbed (zero
    biases and unit scales would hide a wiring fault): (jax cfg, torch cfg,
    jax tree, torch tree), built once per module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, **kw)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.01 *
                                       rng.standard_normal(a.shape)).astype(
            np.float32), jp)
        _MODELS[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        params_from_numpy(tree, "cpu"))
    return _MODELS[key]


def _toks(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_layout_equal_reference(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.init_params(tcfg, 0, device="cpu")
    assert T.layer_plan(tcfg) == JT.layer_plan(jcfg)
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == \
        jax.tree.map(lambda a: a.shape, jp)
    assert [str(t.dtype).removeprefix("torch.") for t in tree_leaves(tp)] \
        == [str(j.dtype) for j in jax.tree.leaves(jp)]
    assert T.param_count(tp) == JT.param_count(jp)
    cache = T.init_cache(tcfg, 3, 20, device="cpu")
    jcache = JT.init_cache(jcfg, 3, 20)
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix(
        "torch.")), cache) == jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                           jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_full_size_equal_reference(arch):
    """The full-size trees on the meta device (nothing allocated, 398 B
    parameters for jamba) against the reference's ``jax.eval_shape``."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    shapes = tsteps.param_shapes(tcfg)
    assert all(leaf.device.type == "meta" for leaf in tree_leaves(shapes))
    jshapes = jsteps.param_shapes(jcfg)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_leaves(shapes)] == \
        [(tuple(j.shape), str(j.dtype)) for j in jax.tree.leaves(jshapes)]
    assert tsteps.n_params_of(shapes) == jsteps.n_params_of(jshapes)
    if arch == "deepseek-moe-16b":
        # exact; the roofline's estimate leaves the norm scales out
        assert tsteps.n_params_of(shapes) == 16_879_568_896
        assert troof.estimate_param_count(tcfg) == 16_879_452_160


# --------------------------------------------------------------------------
# forward / prefill / decode against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    """``forward`` logits and aux, ``prefill`` logits and caches, then four
    ``decode_step``s with a scalar pos and, on a copy of the cache, with a
    [B] pos: logits and caches after each step against the reference's."""
    check_forward_prefill_decode(*_model(arch))


def check_forward_prefill_decode(jcfg, tcfg, jp, tp):
    """``test_forward_prefill_decode_match_reference``'s comparison on one
    model: (jax cfg, torch cfg, jax tree, torch tree)."""
    toks = _toks(jcfg.vocab, (2, 20), 1)
    full, jaux = JT.forward(jcfg, jp, tokens=jnp.asarray(toks))
    tfull, aux = T.forward(tcfg, tp, tokens=torch.tensor(toks))
    _close(tfull, full, TOL, TOL)
    _close(aux, jaux, TOL, TOL)
    assert (float(aux) > 0) == bool(jcfg.n_experts)
    P, S = 16, 24
    jlast, jcache = JT.prefill(jcfg, jp, tokens=jnp.asarray(toks[:, :P]),
                               cache_len=S)
    tlast, cache = T.prefill(tcfg, tp, tokens=torch.tensor(toks[:, :P]),
                             cache_len=S)
    _close(tlast, jlast, TOL, TOL)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, cache)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jcache))
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        _close(a, b, TOL, TOL)
    vcache = jax.tree.map(torch.clone, cache)
    for t in range(P, P + 4):
        tok = toks[:, t:t + 1]
        jl, jcache = JT.decode_step(jcfg, jp, jcache, t,
                                    token=jnp.asarray(tok))
        tl, cache = T.decode_step(tcfg, tp, cache, t, token=torch.tensor(tok))
        vl, vcache = T.decode_step(tcfg, tp, vcache,
                                   torch.full((2,), t, dtype=torch.int32),
                                   token=torch.tensor(tok))
        _close(tl, jl, TOL, TOL)
        _close(vl, jl, TOL, TOL)
        for a, v, b in zip(tree_leaves(cache), tree_leaves(vcache),
                           jax.tree.leaves(jcache)):
            _close(a, b, TOL, TOL)
            _close(v, b, TOL, TOL)


def test_kernels_backend_matches_pallas_interpret():
    """Reduced deepseek on the port's "kernels" backend (B7 / B8's plain
    versions on the CPU) against the reference's "pallas" backend (its
    kernels in interpret mode): forward, prefill and two decode steps."""
    check_kernels_vs_pallas(*_model("deepseek-moe-16b"))


def check_kernels_vs_pallas(jcfg, tcfg, jp, tp):
    """``test_kernels_backend_matches_pallas_interpret``'s comparison on one
    model: (jax cfg, torch cfg, jax tree, torch tree)."""
    jcfg = jcfg.replace(attn_backend="pallas")
    assert tcfg.attn_backend == "kernels"
    toks = _toks(jcfg.vocab, (2, 12), 2)
    full, _ = JT.forward(jcfg, jp, tokens=jnp.asarray(toks))
    _close(T.forward(tcfg, tp, tokens=torch.tensor(toks))[0], full, TOL, TOL)
    jl, jcache = JT.prefill(jcfg, jp, tokens=jnp.asarray(toks[:, :10]),
                            cache_len=16)
    tl, cache = T.prefill(tcfg, tp, tokens=torch.tensor(toks[:, :10]),
                          cache_len=16)
    _close(tl, jl, TOL, TOL)
    for t in (10, 11):
        jl, jcache = JT.decode_step(jcfg, jp, jcache, t,
                                    token=jnp.asarray(toks[:, t:t + 1]))
        tl, cache = T.decode_step(tcfg, tp, cache, t,
                                  token=torch.tensor(toks[:, t:t + 1]))
        _close(tl, jl, TOL, TOL)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_vector_pos_decode_bit_equal_to_scalar(arch):
    """decode_step(pos scalar) == decode_step(pos [B] uniform), bit-equal
    in logits and every cache leaf (the reference's
    ``tests/test_prefill_decode.py`` property)."""
    _, tcfg, _, tp = _model(arch)
    B, P = 2, 8
    toks = torch.tensor(_toks(tcfg.vocab, (B, P + 1), 3))
    _, cache = T.prefill(tcfg, tp, tokens=toks[:, :P], cache_len=P + 4)
    cache_v = jax.tree.map(torch.clone, cache)
    tok = toks[:, P:P + 1]
    log_s, cache_s = T.decode_step(tcfg, tp, cache, P, token=tok)
    log_v, cache_v = T.decode_step(tcfg, tp, cache_v,
                                   torch.full((B,), P, dtype=torch.int32),
                                   token=tok)
    assert torch.equal(log_s, log_v)
    for a, b in zip(tree_leaves(cache_s), tree_leaves(cache_v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_by_token_decode_matches_forward(arch):
    """Prefill then decode token by token reproduces the teacher-forced
    logits (capacity factor 8: the reduced MoE drops nothing), and a decode
    writes its SSM states in place: the cache it returns is the one given."""
    _, tcfg = _cfgs(arch, capacity_factor=8.0)
    params = T.init_params(tcfg, 0, device="cpu")
    B, P, N = 2, 8, 6
    toks = torch.tensor(_toks(tcfg.vocab, (B, P + N), 4))
    with torch.inference_mode():
        full, _ = T.forward(tcfg, params, tokens=toks)
        last, cache = T.prefill(tcfg, params, tokens=toks[:, :P],
                                cache_len=P + N)
        torch.testing.assert_close(last[:, 0], full[:, P - 1], atol=PROP,
                                   rtol=0)
        for t in range(P, P + N):
            logits, new = T.decode_step(tcfg, params, cache, t,
                                        token=toks[:, t:t + 1])
            assert new is cache
            torch.testing.assert_close(logits[:, 0], full[:, t], atol=PROP,
                                       rtol=0, msg=f"{arch} pos {t}")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m"])
def test_train_steps_match_reference(arch):
    """Three steps of ``train_lib.make_train_step`` (remat, the MoE aux in
    the loss) against the reference's, at the reduced ``ssm_chunk`` (32)."""
    jcfg, tcfg, jp, tp = _model(arch)
    tp = jax.tree.map(torch.clone, tp)
    jopt = joptim.AdamConfig(lr=LR, eps=EPS)
    topt = toptim.AdamConfig(lr=LR, eps=EPS)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt))
    tstep = ttrain.make_train_step(tcfg, topt)
    js, ts = joptim.adam_init(jp, jopt), toptim.adam_init(tp, topt)
    rng = np.random.default_rng(5)
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.tensor(toks)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert torch.isfinite(t).all()
        _close(t, j, PARAM_TOL)


def test_moe_aux_reaches_the_loss():
    """The train loss is the LM loss plus ``router_aux_coef`` times the
    forward's aux, and the aux moves the router's gradient."""
    _, tcfg, _, tp = _model("deepseek-moe-16b")
    tp = jax.tree.map(torch.clone, tp)
    batch = {"tokens": torch.tensor(_toks(tcfg.vocab, (2, 10), 6))}
    with torch.no_grad():
        _, aux = T.forward(tcfg, tp, tokens=batch["tokens"])
    assert float(aux) > 0
    out = {}
    for coef in (0.0, 0.5):
        loss_fn = ttrain.lm_loss_fn(tcfg.replace(router_aux_coef=coef),
                                    remat=False)
        loss, grads = ttrain.value_and_grad(loss_fn, tp, batch)
        router = next(i for i, leaf in enumerate(tree_leaves(tp))
                      if leaf is tp["blocks"][0]["moe"]["router"])
        out[coef] = (float(loss), grads[router])
    np.testing.assert_allclose(out[0.5][0] - out[0.0][0], 0.5 * float(aux),
                               rtol=1e-4)
    assert not torch.allclose(out[0.5][1], out[0.0][1])


# --------------------------------------------------------------------------
# mixed-dtype trees: convert and checkpoint
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-1.5-large-398b"])
def test_leaf_dtypes_kept_through_convert_and_checkpoint(arch, tmp_path):
    """A bf16 tree with fp32 leaves (the router; A_log, D and dt_bias)
    keeps each leaf's dtype and every value: JAX -> ``params_from_numpy``
    -> ``params_to_numpy`` (bf16 arrives as float32, which numpy has instead)
    and through both packages' ``checkpoint/io`` in both directions."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    want = [str(a.dtype) for a in jax.tree.leaves(jp)]
    assert "float32" in want and "bfloat16" in want
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def names(tree):
        return [str(t.dtype).removeprefix("torch.") for t in tree_leaves(tree)]

    def equal(tree, ref=jp):
        for t, j in zip(tree_leaves(tree), jax.tree.leaves(ref)):
            t = t.float().numpy() if isinstance(t, torch.Tensor) else t
            np.testing.assert_array_equal(t, np.asarray(j, np.float32))

    assert names(tp) == want
    back = params_to_numpy(tp)
    assert [str(a.dtype) for a in tree_leaves(back)] == \
        [("float32" if d == "bfloat16" else d) for d in want]
    equal(back)
    # the port's file, read by the port and by the reference
    tio.save(tmp_path / "t.npz", tp, step=3)
    loaded, meta = tio.load(tmp_path / "t.npz", T.init_params(
        tcfg, 9, device="cpu"))
    assert meta["dtypes"] == want and meta["step"] == 3
    assert names(loaded) == want
    equal(loaded)
    jloaded, _ = jio.load(str(tmp_path / "t.npz"), jp)
    assert [str(a.dtype) for a in jax.tree.leaves(jloaded)] == want
    equal(jloaded)
    # the reference's file, read by the port
    jio.save(str(tmp_path / "j.npz"), jp)
    loaded, meta = tio.load(tmp_path / "j.npz", T.init_params(
        tcfg, 9, device="cpu"))
    assert meta["dtypes"] == want and names(loaded) == want
    equal(loaded)


# --------------------------------------------------------------------------
# coded serving
# --------------------------------------------------------------------------
def _loop(cfg, params, prompt, n, cache_len):
    """The uncoded greedy loop (batch 1, scalar pos)."""
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, tokens=torch.tensor([prompt]),
                                  cache_len=cache_len)
        out = [int(torch.argmax(logits[0, -1]))]
        for pos in range(len(prompt), len(prompt) + n - 1):
            logits, cache = T.decode_step(cfg, params, cache, pos,
                                          token=torch.tensor([[out[-1]]]))
            out.append(int(torch.argmax(logits[0, 0])))
    return out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m"])
def test_deploy_lm_serves_the_loop_tokens(arch):
    """Clean: every stream equals the uncoded loop.  Member 0 late on every
    job: its streams are rebuilt from parity and keep flowing, member 1's
    streams are untouched and still equal the loop."""
    _, tcfg, _, tp = _model(arch)
    check_serves_the_loop_tokens(tcfg, tp)


def check_serves_the_loop_tokens(tcfg, tp):
    """``test_deploy_lm_serves_the_loop_tokens``'s two serves of one torch
    model (cfg, parameters) on the CPU."""
    prompts = [_toks(tcfg.vocab, (n,), 10 + n).tolist() for n in (5, 9, 7,
                                                                  12)]
    new, seq = 4, 32
    loops = [_loop(tcfg, tp, p, new, seq) for p in prompts]
    kw = dict(cfg=tcfg, params=tp, k=2, r=1, scheme="sum", device="cpu",
              max_seq_len=seq, max_new_tokens=new,
              batching=BatchingPolicy(max_size=2))
    with deploy_lm(GenerationSpec(straggle_ms=10_000.0, **kw),
                   engine="threads") as sess:
        futs = [sess.submit(p) for p in prompts]
        assert sess.wait_all(120.0)
        stats = sess.stats()
    assert [f.result(1.0) for f in futs] == loops
    assert stats.reconstructed_steps == 0
    slow = instance_id("main", 0)
    # a deadline that a loaded CPU still meets, the straggler well past it
    with deploy_lm(GenerationSpec(
            straggle_ms=150.0, delay_fn=lambda iid: 0.5 if iid == slow
            else 0.0, **kw), engine="threads") as sess:
        futs = [sess.submit(p) for p in prompts]
        assert sess.wait_all(120.0)
        stats = sess.stats()
    # slots fill member 0 first: rids 0-1 live on member 0, 2-3 on member 1
    assert stats.reconstructed_steps > 0
    assert all(f.reconstructed_steps > 0 for f in futs[:2])
    assert all(len(f.result(1.0)) == new for f in futs)
    for f, loop in zip(futs[2:], loops[2:]):
        assert f.reconstructed_steps == 0
        assert f.result(1.0) == loop


def test_warmup_leaves_the_served_pools_untouched():
    """The session's warm-up decodes run on a scratch pool: every member
    and parity pool is still all zeros when the session is up, so no SSM
    state was advanced by a decode the reference throws away."""
    _, tcfg, _, tp = _model("jamba-1.5-large-398b")
    spec = GenerationSpec(cfg=tcfg, params=tp, k=2, r=1, device="cpu",
                          max_seq_len=16, batching=BatchingPolicy(max_size=2))
    sess = GenerationSession(spec)
    try:
        pools = [inst.pool for inst in sess._members + sess._parities]
        assert any("ssm" in layer for layer in pools[0])
        for leaf in tree_leaves(pools):
            assert not leaf.any()
    finally:
        sess.shutdown()


def test_decode_twice_advances_the_state_twice():
    """The in-place contract: a decode run twice on one cache advances its
    SSM state twice (what the serving engine must never do), while a
    clone keeps the state before the step."""
    _, tcfg, _, tp = _model("mamba2-780m")
    toks = torch.tensor(_toks(tcfg.vocab, (1, 6), 7))
    with torch.inference_mode():
        _, cache = T.prefill(tcfg, tp, tokens=toks[:, :5], cache_len=8)
        kept = jax.tree.map(torch.clone, cache)
        once, _ = T.decode_step(tcfg, tp, cache, 5, token=toks[:, 5:])
        twice, _ = T.decode_step(tcfg, tp, cache, 5, token=toks[:, 5:])
        again, _ = T.decode_step(tcfg, tp, kept, 5, token=toks[:, 5:])
    assert torch.equal(again, once)
    assert not torch.equal(twice, once)


def test_config_fields_equal_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            t = dataclasses.asdict(tbase.get_config(arch, reduced))
            j = dataclasses.asdict(jbase.get_config(arch, reduced))
            t.pop("attn_backend"), j.pop("attn_backend")
            assert t == j
    cfg = tbase.get_config("deepseek-moe-16b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.n_experts, cfg.moe_top_k,
            cfg.n_shared_experts, cfg.moe_d_ff, cfg.vocab) == \
        (28, 2048, 16, 16, 128, 64, 6, 2, 1408, 102400)
    m = tbase.get_config("mamba2-780m")
    assert (m.n_layers, m.d_inner, m.ssm_heads, m.ssm_state,
            m.ssm_head_dim, m.ssm_chunk) == (48, 3072, 48, 128, 64, 256)
    assert math.prod((28, 64, 2048, 1408)) * 4 / 1e9 > 20     # why _draw
