"""Coded autoregressive LM serving in the port (``serving/generation.py``)
against the JAX package, on the CPU (``device="cpu"``).

The engine tests are the reference's (``tests/test_generation.py``) on the
same exactness substrate, a running-sum linear model written in torch: the
"KV cache" is one state vector per slot, ``state += embed(token)`` per step,
``logits = state @ W``.  Logits are linear in the input embeddings, so
embedding-space encode + logit-space decode is exact — a reconstructed step
must emit the token the straggler would have, and the continuous-batching
invariants (slot isolation, batched == sequential) hold bit for bit.  Then
the default transformer substrate serves the same tokens as the JAX
package's engine on shared parameters, and the sim engine's report equals
the reference's field for field when both price the same hardware.
"""
import math
import time
from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch import roofline as jroof
from repro.models import transformer as JT
from repro.serving import api as japi
from repro.serving import generation as jgen
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.roofline import Hardware
from repro_torch.models import transformer as T
from repro_torch.serving.api import BatchingPolicy, deploy_lm
from repro_torch.serving.generation import (GenerationSpec, LMSimSession,
                                            token_service_ms)
from repro_torch.serving.scenarios import instance_id

V, D = 29, 8


def _linear_substrate(seed=0):
    rng = np.random.default_rng(seed)
    emb = torch.tensor(rng.normal(size=(V, D)).astype(np.float32))
    W = torch.tensor(rng.normal(size=(D, V)).astype(np.float32))
    params = {"embed": emb, "W": W}

    def embed_fn(p, tokens):
        return p["embed"][torch.as_tensor(tokens).long()]

    def prefill_fn(p, tokens=None, embeds=None, cache_len=0):
        e = embeds if embeds is not None else embed_fn(p, tokens)
        state = e.sum(dim=1)                             # [B, D]
        return (state @ p["W"])[:, None], {"state": state[None]}

    def decode_fn(p, cache, pos, token=None, embed=None):
        e = embed if embed is not None else embed_fn(p, token)   # [B, 1, D]
        state = cache["state"] + e[None, :, 0]           # [1, B, D]
        return (state[0] @ p["W"])[:, None], {"state": state}

    def init_cache_fn(p, batch, cache_len):
        return {"state": torch.zeros((1, batch, D))}

    return params, dict(prefill_fn=prefill_fn, decode_fn=decode_fn,
                        embed_fn=embed_fn, init_cache_fn=init_cache_fn)


def _spec(params, fns, **kw):
    defaults = dict(params=params, k=2, r=1, scheme="sum",
                    batching=BatchingPolicy(max_size=2), max_seq_len=64,
                    max_new_tokens=5, straggle_ms=2_000.0, device="cpu",
                    **fns)
    defaults.update(kw)
    return GenerationSpec(**defaults)


def _prompts(n, seed=3, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, rng.integers(lo, hi))]
            for _ in range(n)]


def _run(spec, prompts, poll=None):
    with deploy_lm(spec, engine="threads") as sess:
        futs = []
        for i, p in enumerate(prompts):
            futs.append(sess.submit(p))
            if poll:
                poll(i, futs)
        assert sess.wait_all(60.0)
        toks = [f.result(1.0) for f in futs]
        return toks, sess.stats(), futs


def _reference(params, fns, prompt, n_tokens):
    """Uncoded greedy loop straight on the substrate."""
    logits, cache = fns["prefill_fn"](params, tokens=torch.tensor([prompt]))
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n_tokens - 1):
        logits, cache = fns["decode_fn"](params, cache, None,
                                         token=torch.tensor([[out[-1]]]))
        out.append(int(torch.argmax(logits[0, 0])))
    return out


# -------------------------------------------------------------------------
# correctness: coded serving == uncoded greedy decode
# -------------------------------------------------------------------------
def test_matches_reference_greedy_decode():
    params, fns = _linear_substrate()
    prompts = _prompts(3)
    toks, report, _ = _run(_spec(params, fns), prompts)
    for p, t in zip(prompts, toks):
        assert t == _reference(params, fns, p, 5)
    assert report.n == 3 * 5
    assert report.reconstructed_steps == 0


def test_reconstructed_steps_emit_the_stragglers_tokens():
    """Member 0 misses every per-step deadline; parity reconstruction must
    keep its streams flowing with the exact tokens it would have emitted."""
    params, fns = _linear_substrate()
    slow = instance_id("main", 0)

    def delay(iid):
        return 0.3 if iid == slow else 0.0

    prompts = _prompts(2)
    spec = _spec(params, fns, batching=BatchingPolicy(max_size=1),
                 straggle_ms=50.0, delay_fn=delay)
    toks, report, futs = _run(spec, prompts)
    for p, t in zip(prompts, toks):
        assert t == _reference(params, fns, p, 5)
    assert report.reconstructed_steps > 0
    assert futs[0].reconstructed_steps > 0
    assert report.completed_by.get("parity", 0) == report.reconstructed_steps


def test_irrecoverable_step_blocks_but_stays_correct():
    """More stragglers than parities: the step must block for the straggler
    (no silent wrong answer) and still emit the right tokens."""
    params, fns = _linear_substrate()
    members = {instance_id("main", 0), instance_id("main", 1)}

    def delay(iid):                     # both members slow, parity fast
        return 0.1 if iid in members else 0.0

    prompts = _prompts(2, seed=11)
    spec = _spec(params, fns, straggle_ms=20.0, delay_fn=delay,
                 max_new_tokens=3)
    toks, report, _ = _run(spec, prompts)
    for p, t in zip(prompts, toks):
        assert t == _reference(params, fns, p, 3)
    assert report.reconstructed_steps == 0


# -------------------------------------------------------------------------
# continuous-batching invariants
# -------------------------------------------------------------------------
def test_batched_equals_sequential_bit_equal():
    params, fns = _linear_substrate(seed=5)
    prompts = _prompts(5, seed=7)
    spec = _spec(params, fns)
    batched, _, _ = _run(spec, prompts)
    sequential = []
    with deploy_lm(spec, engine="threads") as sess:
        for p in prompts:
            sequential.append(sess.submit(p).result(30.0))
    assert batched == sequential


def test_mid_flight_join_does_not_perturb_resident_stream():
    params, fns = _linear_substrate(seed=2)
    [pa, pb] = _prompts(2, seed=13)
    spec = _spec(params, fns, max_new_tokens=8)
    solo, _, _ = _run(spec, [pa])
    with deploy_lm(spec, engine="threads") as sess:
        fa = sess.submit(pa)
        deadline = time.monotonic() + 30.0
        while len(fa.tokens_so_far) < 3:        # genuinely mid-generation
            assert time.monotonic() < deadline
            time.sleep(1e-3)
        fb = sess.submit(pb)
        a, b = fa.result(30.0), fb.result(30.0)
    assert a == solo[0]
    assert b == _reference(params, fns, pb, 8)


def test_slot_recycling_under_oversubscription():
    params, fns = _linear_substrate(seed=4)
    prompts = _prompts(9, seed=17)
    spec = _spec(params, fns, max_new_tokens=3)
    toks, report, futs = _run(spec, prompts)
    assert len(toks) == 9
    for p, t in zip(prompts, toks):
        assert t == _reference(params, fns, p, 3)
    assert sorted(f.rid for f in futs) == list(range(9))
    assert report.n == 9 * 3


def test_report_per_token_fields():
    params, fns = _linear_substrate()
    _, report, futs = _run(_spec(params, fns), _prompts(2))
    assert report.engine == "threads"
    assert report.tokens_per_s > 0
    assert report.inter_token_p50_ms == report.median_ms
    assert np.isfinite(report.inter_token_p999_ms)
    assert report["reconstructed_steps"] == 0
    for f in futs:
        gaps = f.inter_token_ms
        assert len(gaps) == 5 and all(g >= 0 for g in gaps)


# -------------------------------------------------------------------------
# the transformer substrate against the JAX package's engine
# -------------------------------------------------------------------------
def _jax_served(jcfg, jparams, prompts, **kw):
    spec = jgen.GenerationSpec(cfg=jcfg, params=jparams, **kw)
    with japi.deploy_lm(spec, engine="threads") as sess:
        futs = [sess.submit(p) for p in prompts]
        assert sess.wait_all(120.0)
        return [f.result(1.0) for f in futs]


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_transformer_substrate_serves_the_reference_tokens(backend):
    """Reduced qwen2-0.5b with the JAX package's parameters: the port's
    engine emits the JAX engine's tokens, and both equal the port's own
    uncoded greedy loop over prefill / decode_step."""
    jcfg = jget_config("qwen2-0.5b", reduced=True)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_config("qwen2-0.5b", reduced=True).replace(
        attn_backend=backend)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = [[1, 2, 3, 4], [5, 6, 7], [9, 8, 7, 6, 5]]
    kw = dict(k=2, r=1, scheme="sum", max_seq_len=32, max_new_tokens=4,
              straggle_ms=10_000.0)
    want = _jax_served(jcfg, jp, prompts,
                       batching=japi.BatchingPolicy(max_size=2), **kw)
    spec = GenerationSpec(cfg=tcfg, params=tp, device="cpu",
                          batching=BatchingPolicy(max_size=2), **kw)
    with deploy_lm(spec, engine="threads") as sess:
        futs = [sess.submit(p) for p in prompts]
        assert sess.wait_all(120.0)
        got = [f.result(1.0) for f in futs]
        stats = sess.stats()
    assert got == want
    assert stats.n == len(prompts) * 4
    with torch.inference_mode():
        for p, t in zip(prompts, got):
            logits, cache = T.prefill(tcfg, tp, tokens=torch.tensor([p]),
                                      cache_len=32)
            loop = [int(torch.argmax(logits[0, -1]))]
            for pos in range(len(p), len(p) + 3):
                logits, cache = T.decode_step(tcfg, tp, cache, pos,
                                              token=torch.tensor([[loop[-1]]]))
                loop.append(int(torch.argmax(logits[0, 0])))
            assert t == loop


def test_transformer_substrate_reconstructs_a_straggler():
    """Member 0 straggles on every job: its streams are served from the
    parity reconstruction (an approximation for a nonlinear model) and keep
    flowing; member 1's streams still emit the uncoded tokens."""
    tcfg = get_config("qwen2-0.5b", reduced=True)
    tp = T.init_params(tcfg, 0, device="cpu")
    slow = instance_id("main", 0)
    spec = GenerationSpec(
        cfg=tcfg, params=tp, k=2, r=1, device="cpu", max_seq_len=32,
        max_new_tokens=4, straggle_ms=40.0, batching=BatchingPolicy(
            max_size=1), delay_fn=lambda iid: 0.25 if iid == slow else 0.0)
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    with deploy_lm(spec, engine="threads") as sess:
        futs = [sess.submit(p) for p in prompts]
        assert sess.wait_all(120.0)
        stats = sess.stats()
    assert all(len(f.result(1.0)) == 4 for f in futs)
    assert stats.reconstructed_steps > 0 and futs[0].reconstructed_steps > 0
    assert futs[1].reconstructed_steps == 0
    with torch.inference_mode():
        logits, cache = T.prefill(tcfg, tp, tokens=torch.tensor([prompts[1]]),
                                  cache_len=32)
        loop = [int(torch.argmax(logits[0, -1]))]
        for pos in range(4, 7):
            logits, cache = T.decode_step(tcfg, tp, cache, pos,
                                          token=torch.tensor([[loop[-1]]]))
            loop.append(int(torch.argmax(logits[0, 0])))
    assert futs[1].result(1.0) == loop


# -------------------------------------------------------------------------
# sim engine, spec validation, devices
# -------------------------------------------------------------------------
def _report_equal(got, want):
    assert [f.name for f in fields(got)] == [f.name for f in fields(want)]
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), f.name
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("scenario", ["bursty", "storm"])
def test_sim_engine_report_equals_reference(scenario):
    """LMSimSession.replay on qwen3-moe-235b-a22b with the reference's
    hardware constants passed in: the same report, exactly."""
    kw = dict(k=4, r=1, m=12, utilization=0.3, kv_len=4096, tp=8,
              scenario=scenario)
    jspec = jgen.GenerationSpec(cfg=jget_config("qwen3-moe-235b-a22b"), **kw)
    tspec = GenerationSpec(cfg=get_config("qwen3-moe-235b-a22b"),
                           device="cpu", hardware=Hardware(
                               jroof.PEAK_FLOPS, jroof.HBM_BW), **kw)
    assert token_service_ms(tspec) == jgen.token_service_ms(jspec)
    for strategy in ("parm", "equal_resources"):
        want = japi.deploy_lm(jspec.replace(strategy=strategy),
                              engine="sim").replay(n_tokens=5_000, seed=1)
        got = deploy_lm(tspec.replace(strategy=strategy),
                        engine="sim").replay(n_tokens=5_000, seed=1)
        _report_equal(got, want)
    assert got.tokens_per_s > 0


def test_sim_engine_prices_the_h100_by_default():
    spec = GenerationSpec(cfg=get_config("qwen2-0.5b"), device="cpu",
                          batching=BatchingPolicy(max_size=4), kv_len=1280)
    from repro_torch.launch.roofline import H100_SXM, decode_token_cost
    assert token_service_ms(spec) == 1e3 * decode_token_cost(
        spec.cfg, batch=4, kv_len=1280, hw=H100_SXM)
    assert token_service_ms(spec) < jgen.token_service_ms(jgen.GenerationSpec(
        cfg=jget_config("qwen2-0.5b"), kv_len=1280))


def test_deploy_lm_rejects_bad_engine_and_spec():
    params, fns = _linear_substrate()
    spec = _spec(params, fns)
    with pytest.raises(ValueError):
        deploy_lm(spec, engine="carrier-pigeon")
    with pytest.raises(TypeError):
        deploy_lm({"not": "a spec"})
    with pytest.raises(ValueError):
        GenerationSpec(params=params, k=0, device="cpu", **fns)
    with pytest.raises(TypeError):
        GenerationSpec(batching=4, device="cpu")
    with pytest.raises(RuntimeError):
        LMSimSession(spec).stats()
    with pytest.raises(ValueError, match="cfg"):
        deploy_lm(GenerationSpec(device="cpu"), engine="threads")


def test_generation_spec_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationSpec()
    params, fns = _linear_substrate()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy_lm(GenerationSpec(params=params, **fns))
    assert GenerationSpec(device="cpu").device == "cpu"
