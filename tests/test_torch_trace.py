"""The port's spans (``repro_torch/trace.py``) on the torch profiler's
timeline, on the CPU: a reduced plan served by the threads engine under a
profile of every thread, a reduced MoE forward, and the no-op context when
no profiler runs."""
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.serving.api import BatchingPolicy, deploy_lm
from repro_torch.serving.generation import GenerationSpec

PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11, 12], [13, 14]]
NEW, SEQ = 4, 32


def _profile():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _spans(prof):
    """{name: [(start, end, native thread id)]} of the program's spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro_torch."):
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.device_resource_id()))
    return out


def _inside(inner, outers, same_thread=True):
    return any(s <= inner[0] and inner[1] <= e and
               (t == inner[2] or not same_thread) for s, e, t in outers)


def _plan():
    cfg = get_config("qwen2-0.5b", reduced=True)
    return cfg, T.init_params(cfg, 0, device="cpu")


def _serve(cfg, params, traced):
    """The served tokens of ``PROMPTS``, the session's job log and, with
    ``traced``, the program's spans and the session's thread ids."""
    spec = GenerationSpec(
        cfg=cfg, params=params, k=2, r=1, device="cpu", max_seq_len=SEQ,
        max_new_tokens=NEW, straggle_ms=60_000.0,
        batching=BatchingPolicy(max_size=1))
    sess = deploy_lm(spec, engine="threads")
    prof = _profile() if traced else None
    try:
        if prof is not None:
            prof.__enter__()
        futs = [sess.submit(p) for p in PROMPTS]
        assert sess.wait_all(120.0)
    finally:
        sess.shutdown()                    # every job ends inside the span
        if prof is not None:
            prof.__exit__(None, None, None)
    threads = {"member": {m.ex.native_id for m in sess._members},
               "parity": {p.ex.native_id for p in sess._parities},
               "scheduler": {sess._scheduler.native_id}}
    return ([f.result(1.0) for f in futs], list(sess.issued),
            _spans(prof) if prof is not None else None, threads)


def _loop(cfg, params, prompt):
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, tokens=torch.tensor([prompt]),
                                  cache_len=SEQ)
        out = [int(torch.argmax(logits[0, -1]))]
        for pos in range(len(prompt), len(prompt) + NEW - 1):
            logits, cache = T.decode_step(cfg, params, cache, pos,
                                          token=torch.tensor([[out[-1]]]))
            out.append(int(torch.argmax(logits[0, 0])))
    return out


def test_every_span_sits_on_its_thread_and_counts_its_jobs():
    cfg, params = _plan()
    tokens, issued, spans, threads = _serve(cfg, params, traced=True)
    executors = threads["member"] | threads["parity"]
    where = {"repro_torch.lm.job.prefill": threads["member"],
             "repro_torch.lm.job.rebuild": threads["parity"],
             "repro_torch.lm.job.decode": executors,
             "repro_torch.lm.sync": executors,
             "repro_torch.lm.admit.prefill": threads["scheduler"],
             "repro_torch.lm.admit.rebuild": threads["scheduler"]}
    assert set(spans) == set(where)
    for name, tids in where.items():
        assert {t for _, _, t in spans[name]} <= tids, name
    assert {t for _, _, t in spans["repro_torch.lm.job.decode"]} == executors
    # a job span per issued job, of its kind
    for kind in ("prefill", "rebuild", "decode"):
        n = sum(1 for job in issued if job[1] == kind)
        assert len(spans["repro_torch.lm.job." + kind]) == n, kind
    # one prefill job per admission, one rebuild span per rebuilt column
    # (r = 1: one job each), each job inside its scheduler span
    assert len(spans["repro_torch.lm.job.prefill"]) == len(PROMPTS)
    assert len(spans["repro_torch.lm.admit.rebuild"]) == \
        len(spans["repro_torch.lm.job.rebuild"]) >= 1
    for kind in ("prefill", "rebuild"):
        for job in spans["repro_torch.lm.job." + kind]:
            assert _inside(job, spans["repro_torch.lm.admit." + kind],
                           same_thread=False), kind
    # every sync inside a job on its thread; a decode's on every executor
    jobs = spans["repro_torch.lm.job.decode"] + \
        spans["repro_torch.lm.job.prefill"]
    for sync in spans["repro_torch.lm.sync"]:
        assert _inside(sync, jobs)
    assert {s[2] for s in spans["repro_torch.lm.sync"]
            if _inside(s, spans["repro_torch.lm.job.decode"])} == executors
    assert tokens == [_loop(cfg, params, p) for p in PROMPTS]


def test_moe_dispatch_spans_in_a_reduced_moe_forward():
    cfg = get_config("deepseek-moe-16b", reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    n_moe = sum(s["ffn"] == "moe" for s in T.layer_plan(cfg)) * \
        cfg.n_layers // len(T.layer_plan(cfg))
    with _profile() as prof, torch.inference_mode():
        T.prefill(cfg, params, tokens=torch.tensor([[1, 2, 3, 4, 5]]),
                  cache_len=8)
    spans = _spans(prof)
    # routing, scatter and gather in each MoE layer
    assert n_moe >= 1
    assert len(spans["repro_torch.moe.dispatch"]) == 3 * n_moe


def test_without_a_profiler_span_is_the_shared_no_op():
    assert trace.span("repro_torch.x") is trace.span("repro_torch.y")
    with trace.span("repro_torch.x") as got:
        assert got is None
    with _profile():
        assert trace.span("repro_torch.x") is not trace.span("repro_torch.x")
    assert trace.span("repro_torch.x") is trace._OFF
    cfg, params = _plan()
    tokens, _, spans, _ = _serve(cfg, params, traced=False)
    assert spans is None
    assert tokens == [_loop(cfg, params, p) for p in PROMPTS]
