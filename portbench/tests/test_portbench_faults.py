"""A run of the harness on the CPU at a tiny size, with the timed path
sound and then broken underneath: ``correct`` has to come out false for
each fault a cell of this benchmark can have (a decode step that leaves
its cache unchanged, half of the batch left out, a served token altered,
the parity's input altered), under the tiny limits and, for a tiny MoE in
a closed loop with the cell's output lengths, under the MoE prefill
cell's own limits.  The cells run on one card, so no exchange between
chips can be left out.  The check for a card is skipped: the runner is
called directly."""
import json
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import spec as S
from portbench.harness.runner import run

TINY = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 128,
        "vocab": 512, "qk_norm": True, "rope_theta": 10000.0,
        "tie_embeddings": False, "attn_backend": "kernels",
        "dtype": "float32"}
MOE = dict(TINY, name="tiny-moe", family="moe", n_experts=4,
           n_shared_experts=1, moe_top_k=2, moe_d_ff=64, qk_norm=False)
BASE = {"k": 2, "r": 1, "scheme": "sum", "straggle_ms": 20000,
        "trace_seconds": 1,
        "limits": {"served_gap": 0.05, "parity_gap": 0.05,
                   "parity_rel_err": 0.01, "rebuilt_gap": 0.05}}
LOOP = dict(BASE, kind="closed_loop", slots_per_member=2, clients=4,
            prompt_len=[8, 24], output_len=[3, 6], max_seq_len=40,
            warm_completions=2, check={"requests": 4, "parity_columns": 2})
BATCH = dict(BASE, kind="closed_batch", slots_per_member=2, streams=4,
             prompt_len=[8, 16], max_new=400, max_seq_len=450,
             warm_rounds=1, check={"requests": 3, "parity_columns": 2})


def tiny_run(cfg, traffic, seconds=0.8, control=False):
    torch.manual_seed(0)
    cell = S.Cell(name="tiny", chips=1, config=cfg, traffic=traffic,
                  end_to_end=[{"name": n} for n in (
                      "tokens_per_s", "itl_p95_ms", "setup_s")],
                  per_layer=[{"name": "round_ms"},
                             {"name": "tail_ttft_p90_ms"}], run_seconds=1)
    res = run(cell, 2 ** 31 + 99, seconds, False, "cpu", time.monotonic(),
              control=control)
    correct = all(v <= lim for v, lim in (x for x in res.compared.values()
                                          if isinstance(x, tuple)))
    return correct, res


@pytest.mark.parametrize("cfg,traffic", [(TINY, LOOP), (MOE, BATCH)],
                         ids=["dense-loop", "moe-batch"])
def test_sound_run_is_correct(cfg, traffic):
    correct, res = tiny_run(cfg, traffic)
    assert correct, res.compared
    assert res.info["rebuilt_steps"] == 0
    assert res.compared["checked_columns"] >= 1
    assert res.metrics["tokens_per_s"] > 0


def _stale_cache(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.decode_step

    def decode_step(cfg, params, cache, pos, token=None, embed=None):
        scratch = tuple({k: {n: v.clone() for n, v in d.items()}
                         for k, d in layer.items()} for layer in cache)
        logits, _ = orig(cfg, params, scratch, pos, token=token,
                         embed=embed)
        return logits, cache
    monkeypatch.setattr(T, "decode_step", decode_step)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.decode_step

    def decode_step(cfg, params, cache, pos, token=None, embed=None):
        logits, cache = orig(cfg, params, cache, pos, token=token,
                             embed=embed)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, cache
    monkeypatch.setattr(T, "decode_step", decode_step)


def _altered_token(monkeypatch):
    from repro_torch.serving import generation as G
    orig = G.GenerationFuture._emit

    def emit(self, token, now, reconstructed):
        n = len(self._tokens)
        return orig(self, (int(token) + 1) % 512 if n == 3 else token, now,
                    reconstructed)
    monkeypatch.setattr(G.GenerationFuture, "_emit", emit)


def _parity_input(monkeypatch):
    from repro_torch.serving import generation as G
    orig = G.GenerationSession._encode

    def encode(self, j, embs):     # the code over the first member alone
        first = next(i for i, e in enumerate(embs) if e is not None)
        return orig(self, j, [e if i == first else None
                              for i, e in enumerate(embs)])
    monkeypatch.setattr(G.GenerationSession, "_encode", encode)


@pytest.mark.parametrize("fault", [_stale_cache, _half_batch,
                                   _altered_token, _parity_input],
                         ids=["state-unchanged", "half-batch",
                              "token-altered", "parity-altered"])
def test_each_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    correct, res = tiny_run(TINY, BATCH)
    assert not correct, res.compared


MOE_LIMITS = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                         / "prefill-long-s8.json").read_text())["limits"]
MOE_LOOP = dict(LOOP, output_len=[16, 64], max_seq_len=96,
                limits=MOE_LIMITS)


@pytest.mark.parametrize("fault", [_stale_cache, _half_batch,
                                   _altered_token, _parity_input],
                         ids=["state-unchanged", "half-batch",
                              "token-altered", "parity-altered"])
def test_each_fault_fails_the_moe_prefill_limits(monkeypatch, fault):
    correct, res = tiny_run(MOE, MOE_LOOP)
    assert correct, res.compared
    fault(monkeypatch)
    correct, res = tiny_run(MOE, MOE_LOOP)
    assert not correct, res.compared
