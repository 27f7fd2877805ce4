"""Work counts against hand counts, the weight layout against the
port's, and the traffic generator's sizes."""
import json
from pathlib import Path

import pytest
import torch

from portbench.harness import traffic as T, work
from portbench.harness.weights import draw

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_b7_work_by_hand():
    # B=1, S=4, H=2, KV=1, hd=8: 10 causal pairs, 4*8 per pair and head
    flops, nbytes = work.b7_work(1, 4, 4, 2, 1, 8, 2)
    assert flops == 4 * 8 * 2 * 10
    assert nbytes == 2 * 8 * (2 * 4 * 2 + 2 * 4 * 1)
    assert work.causal_pairs(5, window=2) == 3 + 3 * 2


def test_b8_work_counts_only_admitted_rows():
    # pos [0, 3] on S=8: 1 + 4 rows; H=4, KV=2, hd=16, bf16
    flops, nbytes = work.b8_work([0, 3], 8, 4, 2, 16, 2)
    assert flops == 4 * 16 * 4 * 5
    assert nbytes == 2 * (2 * 5 * 2 * 16 + 2 * 2 * 4 * 16) + 4 * 2
    assert work.b8_work([100], 8, 4, 2, 16, 2)[0] == 4 * 16 * 4 * 8


def test_least_time_takes_the_larger_bound():
    assert work.least_s(989e12, 0, "bfloat16") == 1.0
    assert work.least_s(0, 3.35e12, "bfloat16") == 1.0
    assert work.least_s(67e12, 0, "float32") == 1.0


def test_active_params_by_hand_qwen3_4b():
    c = config("qwen3-4b")
    attn = 2560 * 4096 + 2 * 2560 * 1024 + 4096 * 2560
    mlp = 3 * 2560 * 9728
    assert work.active_params(c) == 36 * (attn + mlp) + 2560 * 151936
    assert work.active_params(c) == 4_022_272_000
    # with the untied head and the embedding: 4411.2 M in matrices (the
    # 4411.4 M PERF.md names counts the norm scales too)
    assert round(work.param_count(c) / 1e5) == 44112


def test_active_params_by_hand_deepseek_moe_16b():
    c = config("deepseek-moe-16b")
    attn = 4 * 2048 * 2048
    ffn = 2048 * 64 + (6 + 2) * 3 * 2048 * 1408
    assert work.active_params(c) == 28 * (attn + ffn) + 2048 * 102400
    assert work.active_params(c) == 2_620_915_712
    assert round(work.param_count(c) / 1e7) == 1688     # 16.88 G


@pytest.mark.parametrize("name", ["qwen3-4b", "deepseek-moe-16b"])
def test_mfu_flops_by_hand(name):
    c = config(name)
    hd, H, L = 128, c["n_heads"], c["n_layers"]
    body = 2 * (work.active_params(c) - c["d_model"] * c["vocab"])
    head = 2 * c["d_model"] * c["vocab"]
    P = 1000
    assert work.prefill_flops(c, P) == P * body + head \
        + 4 * hd * H * L * P * (P + 1) // 2
    assert work.decode_flops(c, 1001) == body + head + 4 * hd * H * L * 1001


def test_decode_token_cost_is_the_memory_bound_at_batch_one():
    c = config("qwen3-4b")
    t = work.decode_token_cost(c, batch=1, kv_len=0)
    assert t == pytest.approx(work.param_count(c) * 2 / 3.35e12)


@pytest.mark.parametrize("name", ["qwen3-4b", "deepseek-moe-16b"])
def test_weights_layout_is_the_ports(name):
    from repro_torch.models import transformer
    from portbench.harness.runner import arch_config
    small = dict(config(name), n_layers=2, d_model=64, d_ff=96, vocab=128,
                 n_heads=4, n_kv_heads=2 if name == "qwen3-4b" else 4,
                 head_dim=16, moe_d_ff=32, n_experts=4, dtype="float32")
    if name == "qwen3-4b":
        small.pop("moe_d_ff"), small.pop("n_experts")
    mine = draw(small, 3, torch.device("cpu"))
    theirs = transformer.init_params(arch_config(small), device="meta")

    def flat(t, pre=""):
        if isinstance(t, (dict, tuple)):
            items = t.items() if isinstance(t, dict) else enumerate(t)
            out = {}
            for k, v in items:
                out.update(flat(v, f"{pre}/{k}"))
            return out
        return {pre: (tuple(t.shape), t.dtype)}
    assert flat(mine) == flat(theirs)


def test_weights_repeat_per_seed():
    c = dict(config("qwen3-4b"), n_layers=1, d_model=32, d_ff=48, vocab=64,
             n_heads=2, n_kv_heads=1, head_dim=16, dtype="float32")
    a, b = draw(c, 2 ** 31 + 11, "cpu"), draw(c, 2 ** 31 + 11, "cpu")
    d = draw(c, 2 ** 31 + 12, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], d["embed"])


def test_every_seed_gets_the_same_sizes():
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / "prefill-long-s16.json").read_text())
    sizes = []
    for seed in (1, 2 ** 31 + 5):
        g = T.Generator(mix, seed, 1000)
        block = g.block()
        assert len(block) == mix["clients"]
        sizes.append(([len(r.prompt) for r in block],
                      [r.max_new for r in block]))
        assert all(0 <= t < 1000 for r in block for t in r.prompt)
    assert sorted(sizes[0][0]) == sorted(sizes[1][0])
    assert sorted(sizes[0][1]) == sorted(sizes[1][1])
    assert sizes[0][0] != sizes[1][0]
    lo, hi = mix["prompt_len"]
    assert lo <= min(sizes[0][0]) and max(sizes[0][0]) <= hi
