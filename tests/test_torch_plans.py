"""The four LM plans that ``chip_smoke.py`` phase 15 serves on the card
(smollm-135m, olmo-1b, qwen3-4b, qwen3-moe-235b-a22b) against the JAX
package, on the CPU.

- The three dense plans at ``reduced()``: ``forward``, ``prefill`` and four
  ``decode_step``s (scalar and [B] pos), logits and caches, against the
  reference at 2e-5 (fp32; the comparison of
  ``test_torch_hybrid_lm.py::test_forward_prefill_decode_match_reference``).
- All four plans at reduced widths but with their full head layout (the
  query heads, KV heads and head_dim of the full config, replaced alike in
  both packages' configs): 9 over 3 at hd 64 (rep 3), 16 over 16 at hd 128
  (non-parametric LayerNorm, MHA), 32 over 8 at hd 128 (qk-norm), 64 over 4
  at hd 128 (rep 16, qk-norm, MoE).  ``reduced()`` clamps every plan to 4
  heads over 2, so only these cases take B7 and B8 through a whole model at
  those layouts.  The port's "kernels" backend (B7 and B8's plain versions
  on the CPU) against the reference's "pallas" backend (its kernels in
  interpret mode) at 2e-5; and ``deploy_lm``, clean and member 0 late,
  against the uncoded loop (token for token) at rep 3 and rep 16.

The comparisons are the shared helpers of ``test_torch_hybrid_lm.py``; one
torch thread, as ``test_torch_examples.py``.
"""
import pytest
import torch

from test_torch_hybrid_lm import (_model, check_forward_prefill_decode,
                                  check_kernels_vs_pallas,
                                  check_serves_the_loop_tokens)

DENSE = ["smollm-135m", "olmo-1b", "qwen3-4b"]
# the full configs' (n_heads, n_kv_heads, head_dim)
HEADS = {"smollm-135m": (9, 3, 64), "olmo-1b": (16, 16, 128),
         "qwen3-4b": (32, 8, 128), "qwen3-moe-235b-a22b": (64, 4, 128)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Reduced models: one intra-op thread runs them fastest, and keeps them
    fast beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _full_heads(arch):
    """The reduced model of ``arch`` with its full config's head layout."""
    H, KV, hd = HEADS[arch]
    return _model(arch, n_heads=H, n_kv_heads=KV, head_dim=hd)


def test_head_layouts_are_the_full_configs():
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    for arch, heads in HEADS.items():
        for get in (jbase.get_config, tbase.get_config):
            cfg = get(arch)
            assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == \
                heads
        jcfg, tcfg, _, _ = _full_heads(arch)
        assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim) == \
            heads == (jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim)
        assert tcfg.d_model == jcfg.d_model <= 256


@pytest.mark.parametrize("arch", DENSE)
def test_dense_plans_match_reference(arch):
    """Reduced smollm-135m (tied embeddings), olmo-1b (non-parametric
    LayerNorm) and qwen3-4b (qk-norm): forward, prefill and four decode
    steps (scalar and [B] pos) against the reference, logits and caches at
    2e-5."""
    check_forward_prefill_decode(*_model(arch))


@pytest.mark.parametrize("arch", list(HEADS))
def test_full_head_layout_kernels_match_pallas(arch):
    """The plan at its full head layout on the port's "kernels" backend
    (plain B7 / B8) against the reference's "pallas" backend (interpret
    mode): forward, prefill and two decode steps at 2e-5."""
    check_kernels_vs_pallas(*_full_heads(arch))


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b"])
def test_full_head_layout_serves_the_loop_tokens(arch):
    """``deploy_lm`` at rep 3 (hd 64) and at rep 16 (hd 128): clean, every
    stream equals the uncoded loop; member 0 late, its streams rebuilt and
    member 1's equal to the loop."""
    _, tcfg, _, tp = _full_heads(arch)
    check_serves_the_loop_tokens(tcfg, tp)
