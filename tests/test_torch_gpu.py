"""The CUDA kernels of ``repro_torch`` against their plain PyTorch versions,
on the card.  Every test here needs an NVIDIA GPU and the CUDA toolkit: it is
marked ``gpu`` and skips (with its reason) where ``torch.cuda`` is not
available.  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: fp32 2e-5, bf16 2e-2; the fused kernel scaled by sqrt(F*k),
decodes by k, the projection kernel (B5, B6) by 4, the attention kernels
(B7, B8) bf16 3e-2, as in the reference's ``tests/test_kernels.py``."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _tol(dt):
    return 2e-2 if dt == torch.bfloat16 else 2e-5


def _close(got, want, atol, rtol):
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("k,B,F", [(2, 1, 784), (4, 8, 1000), (6, 2, 257)])
def test_parity_encode_kernel(cuda, k, B, F, dt):
    q = torch.randn((k, B, F), generator=cuda, device="cuda").to(dt)
    c = torch.arange(1.0, k + 1.0, device="cuda")
    before = ops.counters()["parity_encode"].value
    got = ops.parity_encode_op(q, c)
    assert ops.counters()["parity_encode"].value == before + 1
    _close(got, ref.parity_encode_ref(q, c), _tol(dt), _tol(dt))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("k,B,V", [(2, 1, 10), (3, 8, 513)])
def test_parity_decode_kernel(cuda, k, B, V, dt):
    outs = torch.randn((k, B, V), generator=cuda, device="cuda").to(dt)
    par = torch.randn((B, V), generator=cuda, device="cuda").to(dt)
    c = np.arange(1.0, k + 1.0, dtype=np.float32)       # host coefficients
    for j in range(k):
        avail = torch.tensor(c * (np.arange(k) != j), device="cuda")
        _close(ops.parity_decode_op(par, outs, j, coeffs=c),
               ref.parity_decode_ref(par, outs, avail, 1.0 / float(c[j])),
               _tol(dt) * k, 2e-2)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_parity_decode_kernel_host_coeffs(cuda, k, dt):
    """B3 with non-unit numpy coefficients, every missing index: one
    launch per call, held against the plain version."""
    rng = np.random.default_rng(k)
    c = rng.uniform(0.5, 2.0, k).astype(np.float32) * \
        rng.choice([-1.0, 1.0], k).astype(np.float32)
    outs = torch.randn((k, 4, 10), generator=cuda, device="cuda").to(dt)
    par = torch.randn((4, 10), generator=cuda, device="cuda").to(dt)
    cnt = ops.counters()["parity_decode"]
    for j in range(k):
        before = cnt.value
        got = ops.parity_decode_op(par, outs, j, coeffs=c)
        torch.cuda.synchronize()
        assert cnt.value == before + 1
        avail = torch.tensor(c * (np.arange(k) != j), device="cuda")
        _close(got, ref.parity_decode_ref(par, outs, avail,
                                          1.0 / float(c[j])),
               _tol(dt) * k, 2e-2)


def test_parity_decode_rejects_cuda_coeffs(cuda):
    """Coefficients on the card would cost a sync per decode: a CUDA
    coefficient tensor raises instead of being read back."""
    outs = torch.ones((2, 1, 10), device="cuda")
    with pytest.raises(TypeError, match="host"):
        ops.parity_decode_op(outs[0], outs, 0,
                             coeffs=torch.ones(2, device="cuda"))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("G,k,B,V", [(1000, 2, 1, 10), (4, 4, 2, 257)])
def test_multigroup_decode_kernel(cuda, G, k, B, V, dt):
    po = torch.randn((G, B, V), generator=cuda, device="cuda").to(dt)
    outs = torch.randn((G, k, B, V), generator=cuda, device="cuda").to(dt)
    idxs = torch.arange(G, device="cuda") % k
    c = torch.arange(1.0, k + 1.0, device="cuda")
    cg = c[None].expand(G, k)
    avail = cg * (torch.arange(k, device="cuda")[None] != idxs[:, None])
    cmat = torch.cat([avail, 1.0 / torch.gather(cg, 1, idxs[:, None])], 1)
    _close(ops.multigroup_decode_op(po, outs, idxs, c),
           ref.multigroup_decode_ref(po, outs, cmat), _tol(dt) * k, 2e-2)


FUSED_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("dtx,dtw", FUSED_DTYPES)
@pytest.mark.parametrize("k,r,B,F,V", [(2, 1, 1000, 784, 200),
                                       (4, 2, 1, 129, 64),
                                       (3, 1, 5, 300, 130),
                                       (2, 3, 8, 1024, 257),
                                       (2, 1, 4, 3, 64),      # F < S
                                       (2, 1, 4, 0, 64)])     # F = 0
def test_fused_encode_forward_kernel(cuda, k, r, B, F, V, dtx, dtw):
    """B2 at every edge (ragged F, B and V; unaligned rows; F smaller than
    the cluster; no F at all) in the four dtype pairs, one launch per call;
    the tolerance follows the queries' dtype, the output's."""
    q = torch.randn((k, B, F), generator=cuda, device="cuda").to(dtx)
    C = torch.randn((r, k), generator=cuda, device="cuda")
    W = torch.randn((r, F, V), generator=cuda, device="cuda").to(dtw)
    mul = math.sqrt(max(F, 1) * k)
    cnt = ops.counters()["fused_encode_forward"]
    before = cnt.value
    got = ops.fused_encode_forward_op(q, C, W)
    torch.cuda.synchronize()
    assert cnt.value == before + 1
    assert got.dtype == dtx and tuple(got.shape) == (r, B, V)
    _close(got, ref.fused_encode_forward_ref(q, C, W), _tol(dtx) * mul,
           _tol(dtx) * mul)


@pytest.mark.parametrize("B,V", [(200, 200), (3000, 64), (960, 256),
                                 (1000, 200), (1280, 256), (1600, 256),
                                 (2400, 256), (4000, 200)])
def test_fused_encode_forward_cluster_sizes(cuda, B, V):
    """Shapes whose planned cluster sizes run from 8 down to 1 on an H100:
    the Python plan, fed the card's cluster capacities, picks the kernel's
    own cluster size (``repro_fused_plan``), and the output matches the
    plain version and its model of the kernel's summation order."""
    from repro_torch.kernels import fused_encode_forward as kf
    F = 784
    q = torch.randn((2, B, F), generator=cuda, device="cuda")
    C = torch.randn((1, 2), generator=cuda, device="cuda")
    W = torch.randn((1, F, V), generator=cuda, device="cuda")
    S, clusters = kf.card_plan(q, W)
    assert kf.fused_plan(2, 1, B, F, V, clusters)[2] == S
    got = kf.fused_encode_forward(q, C, W)
    tol = 2e-5 * math.sqrt(F * 2)
    _close(got, ref.fused_encode_forward_ref(q, C, W), tol, tol)
    _close(got, ref.fused_encode_forward_split_ref(q, C, W, S), tol, tol)


def test_fused_encode_forward_is_one_device_operation(cuda):
    """20 wrapper calls at the A_d shape: the counter rises by 20 and the
    profiler sees 20 launches of fused_cluster_kernel and no other device
    operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fused_encode_forward as kf
    q = torch.randn((2, 1000, 784), generator=cuda, device="cuda")
    C = torch.ones((1, 2), device="cuda")
    W = torch.randn((1, 784, 200), generator=cuda, device="cuda")
    kf.fused_encode_forward(q, C, W)
    torch.cuda.synchronize()
    before = kf.launches.value
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            kf.fused_encode_forward(q, C, W)
        torch.cuda.synchronize()
    seen = {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}
    assert kf.launches.value == before + 20
    assert len(seen) == 1 and sum(seen.values()) == 20, seen
    assert "fused_cluster_kernel" in next(iter(seen))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("H,r,B,F", [(8, 1, 4, 512), (16, 3, 2, 257),
                                     (16, 1, 200, 3072), (8, 1, 400, 1536),
                                     (4, 11, 3, 1000)])
def test_learned_project_kernel(cuda, H, r, B, F, dt):
    """B5, including r above the 8 rows one launch row group holds."""
    h = torch.randn((H, B, F), generator=cuda, device="cuda").to(dt)
    w = torch.randn((H, r), generator=cuda, device="cuda")
    before = ops.counters()["learned_project"].value
    got = ops.learned_project_op(h, w)
    torch.cuda.synchronize()
    assert ops.counters()["learned_project"].value == before + 1
    _close(got, ref.learned_project_ref(h, w), _tol(dt) * 4, _tol(dt) * 4)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("k,r,B,F", [(2, 1, 200, 3072), (2, 2, 200, 3072),
                                     (3, 2, 4, 130), (2, 1, 1, 3072)])
def test_berrut_encode_kernel(cuda, k, r, B, F, dt):
    """B6: B5's kernel with W = C^T, counted under its own name."""
    q = torch.randn((k, B, F), generator=cuda, device="cuda").to(dt)
    c = torch.randn((r, k), generator=cuda, device="cuda")
    cnt = ops.counters()
    before = (cnt["berrut_encode"].value, cnt["learned_project"].value)
    got = ops.berrut_encode_op(q, c)
    torch.cuda.synchronize()
    assert (cnt["berrut_encode"].value,
            cnt["learned_project"].value) == (before[0] + 1, before[1])
    _close(got, ref.learned_project_ref(q, c.T), _tol(dt) * 4, _tol(dt) * 4)


# B7 / B8: tolerance 2e-5 in fp32 and 3e-2 in bf16, as the reference's
# attention kernel tests
def _attn_tol(dt):
    return 3e-2 if dt == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,dt", [
    (2, 128, 128, 4, 2, 64, True, 0, torch.float32),
    (1, 256, 256, 4, 4, 64, True, 64, torch.float32),
    (2, 100, 100, 2, 1, 32, False, 0, torch.float32),
    (1, 128, 128, 8, 2, 128, True, 0, torch.bfloat16),
    (1, 1000, 1000, 14, 2, 64, True, 0, torch.bfloat16),
    (3, 33, 47, 6, 3, 128, False, 16, torch.float32),
    (1, 1, 1, 14, 2, 64, True, 0, torch.bfloat16),
    (2, 70, 70, 4, 2, 32, True, 5, torch.bfloat16),
])
def test_flash_attention_kernel(cuda, B, Sq, Sk, H, KV, hd, causal, window,
                                dt):
    """B7, with ragged Sq / Sk edges, a window and one-token prompts."""
    q = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda").to(dt)
    k = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(dt)
    v = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(dt)
    before = ops.counters()["flash_attention"].value
    got = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.counters()["flash_attention"].value == before + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window), _attn_tol(dt), 0.0)


# the tensor-core route (bf16): prompt lengths around the 64-row query and
# key tiles and the longest LM prompt, at hd 32 / 64 / 128 (rep 7)
_WGMMA_CASES = [(1, S, S, 14, 2, hd, True, 0)
                for hd in (32, 64, 128)
                for S in (1, 63, 64, 65, 127, 129, 910)] + [
    (1, 100, 300, 4, 2, 64, False, 0),     # non-causal, Sk > Sq
    (2, 200, 77, 8, 2, 128, False, 0),     # non-causal, Sk < Sq
    (1, 300, 300, 4, 1, 32, True, 5),      # windows
    (1, 300, 300, 4, 2, 64, True, 64),
    (2, 150, 150, 6, 3, 128, True, 64),
    (3, 130, 130, 3, 3, 64, True, 0),      # B = 3, rep 1, 3 and 7
    (3, 130, 130, 9, 3, 32, True, 0),
    (3, 130, 130, 14, 2, 128, True, 0),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", _WGMMA_CASES)
def test_flash_attention_wgmma_route(cuda, B, Sq, Sk, H, KV, hd, causal,
                                     window):
    """B7's bf16 route (flash_wgmma_kernel): held to 3e-2 against the plain
    version, and counted on the tensor-core route."""
    from repro_torch.kernels import flash_attention as kf
    bf = torch.bfloat16
    q = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda").to(bf)
    k = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(bf)
    v = torch.randn((B, Sk, KV, hd), generator=cuda, device="cuda").to(bf)
    before = (kf.route_launches["wgmma"].value,
              kf.route_launches["simt"].value)
    got = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (kf.route_launches["wgmma"].value,
            kf.route_launches["simt"].value) == (before[0] + 1, before[1])
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window), 3e-2, 0.0)


@pytest.mark.parametrize("B,S,H,KV,hd,pos,dt", [
    (2, 512, 4, 2, 64, 100, torch.float32),
    (1, 1024, 8, 1, 32, 1023, torch.float32),
    (3, 256, 2, 2, 64, 0, torch.float32),
    (2, 384, 4, 4, 128, 200, torch.bfloat16),
    (4, 1280, 14, 2, 64, [300, 1279, 5, 700], torch.bfloat16),
    (3, 16, 4, 2, 64, [2, 9, 5], torch.float32),
    (2, 100, 32, 2, 128, [99, 5000], torch.float32),
    (1, 64, 16, 1, 32, [63], torch.bfloat16),
])
def test_decode_attention_kernel(cuda, B, S, H, KV, hd, pos, dt):
    """B8 with scalar and per-row pos, one and many splits of the sweep, a
    pos past the end of the cache, and rep up to 16."""
    q = torch.randn((B, H, hd), generator=cuda, device="cuda").to(dt)
    kc = torch.randn((B, S, KV, hd), generator=cuda, device="cuda").to(dt)
    vc = torch.randn((B, S, KV, hd), generator=cuda, device="cuda").to(dt)
    before = ops.counters()["decode_attention"].value
    got = ops.decode_attention_op(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert ops.counters()["decode_attention"].value == before + 1
    _close(got, ref.decode_attention_ref(q, kc, vc, pos), _attn_tol(dt), 0.0)


def test_reduced_lm_kernels_match_torch_backend(cuda):
    """Reduced qwen2-0.5b in fp32 on the card: prefill and vector-pos decode
    logits and caches through B7/B8 equal the online-softmax twins within
    2e-4."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2-0.5b", reduced=True)
    params = T.init_params(cfg, 0, device="cuda")
    toks = torch.randint(0, cfg.vocab, (3, 20), generator=cuda,
                         device="cuda")
    out = {}
    cnt = ops.counters()
    before = (cnt["flash_attention"].value, cnt["decode_attention"].value)
    for backend in ("kernels", "torch"):
        c = cfg.replace(attn_backend=backend)
        with torch.inference_mode():
            last, cache = T.prefill(c, params, tokens=toks[:, :12],
                                    cache_len=24)
            pos = torch.tensor([12, 5, 9], device="cuda")
            logits, cache = T.decode_step(c, params, cache, pos,
                                          token=toks[:, 12:13])
        out[backend] = (last, logits, tree_leaves(cache))
    assert cnt["flash_attention"].value == before[0] + cfg.n_layers
    assert cnt["decode_attention"].value == before[1] + cfg.n_layers
    for a, b in zip([*out["kernels"][:2], *out["kernels"][2]],
                    [*out["torch"][:2], *out["torch"][2]]):
        _close(a, b, 2e-4, 2e-4)


# B8's one-launch cluster kernel: a case for each branch of the plan, in
# both dtypes, on the card's own cluster size and on 8 and 16 forced
_B8_PLAN_CASES = [
    (1, 8, 4, 2, 32, 0),                        # S below one chunk, pos 0
    (2, 40, 8, 2, 64, [39, 100]),               # pos past S
    (2, 64, 16, 1, 128, [63, 1]),               # rep 16 at hd 128
    (1, 8192, 16, 1, 128, 8191),                # one cluster, many tiles
    (1, 8192, 7, 1, 64, 5000),
    (4, 1280, 14, 2, 64, [300, 1279, 517, 1031]),   # the LM path's shape
]


@pytest.mark.parametrize("cluster", [None, 8, 16])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd,pos", _B8_PLAN_CASES)
def test_decode_attention_cluster_plan(cuda, monkeypatch, B, S, H, KV, hd,
                                       pos, dt, cluster):
    """B8 against its plain version at each branch of the cluster plan, on
    the route its dtype picks (bf16: mma, fp32: simt)."""
    from repro_torch.kernels import decode_attention as kd
    if cluster is not None:
        monkeypatch.setattr(kd, "cluster_size", lambda *_: cluster)
    q = torch.randn((B, H, hd), generator=cuda, device="cuda").to(dt)
    kc = torch.randn((B, S, KV, hd), generator=cuda, device="cuda").to(dt)
    vc = torch.randn((B, S, KV, hd), generator=cuda, device="cuda").to(dt)
    route = kd.route_launches[kd.ROUTES[dt]]
    before = (kd.launches.value, route.value)
    got = ops.decode_attention_op(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert (kd.launches.value, route.value) == (before[0] + 1, before[1] + 1)
    _close(got, ref.decode_attention_ref(q, kc, vc, pos), _attn_tol(dt), 0.0)


def test_decode_attention_is_one_device_operation(cuda):
    """20 wrapper calls at the LM path's shape: the counter rises by 20 and
    the profiler sees 20 launches of decode_cluster_kernel and no other
    device operation (no combine pass, no scratch fill)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as kd
    bf = torch.bfloat16
    q = torch.randn((4, 14, 64), generator=cuda, device="cuda").to(bf)
    kc = torch.randn((4, 1280, 2, 64), generator=cuda, device="cuda").to(bf)
    vc = torch.randn((4, 1280, 2, 64), generator=cuda, device="cuda").to(bf)
    pos = torch.tensor([300, 1279, 517, 1031], dtype=torch.int32,
                       device="cuda")
    kd.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    before = kd.launches.value
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            kd.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
    seen = {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}
    assert kd.launches.value == before + 20
    assert len(seen) == 1 and sum(seen.values()) == 20, seen
    assert "decode_cluster_kernel" in next(iter(seen))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("H,r,B,F", [(1, 1, 3, 7), (1, 3, 5, 333),
                                     (40, 3, 2, 1001), (40, 9, 2, 1001),
                                     (3, 9, 5, 333), (16, 1, 200, 3072)])
@pytest.mark.parametrize("aligned", [True, False])
def test_project_kernel_edges(cuda, H, r, B, F, dt, aligned):
    """B5's kernel where n = B*F is not a multiple of the 16-byte vector (4
    fp32, 8 bf16), with one and with 40 input rows, 3 and 9 output rows (two
    row groups), and on a view whose data pointer is not 16-byte aligned."""
    n = H * B * F
    flat = torch.randn((n + 1,), generator=cuda, device="cuda").to(dt)
    h = (flat[:n] if aligned else flat[1:]).view(H, B, F)
    w = torch.randn((H, r), generator=cuda, device="cuda")
    before = ops.counters()["learned_project"].value
    got = ops.learned_project_op(h, w)
    torch.cuda.synchronize()
    assert ops.counters()["learned_project"].value == before + 1
    _close(got, ref.learned_project_ref(h, w), _tol(dt) * 4, _tol(dt) * 4)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,hd,block", [
    (1, 1024, 14, 2, 64, 1024),          # qwen2-0.5b's training prefill
    (2, 300, 4, 2, 32, 128),             # three KV blocks, the last ragged
])
def test_flash_core_backward_on_the_card(cuda, B, S, H, KV, hd, block, dt):
    """The block scan's custom VJP (plain torch on CUDA tensors) against
    autograd through B7's plain version (naive softmax attention) on the
    same inputs in fp32: fp32 within 2e-4, bf16 within 3e-2 (the bf16
    attention tolerance)."""
    from repro_torch.models import layers as L
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(dt)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    cot = torch.randn((B, S, H, hd), generator=cuda, device="cuda")
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = L.flash_attention_xla(*ins, block=block)
    got = torch.autograd.grad((out.float() * cot).sum(), ins)
    ins32 = [t.float().requires_grad_(True) for t in (q, k, v)]
    want_out = ref.flash_attention_ref(*ins32)
    want = torch.autograd.grad((want_out * cot).sum(), ins32)
    tol = 2e-4 if dt == torch.float32 else 3e-2
    _close(out, want_out, tol, tol)
    for g, w in zip(got, want):
        assert g.dtype == dt
        _close(g, w, tol, tol)


def test_parity_train_step_on_the_card_lowers_the_loss(cuda):
    """Reduced qwen2-0.5b (fp32) on the card: the teacher's logits come
    through the flash kernel (B7) under no_grad, and 20 distillation steps
    on one batch bring the MSE below 0.7x its first value."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.training.optim import AdamConfig, adam_init
    from repro_torch.training.train_lib import make_parity_train_step
    cfg = get_config("qwen2-0.5b", reduced=True)
    deployed = T.init_params(cfg, 0, device="cuda")
    parity = T.init_params(cfg, 1, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 4, 32), generator=cuda,
                         device="cuda")
    before = ops.counters()["flash_attention"].value
    with torch.no_grad():
        batch = {"embeds": torch.stack([T.embed_tokens(cfg, deployed, t)
                                        for t in toks]),
                 "teacher": torch.stack([T.forward(cfg, deployed,
                                                   tokens=t)[0]
                                         for t in toks])}
    assert ops.counters()["flash_attention"].value == \
        before + 2 * cfg.n_layers
    opt = AdamConfig(lr=3e-3)
    step = make_parity_train_step(cfg, opt, remat=True)
    state = adam_init(parity, opt)
    losses = []
    for _ in range(20):
        parity, state, m = step(parity, state, batch)
        losses.append(float(m["loss"]))
    assert ops.counters()["flash_attention"].value == \
        before + 2 * cfg.n_layers             # training never launched B7
    assert all(np.isfinite(losses)) and losses[-1] < 0.7 * losses[0], losses


@pytest.mark.parametrize("dt", DTYPES)
def test_ops_refuse_a_gradient_on_the_card(cuda, dt):
    """On CUDA tensors too, an op asked for a gradient raises before it
    launches anything."""
    q = torch.randn((1, 64, 4, 32), generator=cuda, device="cuda").to(dt)
    kv = torch.randn((1, 64, 2, 32), generator=cuda, device="cuda").to(dt)
    before = {n: c.value for n, c in ops.counters().items()}
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_op(q.requires_grad_(True), kv, kv)
    x = torch.randn((2, 3, 8), generator=cuda, device="cuda").to(dt)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.parity_encode_op(x.requires_grad_(True), [1.0, 1.0])
    assert {n: c.value for n, c in ops.counters().items()} == before


def test_ops_refuse_a_dtensor_on_the_card(cuda):
    """A DTensor on the card's one-device mesh (one NCCL rank) handed to a
    kernel op raises before anything launches."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import card_world, make_test_mesh
    q = torch.randn((1, 64, 4, 32), generator=cuda, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn((1, 64, 2, 32), generator=cuda, device="cuda").to(
        torch.bfloat16)
    x = torch.randn((2, 3, 8), generator=cuda, device="cuda")
    before = {n: c.value for n, c in ops.counters().items()}
    with card_world():
        mesh = make_test_mesh((1, 1), device_type="cuda")

        def dt(t):
            return DTensor.from_local(t, mesh, [Replicate(), Replicate()])
        with torch.no_grad():
            with pytest.raises(RuntimeError, match="takes no DTensor"):
                ops.flash_attention_op(dt(q), kv, kv)
            with pytest.raises(RuntimeError, match="takes no DTensor"):
                ops.decode_attention_op(dt(q[:, 0]), kv, kv, 3)
            with pytest.raises(RuntimeError, match="takes no DTensor"):
                ops.parity_encode_op(dt(x), [1.0, 1.0])
    assert {n: c.value for n, c in ops.counters().items()} == before


# --------------------------------------------------------------------------
# the MoE / SSM / hybrid stacks and B7 / B8 at deepseek-moe-16b's attention
# (16 heads over 16 KV heads, rep 1, head_dim 128)
# --------------------------------------------------------------------------
def test_flash_attention_at_deepseek_heads(cuda):
    """B7 on the tensor-core route at q/k/v [1, 128, 16, 128] bf16,
    causal."""
    from repro_torch.kernels import flash_attention as kf
    q, k, v = (torch.randn((1, 128, 16, 128), generator=cuda,
                           device="cuda").bfloat16() for _ in range(3))
    before = kf.route_launches["wgmma"].value
    got = ops.flash_attention_op(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kf.route_launches["wgmma"].value == before + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=True), 3e-2, 0.0)


@pytest.mark.parametrize("pos", [[0, 255, 100, 17], 200])
def test_decode_attention_at_deepseek_heads(cuda, pos):
    """B8 on the mma route at q [4, 16, 128], caches [4, 256, 16, 128]
    bf16 (rep 1: one of the 16 rows of each mma tile)."""
    from repro_torch.kernels import decode_attention as kd
    q = torch.randn((4, 16, 128), generator=cuda, device="cuda").bfloat16()
    kc, vc = (torch.randn((4, 256, 16, 128), generator=cuda,
                          device="cuda").bfloat16() for _ in range(2))
    before = kd.route_launches["mma"].value
    got = ops.decode_attention_op(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert kd.route_launches["mma"].value == before + 1
    _close(got, ref.decode_attention_ref(q, kc, vc, pos), 3e-2, 0.0)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-1.5-large-398b",
                                  "mamba2-780m"])
def test_reduced_hybrid_models_on_the_card_match_the_cpu(cuda, arch):
    """Reduced MoE, hybrid and SSM models in fp32: forward logits and aux,
    prefill, and two vector-pos decode steps on the card (through B7 / B8
    where the plan has attention) against the same parameters on the CPU,
    within 2e-4; every cache leaf too."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.models import transformer as T
    cfg = get_config(arch, reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (3, 20),
                         generator=torch.Generator().manual_seed(0))
    cnt = ops.counters()
    before = (cnt["flash_attention"].value, cnt["decode_attention"].value)
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda x: x.to(dev), params)
        t = toks.to(dev)
        with torch.inference_mode():
            full, aux = T.forward(cfg, p, tokens=t)
            last, cache = T.prefill(cfg, p, tokens=t[:, :12], cache_len=24)
            steps = []
            for j in range(2):
                pos = torch.tensor([12, 12, 12], device=dev) + j
                logits, cache = T.decode_step(cfg, p, cache, pos,
                                              token=t[:, 12 + j:13 + j])
                steps.append(logits)
        out[dev] = [full, aux, last, *steps, *tree_leaves(cache)]
    n_attn = sum(s["mixer"] == "attn" for s in T.layer_plan(cfg)) * \
        cfg.n_groups
    assert cnt["flash_attention"].value == before[0] + 2 * n_attn
    assert cnt["decode_attention"].value == before[1] + 2 * n_attn
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(a.cpu(), b, 2e-4, 2e-4)


# --------------------------------------------------------------------------
# the cross-attention and encoder-decoder plans, and B7 / B8 at their heads:
# llama-3.2-vision-11b (32 heads over 8 KV heads, rep 4, head_dim 128) and
# seamless-m4t-medium (16 over 16, head_dim 64)
# --------------------------------------------------------------------------
CROSS_HEADS = [(32, 8, 128), (16, 16, 64)]


@pytest.mark.parametrize("H,KV,hd", CROSS_HEADS)
def test_flash_attention_at_cross_path_heads(cuda, H, KV, hd):
    """B7 on the tensor-core route at q [1, 256, H, hd], k/v [1, 256, KV,
    hd] bf16, causal."""
    from repro_torch.kernels import flash_attention as kf
    q = torch.randn((1, 256, H, hd), generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn((1, 256, KV, hd), generator=cuda,
                        device="cuda").bfloat16() for _ in range(2))
    before = kf.route_launches["wgmma"].value
    got = ops.flash_attention_op(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kf.route_launches["wgmma"].value == before + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=True), 3e-2, 0.0)


@pytest.mark.parametrize("H,KV,hd,S,pos", [
    (32, 8, 128, 1280, [300, 1279, 517, 0]),
    (16, 16, 64, 512, [37, 511, 270, 100])])
def test_decode_attention_at_cross_path_heads(cuda, H, KV, hd, S, pos):
    """B8 on the mma route at the serving pools of the cross path: q [4, H,
    hd], caches [4, S, KV, hd] bf16, per-row positions."""
    from repro_torch.kernels import decode_attention as kd
    q = torch.randn((4, H, hd), generator=cuda, device="cuda").bfloat16()
    kc, vc = (torch.randn((4, S, KV, hd), generator=cuda,
                          device="cuda").bfloat16() for _ in range(2))
    before = kd.route_launches["mma"].value
    got = ops.decode_attention_op(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert kd.route_launches["mma"].value == before + 1
    _close(got, ref.decode_attention_ref(q, kc, vc, pos), 3e-2, 0.0)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_reduced_cross_models_on_the_card_match_the_cpu(cuda, arch):
    """Reduced VLM and encoder-decoder models in fp32: forward logits,
    prefill (cross K/V included), and two vector-pos decode steps on the
    card against the same parameters and context on the CPU, within 2e-4;
    B7 and B8 launch only for the decoder's causal self attention (none
    for cross attention or the encoder)."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.models import transformer as T
    cfg = get_config(arch, reduced=True)
    params = T.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (3, 20), generator=gen)
    n_ctx = 20 if cfg.enc_dec else cfg.n_modality_tokens
    ctx = 0.5 * torch.randn((3, n_ctx, cfg.d_model), generator=gen)
    cnt = ops.counters()
    before = (cnt["flash_attention"].value, cnt["decode_attention"].value)
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda x: x.to(dev), params)
        t, c = toks.to(dev), ctx.to(dev)
        with torch.inference_mode():
            full, _ = T.forward(cfg, p, tokens=t, cross_embeds=c)
            last, cache = T.prefill(cfg, p, tokens=t[:, :12], cross_embeds=c,
                                    cache_len=24)
            steps = []
            for j in range(2):
                pos = torch.tensor([12, 12, 12], device=dev) + j
                logits, cache = T.decode_step(cfg, p, cache, pos,
                                              token=t[:, 12 + j:13 + j])
                steps.append(logits)
        out[dev] = [full, last, *steps, *tree_leaves(cache)]
    n_attn = sum(s["mixer"] == "attn" for s in T.layer_plan(cfg)) * \
        cfg.n_groups
    assert cnt["flash_attention"].value == before[0] + 2 * n_attn
    assert cnt["decode_attention"].value == before[1] + 2 * n_attn
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(a.cpu(), b, 2e-4, 2e-4)
