"""The LM slice of the port (configs, attention kernels B7/B8, layers, the
dense transformer, the analytic roofline) against the JAX package, on the
CPU.

The same seeded numpy inputs and parameters go through ``repro`` (the
Pallas kernels in interpret mode, or its "jnp" paths) and ``repro_torch``
(the kernels' plain versions, or the "torch" paths); parameters are carried
across with ``params_from_numpy``.  Tolerances: fp32 2e-5 for kernels and
layers (as ``tests/test_attention_backend.py``), 3e-2 for the bf16 kernel
cases (as ``tests/test_kernels.py``), 2e-3 for model logits (as
``tests/test_prefill_decode.py``); exact for the roofline arithmetic.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.launch import roofline as jroof
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy, params_to_numpy, \
    tree_leaves
from repro_torch.kernels import ops, ref
from repro_torch.launch import roofline as troof
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

F32 = 2e-5
LOGITS = 2e-3


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol, rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else _np(got)
    np.testing.assert_allclose(got, _np(want), atol=atol, rtol=rtol)


def _both(a, dt="float32"):
    """numpy fp32 array -> (jax array, torch tensor) in ``dt``; bf16 rounds
    the same way (to nearest even) on both sides."""
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _cfgs(**kw):
    j = jbase.get_config("qwen2-0.5b", reduced=True)
    t = tbase.get_config("qwen2-0.5b", reduced=True)
    return dataclasses.replace(j, **kw), t.replace(**kw)


def _noisy(tree, seed, scale=0.05):
    """A JAX parameter tree with every leaf perturbed (zero biases and unit
    scales would hide a wiring fault): (jax tree, torch tree)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: _np(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), tree)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


# --------------------------------------------------------------------------
# configs and the bf16 carry-over
# --------------------------------------------------------------------------
def test_configs_equal_the_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.SHAPES.keys() == jbase.SHAPES.keys()
    for name in jbase.SHAPES:
        assert dataclasses.asdict(tbase.SHAPES[name]) == \
            dataclasses.asdict(jbase.SHAPES[name])
    tall, jall = tbase.all_configs(), jbase.all_configs()
    for arch in jbase.ARCH_IDS:
        for t, j in ((tall[arch], jall[arch]),
                     (tall[arch].reduced(), jall[arch].reduced())):
            td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
            assert td.pop("attn_backend") == "kernels"
            assert jd.pop("attn_backend") == "jnp"
            assert td == jd, arch
            props = ["period", "n_groups", "d_inner", "subquadratic",
                     "is_attention_free"] + \
                (["resolved_head_dim"] if j.n_heads else [])
            for prop in props:
                assert getattr(t, prop) == getattr(j, prop), (arch, prop)
    q = tbase.get_config("qwen2-0.5b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.d_ff,
            q.vocab, q.qkv_bias, q.tie_embeddings, q.rope_theta, q.dtype,
            q.source) == (24, 896, 14, 2, 4864, 151936, True, True, 1e6,
                          "bfloat16", "arXiv:2407.10671")


def test_attn_backend_names():
    cfg = tbase.get_config("qwen2-0.5b", reduced=True)
    assert cfg.replace(attn_backend="torch").attn_backend == "torch"
    with pytest.raises(ValueError, match="attn_backend"):
        cfg.replace(attn_backend="jnp")
    with pytest.raises(ValueError, match="attention backend"):
        L.self_attention_fwd(cfg, {}, torch.zeros(1, 1, 1), None,
                             backend="pallas")


def test_bf16_tree_round_trips_bit_exactly():
    """A bf16 JAX tree (the LM configs' dtype) carries over to torch bf16
    and back with every value unchanged."""
    jcfg = jbase.get_config("qwen2-0.5b", reduced=True).replace(
        dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, "cpu")
    leaves = tree_leaves(tp)
    assert leaves and all(x.dtype == torch.bfloat16 for x in leaves)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(tree), tree_leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a.astype(np.float32), b)
    # the layout is the reference's: blocks is a tuple, leaves carry the
    # leading n_groups axis
    assert isinstance(tp["blocks"], tuple)
    assert tp["blocks"][0]["attn"]["wq"].shape[0] == jcfg.n_groups


# --------------------------------------------------------------------------
# B7 / B8: plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,Sq,H,KV,hd,causal,window,dt", [
    (2, 128, 4, 2, 64, True, 0, "float32"),
    (1, 256, 4, 4, 64, True, 64, "float32"),
    (2, 100, 2, 1, 32, False, 0, "float32"),
    (1, 128, 8, 2, 128, True, 0, "bfloat16"),
    # smollm-135m's heads (rep 3, hd 64) and qwen3-moe-235b-a22b's (rep 16,
    # hd 128)
    (1, 128, 9, 3, 64, True, 0, "float32"),
    (1, 128, 9, 3, 64, True, 0, "bfloat16"),
    (1, 128, 64, 4, 128, True, 0, "float32"),
    (1, 128, 64, 4, 128, True, 0, "bfloat16"),
])
def test_flash_attention_plain_vs_pallas(B, Sq, H, KV, hd, causal, window,
                                         dt):
    rng = np.random.default_rng(B * 7 + Sq)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, KV, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dt), _both(k, dt), _both(v, dt)
    want = jops.flash_attention_op(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention_op(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    _close(got, want, 3e-2 if dt == "bfloat16" else F32)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (2, 128, 128, 4, 2, 64, True, 0), (1, 256, 256, 4, 4, 64, True, 64),
    (2, 100, 100, 2, 1, 32, False, 0), (1, 128, 128, 8, 2, 128, True, 0),
    (3, 33, 47, 6, 3, 128, False, 16), (2, 70, 70, 4, 2, 32, True, 5),
    (1, 1, 1, 14, 2, 64, True, 0), (1, 256, 256, 9, 3, 64, True, 0),
    (1, 256, 256, 64, 4, 128, True, 0),
])
def test_flash_attention_bf16p_vs_pallas(B, Sq, Sk, H, KV, hd, causal,
                                         window):
    """The tensor-core route rounds P to bf16 before P.V: a plain copy with
    that rounding meets the bf16 tolerance (3e-2) against the Pallas kernel
    on the sweep shapes, so the tolerance is known to hold before the
    card."""
    rng = np.random.default_rng(B * 7 + Sq + Sk)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "bfloat16") for x in (q, k, v))
    want = jops.flash_attention_op(jq, jk, jv, causal=causal, window=window)
    got = ref.flash_attention_bf16p_ref(tq, tk, tv, causal=causal,
                                        window=window)
    assert got.dtype == torch.bfloat16
    _close(got, want, 3e-2)


@pytest.mark.parametrize("B,S,H,KV,hd,pos,dt", [
    (2, 512, 4, 2, 64, 100, "float32"),
    (1, 1024, 8, 1, 32, 1023, "float32"),
    (3, 256, 2, 2, 64, 0, "float32"),
    (2, 384, 4, 4, 128, 200, "bfloat16"),
    # smollm-135m's heads (rep 3, hd 64) and qwen3-moe-235b-a22b's (rep 16,
    # hd 128)
    (2, 384, 9, 3, 64, 200, "float32"),
    (2, 384, 9, 3, 64, 200, "bfloat16"),
    (2, 256, 64, 4, 128, 100, "float32"),
    (2, 256, 64, 4, 128, 100, "bfloat16"),
])
def test_decode_attention_plain_vs_pallas(B, S, H, KV, hd, pos, dt):
    rng = np.random.default_rng(S + pos)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dt), _both(kc, dt), \
        _both(vc, dt)
    want = jops.decode_attention_op(jq, jk, jv, pos)
    got = ops.decode_attention_op(tq, tk, tv, pos)
    _close(got, want, 3e-2 if dt == "bfloat16" else F32)


# the shapes of the chip smoke test's B8 sweep: scalar and per-row pos, a pos
# past the cache, rep up to 16, hd 32 / 64 / 128; the last two a full serving
# pool at smollm-135m's heads (rep 3, hd 64) and qwen3-moe-235b-a22b's (rep
# 16, hd 128: the mma tile's 16 rows all real)
_B8_SHAPES = [
    (2, 512, 4, 2, 64, 100), (1, 1024, 8, 1, 32, 1023),
    (3, 256, 2, 2, 64, 0), (2, 384, 4, 4, 128, 200),
    (1, 1024, 8, 1, 32, 0), (3, 256, 2, 2, 64, 255),
    (3, 16, 4, 2, 64, (2, 9, 5)), (2, 100, 32, 2, 128, (99, 5000)),
    (4, 1280, 14, 2, 64, (300, 1279, 5, 700)),
    (4, 1280, 9, 3, 64, (300, 1279, 517, 1031)),
    (4, 1280, 64, 4, 128, (300, 1279, 517, 1031)),
]
_b8_pallas = {}


def _b8_case(shape, dt):
    """Seeded inputs of a B8 sweep shape as torch tensors in ``dt``, and the
    JAX package's Pallas kernel (interpret mode) on the same values, computed
    once per (shape, dtype); its key blocks must tile S (it reads past S
    otherwise), so S = 1280 takes blocks of 256 instead of 512."""
    B, S, H, KV, hd, pos = shape
    rng = np.random.default_rng(S + H + hd)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in arrays)
    if (shape, dt) not in _b8_pallas:
        jpos = jnp.asarray(pos, jnp.int32)
        block_k = S if S <= 512 else math.gcd(S, 512)
        _b8_pallas[shape, dt] = _np(jops.decode_attention_op(
            jq, jk, jv, jpos, block_k=block_k))
    return tq, tk, tv, pos, _b8_pallas[shape, dt]


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _B8_SHAPES, ids=str)
def test_decode_attention_models_vs_pallas(shape, dt, cluster):
    """The CPU models of the one-launch B8: its split-and-combine over the
    cluster plan's CTA ranges (with P rounded to bf16 on the bf16 route) and,
    in bf16, the P-rounding model alone, held against the JAX package's
    Pallas kernel and the plain version: fp32 at 2e-5, bf16 at 3e-2."""
    from repro_torch.kernels import decode_attention as kd
    q, kc, vc, pos, want = _b8_case(shape, dt)
    B, S = q.shape[0], kc.shape[1]
    pos_b = np.broadcast_to(np.asarray(pos), (B,))
    splits = [kd.cta_slots(min(int(p) + 1, S), cluster) for p in pos_b]
    bf16 = dt == "bfloat16"
    tol = 3e-2 if bf16 else F32
    plain = ref.decode_attention_ref(q, kc, vc, pos).float()
    models = [ref.decode_attention_split_ref(q, kc, vc, pos, splits,
                                             bf16_p=bf16)]
    if bf16:
        models.append(ref.decode_attention_bf16p_ref(q, kc, vc, pos))
    for got in models:
        assert got.dtype == q.dtype and got.shape == q.shape
        _close(got, want, tol)
        _close(got, plain, tol)


@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_decode_cluster_plan_covers_each_slot_once(cluster):
    """Every slot j < n_valid is taken by exactly one CTA of the cluster,
    every range starts on a 16-slot chunk, and no CTA reads past pos."""
    from repro_torch.kernels import decode_attention as kd
    for n_valid in [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 300, 301,
                    1000, 1280, 4096, 8191, 8192]:
        ranges = kd.cta_slots(n_valid, cluster)
        assert len(ranges) == cluster
        seen = np.zeros(n_valid, int)
        for begin, end in ranges:
            assert 0 <= begin <= end <= n_valid
            assert begin % kd.CHUNK == 0 or begin == n_valid
            seen[begin:end] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("B,KV", [(4, 2), (1, 1), (3, 5)])
def test_decode_cluster_plan_grid(B, KV):
    """The cluster size is at most 16 and divides the grid's x extent; the
    card's decision takes 16 only where it holds as many CTAs in clusters
    of 16 as in clusters of 8."""
    from repro_torch.kernels import decode_attention as kd
    for cluster in (8, 16):
        grid = kd.cluster_plan(B, KV, cluster)
        assert grid == (cluster, KV, B) and grid[0] % cluster == 0
        assert cluster <= 16
    for bad in (0, 17, 32):
        with pytest.raises(ValueError, match="cluster size"):
            kd.cluster_plan(B, KV, bad)
    assert kd.choose_cluster({16: 8, 8: 16}) == 16
    assert kd.choose_cluster({16: 7, 8: 16}) == 8
    assert kd.choose_cluster({16: 0, 8: 16}) == 8
    with pytest.raises(RuntimeError, match="no cluster"):
        kd.choose_cluster({16: 0, 8: 0})


@pytest.mark.parametrize("H,KV,hd", [(4, 2, 48), (4, 2, 256), (17, 1, 64),
                                     (34, 2, 64), (6, 4, 64)])
def test_decode_attention_wrapper_limits_raise(H, KV, hd):
    """hd outside (32, 64, 128), rep above 16 or H not a multiple of KV
    raise before anything reaches the card."""
    from repro_torch.kernels import decode_attention as kd
    q = torch.zeros((2, H, hd))
    kc = torch.zeros((2, 8, KV, hd))
    with pytest.raises(ValueError, match="hd in"):
        kd.decode_attention(q, kc, kc, torch.zeros(2, dtype=torch.int32))


def test_decode_attention_vector_pos_against_decode_xla():
    """A [B] pos masks each row by its own position: held against the JAX
    package's ``attention_decode_xla`` (its oracle ``decode_attention_ref``
    broadcasts a vector pos along the wrong axis)."""
    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 3, 40, 4, 2, 32
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    want = JL.attention_decode_xla(jnp.asarray(q)[:, None], jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos))[:, 0]
    for p in (pos, torch.tensor(pos), list(pos)):
        _close(ops.decode_attention_op(torch.tensor(q), torch.tensor(kc),
                                       torch.tensor(vc), p), want, F32)
    # row b of a vector call == a scalar call on row b alone
    for b in range(B):
        _close(ref.decode_attention_ref(torch.tensor(q[b:b + 1]),
                                        torch.tensor(kc[b:b + 1]),
                                        torch.tensor(vc[b:b + 1]),
                                        int(pos[b]))[0], want[b], F32)


def test_decode_attention_ring_buffer_equivalence():
    """The kernel takes no window: with a ring buffer of S slots, its mask
    kpos <= pos equals the decode path's kpos < min(pos + 1, S), also once
    pos has run past S."""
    rng = np.random.default_rng(8)
    B, S, H, KV, hd = 4, 16, 4, 2, 32
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.array([3, 15, 16, 40], np.int32)
    want = JL.attention_decode_xla(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos),
                                   window=S)
    tq, tk, tv = map(torch.tensor, (q, kc, vc))
    _close(ops.decode_attention_op(tq[:, 0], tk, tv, pos), want[:, 0], F32)
    _close(L.attention_decode_xla(tq, tk, tv, torch.tensor(pos), window=S),
           want, F32)


def test_flash_attention_plain_matches_block_scan():
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = 2, 96, 4, 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    a = ops.flash_attention_op(tq, tk, tv, causal=True)
    b = L.flash_attention_xla(tq, tk, tv, causal=True, block=32)
    _close(a, b, F32)
    _close(b, JL.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, block=32),
           F32)


# --------------------------------------------------------------------------
# layers.py, both port backends against JAX "jnp" and "pallas"
# --------------------------------------------------------------------------
def test_norms_and_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    _close(L.rms_norm(tx, torch.tensor(scale)),
           JL.rms_norm(jx, jnp.asarray(scale)), F32)
    _close(L.rms_norm(tx), JL.rms_norm(jx), F32)
    _close(L.nonparametric_layer_norm(tx), JL.nonparametric_layer_norm(jx),
           F32)
    for nonparam in (False, True):
        jcfg, tcfg = _cfgs(nonparametric_ln=nonparam)
        jn, tn = JL.make_norm(jcfg, 64), L.make_norm(tcfg, 64)
        assert jax.tree.map(np.shape, jn) == {k: tuple(v.shape)
                                              for k, v in tn.items()}
        _close(L.apply_norm(tcfg, tn, tx), JL.apply_norm(jcfg, jn, jx), F32)
    pos = np.array([0, 3, 7, 1000], np.int32)
    jc, js = JL.rope_tables(jnp.asarray(pos), 64, 1e6)
    tc, ts = L.rope_tables(torch.tensor(pos), 64, 1e6)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    xr = rng.standard_normal((2, 4, 3, 64)).astype(np.float32)
    cs = [t.numpy() for t in L.rope_tables(torch.arange(4), 64, 1e4)]
    _close(L.apply_rope(torch.tensor(xr), *map(torch.tensor, cs)),
           JL.apply_rope(jnp.asarray(xr), *map(jnp.asarray, cs)), F32)
    x1 = xr[:, :1]
    rows = [t.numpy() for t in L.rope_tables(torch.tensor([2, 9]), 64, 1e4)]
    _close(L.apply_rope_rows(torch.tensor(x1), *map(torch.tensor, rows)),
           JL.apply_rope_rows(jnp.asarray(x1), *map(jnp.asarray, rows)), F32)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 8, 0), (False, 0, 0), (True, 0, 5)])
def test_flash_attention_xla(causal, window, q_offset):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 20, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 20 + q_offset, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 20 + q_offset, 2, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block=8)
    _close(L.flash_attention_xla(*map(torch.tensor, (q, k, v)), **kw),
           JL.flash_attention_xla(*map(jnp.asarray, (q, k, v)), **kw), F32)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_decode_xla(window):
    rng = np.random.default_rng(3)
    B, S = 3, 10
    q = rng.standard_normal((B, 1, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((B, S, 2, 32)).astype(np.float32)
    jargs, targs = map(jnp.asarray, (q, kc, vc)), \
        list(map(torch.tensor, (q, kc, vc)))
    jargs = list(jargs)
    for pos in (4, np.array([0, 5, 13], np.int32)):
        want = JL.attention_decode_xla(*jargs, jnp.asarray(pos),
                                       window=window)
        tpos = pos if isinstance(pos, int) else torch.tensor(pos)
        _close(L.attention_decode_xla(*targs, tpos, window=window), want,
               F32)


def _attn_params(jcfg, seed):
    return _noisy(JL.init_attention(jcfg, jax.random.PRNGKey(seed)), seed)


def test_init_attention_and_mlp_layout():
    for kw in ({}, {"qk_norm": True, "qkv_bias": False},
               {"nonparametric_ln": True, "act": "gelu"}):
        jcfg, tcfg = _cfgs(**kw)
        gen = torch.Generator().manual_seed(0)
        for jp, tp in (
                (JL.init_attention(jcfg, jax.random.PRNGKey(0)),
                 L.init_attention(tcfg, gen)),
                (JL.init_mlp(jcfg, jax.random.PRNGKey(0)),
                 L.init_mlp(tcfg, gen))):
            want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
            got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                   for k, v in _flat(tp).items()}
            assert got == _flat(want), kw
        cache = L.init_attn_cache(tcfg, 3, 20)
        jcache = JL.init_attn_cache(jcfg, 3, 20)
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: v.shape for k, v in jcache.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("jbackend", ["jnp", "pallas"])
def test_self_attention_fwd(backend, jbackend, qk_norm):
    jcfg, tcfg = _cfgs(qk_norm=qk_norm)
    jp, tp = _attn_params(jcfg, 0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    rope = [t.numpy() for t in L.rope_tables(torch.arange(24), 64, 1e6)]
    jo, (jk, jv) = JL.self_attention_fwd(jcfg, jp, jnp.asarray(x),
                                         tuple(map(jnp.asarray, rope)),
                                         backend=jbackend)
    to, (tk, tv) = L.self_attention_fwd(tcfg, tp, torch.tensor(x),
                                        tuple(map(torch.tensor, rope)),
                                        backend=backend)
    _close(to, jo, F32, F32)
    _close(tk, jk, F32, F32)
    _close(tv, jv, F32, F32)


def test_self_attention_q_offset_takes_the_online_softmax_path():
    """The kernel has no q_offset: "kernels" takes the "torch" path there,
    bit-equal, and both agree with JAX."""
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg, 1)
    x = np.random.default_rng(5).standard_normal(
        (1, 8, jcfg.d_model)).astype(np.float32)
    rope = [t.numpy() for t in L.rope_tables(4 + torch.arange(8), 64, 1e6)]
    tr = tuple(map(torch.tensor, rope))
    o_k, _ = L.self_attention_fwd(tcfg, tp, torch.tensor(x), tr, q_offset=4,
                                  backend="kernels")
    o_t, _ = L.self_attention_fwd(tcfg, tp, torch.tensor(x), tr, q_offset=4,
                                  backend="torch")
    assert torch.equal(o_k, o_t)
    jo, _ = JL.self_attention_fwd(jcfg, jp, jnp.asarray(x),
                                  tuple(map(jnp.asarray, rope)), q_offset=4)
    _close(o_k, jo, F32, F32)


def _decode_case(jcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    KV, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return x, kc, vc


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("jbackend", ["jnp", "pallas"])
@pytest.mark.parametrize("pos", [7, (4, 11, 0)])
def test_self_attention_decode(backend, jbackend, pos):
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg, 2)
    B, S = 3, 12
    x, kc, vc = _decode_case(jcfg, B, S, 6)
    if isinstance(pos, int):
        jpos, tpos = pos, pos
        rope = L.rope_tables(torch.full((1,), pos), 64, 1e6)
    else:
        jpos, tpos = jnp.asarray(pos, jnp.int32), torch.tensor(pos)
        rope = L.rope_tables(tpos, 64, 1e6)
    rope = [t.numpy() for t in rope]
    jo, jc = JL.self_attention_decode(
        jcfg, jp, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jpos, tuple(map(jnp.asarray, rope)), backend=jbackend)
    cache = {"k": torch.tensor(kc), "v": torch.tensor(vc)}
    to, tc = L.self_attention_decode(tcfg, tp, torch.tensor(x), cache, tpos,
                                     tuple(map(torch.tensor, rope)),
                                     backend=backend)
    assert tc is cache                      # written in place
    _close(to, jo, F32, F32)
    for key in ("k", "v"):
        _close(tc[key], jc[key], F32, F32)


def test_vector_slot_write_leaves_other_rows_bit_identical():
    jcfg, tcfg = _cfgs()
    _, tp = _attn_params(jcfg, 3)
    B, S = 3, 12
    x, kc, vc = _decode_case(jcfg, B, S, 7)
    pos = torch.tensor([2, 9, 5])
    cache = {"k": torch.tensor(kc), "v": torch.tensor(vc)}
    rope = L.rope_tables(pos, 64, 1e6)
    L.self_attention_decode(tcfg, tp, torch.tensor(x), cache, pos, rope)
    for key, orig in (("k", kc), ("v", vc)):
        after = cache[key].numpy()
        for b in range(B):
            rows = np.arange(S) != int(pos[b])
            np.testing.assert_array_equal(after[b, rows], orig[b, rows])
            assert not np.array_equal(after[b, int(pos[b])],
                                      orig[b, int(pos[b])])


@pytest.mark.parametrize("act", ["silu", "relu", "gelu"])
def test_mlp_fwd(act):
    jcfg, tcfg = _cfgs(act=act)
    jp, tp = _noisy(JL.init_mlp(jcfg, jax.random.PRNGKey(0)), 9)
    x = np.random.default_rng(9).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    _close(L.mlp_fwd(tcfg, tp, torch.tensor(x)),
           JL.mlp_fwd(jcfg, jp, jnp.asarray(x)), F32, F32)


# --------------------------------------------------------------------------
# the dense transformer
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen():
    jcfg = jbase.get_config("qwen2-0.5b", reduced=True)
    jp, tp = _noisy(JT.init_params(jcfg, jax.random.PRNGKey(0)), 0, 0.01)
    return jcfg, jp, tp


def test_init_params_layout_and_count(qwen):
    jcfg, jp, _ = qwen
    tcfg = tbase.get_config("qwen2-0.5b", reduced=True)
    tp = T.init_params(tcfg, 0, device="cpu")
    want = jax.tree.map(lambda a: a.shape, jp)
    got = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert got == want
    assert T.param_count(tp) == JT.param_count(jp)
    assert T.layer_plan(tcfg) == JT.layer_plan(jcfg)
    # same distributions: embedding std 0.02, dense weights 1/sqrt(fan_in)
    assert abs(float(tp["embed"].std()) - 0.02) < 2e-3
    wq = tp["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    cache = T.init_cache(tcfg, 3, 20, device="cpu")
    jcache = JT.init_cache(jcfg, 3, 20)
    assert jax.tree.map(lambda a: tuple(a.shape), cache) == \
        jax.tree.map(lambda a: a.shape, jcache)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("window", [0, 6])
def test_prefill_decode_forward_match_reference(qwen, backend, window):
    jcfg, jp, tp = qwen
    jcfg = jcfg.replace(sliding_window=window)
    tcfg = tbase.get_config("qwen2-0.5b", reduced=True).replace(
        attn_backend=backend, sliding_window=window)
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (2, 14))
    toks = toks.astype(np.int32)
    full, _ = JT.forward(jcfg, jp, tokens=jnp.asarray(toks))
    tfull, aux = T.forward(tcfg, tp, tokens=torch.tensor(toks))
    _close(tfull, full, LOGITS)
    assert float(aux) == 0.0
    last_only, _ = T.forward(tcfg, tp, tokens=torch.tensor(toks),
                             unembed_last_only=True)
    _close(last_only[:, 0], full[:, -1], LOGITS)
    P, S = 8, 14
    jlast, jcache = JT.prefill(jcfg, jp, tokens=jnp.asarray(toks[:, :P]),
                               cache_len=S)
    tlast, tcache = T.prefill(tcfg, tp, tokens=torch.tensor(toks[:, :P]),
                              cache_len=S)
    _close(tlast, jlast, LOGITS)
    for a, b in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        _close(a, b, F32, F32)
    for t in range(P, S):
        jl, jcache = JT.decode_step(jcfg, jp, jcache, t,
                                    token=jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = T.decode_step(tcfg, tp, tcache, t,
                                   token=torch.tensor(toks[:, t:t + 1]))
        _close(tl, jl, LOGITS)
        if not window:
            _close(tl[:, 0], full[:, t], LOGITS)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_vector_pos_decode_bit_equal_to_scalar(qwen, backend):
    jcfg, _, tp = qwen
    tcfg = tbase.get_config("qwen2-0.5b", reduced=True).replace(
        attn_backend=backend)
    B, P = 2, 8
    toks = torch.tensor(np.random.default_rng(11).integers(
        0, jcfg.vocab, (B, P + 1)))
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


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_vector_pos_decode_rows_independent(qwen, backend):
    """Each row of a vector-pos decode equals its own solo decode."""
    jcfg, _, tp = qwen
    tcfg = tbase.get_config("qwen2-0.5b", reduced=True).replace(
        attn_backend=backend)
    B, S = 3, 12
    toks = torch.tensor(np.random.default_rng(12).integers(
        0, jcfg.vocab, (B, S)))
    pos = torch.tensor([3, 7, 10])
    cache = T.init_cache(tcfg, B, S, device="cpu")
    solo = []
    for b in range(B):
        _, cb = T.prefill(tcfg, tp, tokens=toks[b:b + 1, :int(pos[b])],
                          cache_len=S)
        for pool, one in zip(tree_leaves(cache), tree_leaves(cb)):
            pool[:, b:b + 1] = one
        solo.append(cb)
    tok = torch.gather(toks, 1, pos[:, None])
    log_v, _ = T.decode_step(tcfg, tp, cache, pos, token=tok)
    for b in range(B):
        log_b, _ = T.decode_step(tcfg, tp, solo[b], int(pos[b]),
                                 token=tok[b:b + 1])
        _close(log_v[b], log_b[0], 2e-4, 2e-4)


def _decode_step_pos_per_layer(cfg, params, cache, pos, token):
    """``decode_step`` as it was before ``pos`` was converted once per step:
    every layer hands its decode attention ``pos`` itself (a python int or
    an int64 tensor), to be converted there."""
    x = T._embed(cfg, params, token, None)
    if isinstance(pos, int):
        rope = T._rope(cfg, torch.full((1,), pos))
    else:
        pos = torch.as_tensor(pos).long()
        rope = T._rope(cfg, pos)
    ctx = {"rope": rope, "window": cfg.sliding_window, "kernel_pos": None}
    x = T._stack_decode(cfg, params["blocks"], cache, x, pos, ctx,
                        T.layer_plan(cfg))
    return T._logits(cfg, params, x), cache


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("kind", ["int", "numpy", "int64", "int32"])
def test_decode_step_pos_converted_once_bit_equal(qwen, backend, kind):
    """Converting ``pos`` once per step changes no bit: logits and caches
    equal (``torch.equal``) those of the per-layer conversion, for a scalar
    pos and for a [B] pos given as numpy, int64 and int32."""
    jcfg, _, tp = qwen
    tcfg = tbase.get_config("qwen2-0.5b", reduced=True).replace(
        attn_backend=backend)
    B, S = 3, 12
    rng = np.random.default_rng(13)
    cache = T.init_cache(tcfg, B, S, device="cpu")
    for leaf in tree_leaves(cache):
        leaf.copy_(torch.tensor(rng.standard_normal(tuple(leaf.shape)),
                                dtype=leaf.dtype))
    want_cache = jax.tree.map(torch.clone, cache)
    tok = torch.tensor(rng.integers(0, jcfg.vocab, (B, 1)))
    pos = {"int": 7, "numpy": np.array([3, 7, 11]),
           "int64": torch.tensor([3, 7, 11]),
           "int32": torch.tensor([3, 7, 11], dtype=torch.int32)}[kind]
    got, cache = T.decode_step(tcfg, tp, cache, pos, token=tok)
    want, want_cache = _decode_step_pos_per_layer(tcfg, tp, want_cache, pos,
                                                  tok)
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the analytic roofline
# --------------------------------------------------------------------------
def test_roofline_arithmetic_equals_reference():
    jhw = troof.Hardware(jroof.PEAK_FLOPS, jroof.HBM_BW)
    for arch in jbase.ARCH_IDS:
        t, j = tbase.get_config(arch), jbase.get_config(arch)
        n = troof.estimate_param_count(t)
        assert n == jroof.estimate_param_count(j), arch
        assert troof._layer_counts(t) == jroof._layer_counts(j)
        assert troof.active_param_count(t, n) == \
            jroof.active_param_count(j, n)
        assert troof.model_flops(t, 7, n_params=n) == \
            jroof.model_flops(j, 7, n_params=n)
        for kv_len, batch, tp in ((0, 1, 1), (4096, 4, 8), (1280, 4, 1)):
            assert troof.kv_cache_bytes(t, kv_len, batch) == \
                jroof.kv_cache_bytes(j, kv_len, batch)
            assert troof.decode_token_cost(
                t, batch=batch, kv_len=kv_len, tp=tp, hw=jhw) == \
                jroof.decode_token_cost(j, batch=batch, kv_len=kv_len,
                                        tp=tp)
    # the port's default device is the H100 SXM data sheet, not a TPU
    assert (troof.H100_SXM.peak_flops, troof.H100_SXM.hbm_bw) == \
        (989e12, 3.35e12)
    q = tbase.get_config("qwen2-0.5b")
    n = troof.estimate_param_count(q)
    want = (n * 2 + troof.kv_cache_bytes(q, 1280, 4)) / 3.35e12
    assert troof.decode_token_cost(q, batch=4, kv_len=1280) == want
