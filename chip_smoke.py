#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device    — print the card's name and power limit, build the CUDA kernels
               from ``src/repro_torch/csrc`` (``nvcc``, ``sm_90a``);
2. kernels   — hold each kernel against its plain PyTorch version on the card
               (test sweeps in fp32 and bf16, B2's also through the
               bounds-checked build, then the main-path shapes) and time it
               beside the plain version, one PyTorch library call for the
               same function, its bound, and an empty launch;
3. serve     — the paper's MLP (784-200-100-10) trained on the card, ``sum``
               parity at k=2 provisioned, and 120 queries served through
               ``deploy(spec, engine="threads")`` with a straggling instance;
               then a short pass with the batched decode forced;
4. A_d       — degraded-mode accuracy over 2000 test images through the fused
               encode+forward and the multigroup decode, against the same
               computation on the plain path;
5. schemes   — resnet18s (stages 16/32/64, 32x32x3 inputs) trained on the
               card and all seven registered schemes provisioned and scored
               through ``eval.unavailability.accuracy_under_unavailability``;
               each scheme's A_d and parity outputs held against a
               ``backend="torch"`` twin with the same parameters;
6. errors    — ``accuracy_under_errors`` for sum and approxifer at r=2 over
               error rates 0, 0.1 and 0.25;
7. byzantine — resnet18s served with ``approxifer`` (k=2, r=2) on the threads
               engine under a deterministic corrupt-and-slow member, then
               with ``approxifer`` (k=2, r=1) and a straggling instance;
8. lm        — full-width qwen2-0.5b (bf16, random weights from a seed)
               served through ``deploy_lm(spec, engine="threads")`` (k=2,
               r=1, sum, 4 slots per instance, 8 requests of 256-1024 prompt
               tokens, 16 new tokens each), once without and once with a
               straggling member; tokens held against an uncoded greedy loop,
               the kernel path's logits against the "torch" backend's, every
               B7 and B8 launch held to its tensor-core route, and the
               measured prefill and decode step beside the H100 roofline;
9. train     — LM parity training at the same width: the block scan's
               custom VJP against autograd through naive attention (fp32,
               bf16), one reduced parity step's gradients on the card
               against the CPU's, a parity model distilled from phase 8's
               model (``make_parity_train_step``, remat, teacher forwards
               through B7, the first batch's teacher logits against the
               torch backend's), remat's gradients against no remat's,
               three joint learned-encoder steps, phase 8's straggler serve
               with the trained parity model, and ``launch/serve`` at
               reduced size;
10. hybrid   — with phases 8-9's models freed: full-width deepseek-moe-16b
               (MoE, B7/B8 at 16 heads over 16, head_dim 128) and
               mamba2-780m (SSM, attention-free), bf16, served as phase 8
               serves qwen2-0.5b, each held against an uncoded greedy loop;
               deepseek's kernel-path logits against the torch backend's
               beside that backend's own noise floor, mamba2's decode
               against its forward (bf16, and an fp32 copy), the decode
               steps' host and device time and host syncs; then reduced
               jamba-1.5-large-398b (fp32) on the card, kernels against
               torch and decode against forward;
11. cross    — with phase 10's models freed: full-width
               llama-3.2-vision-11b (cross attention to 1600 stub patch
               embeddings every fifth layer; B7/B8 at 32 heads over 8,
               head_dim 128) and seamless-m4t-medium (a bidirectional
               encoder over 1024 stub frames, every decoder layer
               cross-attending to its output; B7/B8 at 16 over 16, head_dim
               64), bf16: four streams prefilled with their context into a
               4-slot pool and 16 greedy decode steps at batch 4, tokens
               held against an uncoded greedy loop, kernel-path logits
               against the torch backend's and each decode step against the
               forward beside the torch backend's own noise floor, B7/B8
               launches per prefill and step, the cross K/V unchanged by
               decode, the decode step's costs, the prefill (and encoder)
               time; then ``launch/train`` for both at reduced size;
12. distributed — phase 8's qwen2-0.5b again, on a (1, 1) ("data",
               "model") ``DeviceMesh`` over a one-rank NCCL group with the
               launcher's logical rules active: ``launch.steps``' prefill
               step bit-equal to ``T.prefill`` without rules (24 B7
               launches per prefill), its decode step (24 B8 launches per
               step) giving phase 8's loop tokens, the coded-serve step in
               both flavours (k=2) held to each other within phase 8's bf16
               rule, and ``deploy_lm`` with ``GenerationSpec(mesh=...)``
               serving phase 8's requests with phase 8's tokens; then the
               host-only dry run of two full-size pairs on a (16, 16) mesh
               (``launch.dryrun.run_pair``) on this machine's torch.

``python3 chip_smoke.py --distil-lrs 1e-4,1e-3`` runs phase 9's
distillation alone at each learning rate and prints no result line.

The launch counters are zeroed before each of the seven paths (phases 3-4,
the coded MLP serving path; phases 5-7, the scheme registry's path; phase 8,
coded LM serving; phase 9, LM parity training and serving the trained model;
phase 10, MoE / SSM / hybrid LM serving; phase 11, cross-attention and
encoder-decoder LM serving; phase 12, the launch steps on a device mesh) and
read after it; every kernel of a path must have run on it.
Launches made only to compare a kernel path with its plain twin are not
counted.  The last two lines of
standard output are a ``{"kernels": [...]}`` JSON object and the
``{"ok": true, ...}`` result.  Imports nothing of JAX and nothing of the JAX
package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.convert import to_host, tree_leaves, tree_map  # noqa: E402
from repro_torch.core.metrics import (degraded_accuracy,  # noqa: E402
                                      topk_accuracy)
from repro_torch.core.parity import (fused_parity_outputs,  # noqa: E402
                                     train_parity_models)
from repro_torch.core.scheme import get_scheme  # noqa: E402
from repro_torch.data.pipeline import batched, cluster_images  # noqa: E402
from repro_torch.eval import unavailability as unavail  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import berrut_encoder as k_berrut  # noqa: E402
from repro_torch.kernels import decode_attention as k_dattn  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import fused_encode_forward as k_fused  # noqa: E402
from repro_torch.kernels import learned_encoder as k_proj  # noqa: E402
from repro_torch.kernels import multigroup_decode as k_mg  # noqa: E402
from repro_torch.kernels import parity_decode as k_dec  # noqa: E402
from repro_torch.kernels import parity_encode as k_enc  # noqa: E402
from repro_torch.distributed.logical import (  # noqa: E402
    logical_rules, rules_for_mesh)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import steps as launch_steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    decode_token_cost, estimate_param_count, kv_cache_bytes)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.cnn import build  # noqa: E402
from repro_torch.serving import runtime  # noqa: E402
from repro_torch.serving.api import (BatchingPolicy,  # noqa: E402
                                     DeploymentSpec, deploy, deploy_lm)
from repro_torch.serving.generation import GenerationSpec  # noqa: E402
from repro_torch.serving.scenarios import (  # noqa: E402
    DeterministicCorruption, DeterministicSlowdown, Scenario, instance_id,
    pool_of_iid)
from repro_torch.training.loss import softmax_xent  # noqa: E402
from repro_torch.training.optim import (AdamConfig, adam_init,  # noqa: E402
                                        adam_update)
from repro_torch.training.train_lib import (  # noqa: E402
    grad_cfg, make_joint_parity_train_step, make_parity_train_step,
    parity_loss_fn, value_and_grad)

DEV = "cuda"
IMG = (28, 28, 1)                 # MNIST shape of the paper's MLP runs
K = 2
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 SIMT
# FLOP/s, bf16 dense tensor-core FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
CSRC = "src/repro_torch/csrc/parity_kernels.cu"
CSRC_ATTN = "src/repro_torch/csrc/attention_kernels.cu"


def log(msg):
    print(msg, flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=200, warmup=20):
    """Mean time of one call on the stream, by CUDA events over ``iters``
    back-to-back calls after a warm-up.  At launch-bound sizes this is the
    per-call cost including the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, iters=50):
    """Device time per call of ``fn`` spent in the CUDA kernels whose names
    contain ``kernel`` (a name or a tuple of names; a call may launch
    several), from a torch.profiler trace of ``iters`` calls; None when the
    trace holds no device time for them."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if any(name in ev.key for name in names):
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total / iters / 1e3 if count and total else None


def device_ops(fn, iters=20):
    """Device operations (kernels, copies, fills) that ``iters`` calls of
    ``fn`` issue under torch.profiler, counted by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def fmt_ms(ms):
    """A measured device time, or "not measured" where the trace held
    none."""
    return "not measured" if ms is None else f"{ms:.5f}"


def bound(nbytes, flops, dtype):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate for the operand type."""
    t_mem = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def tol(dt):
    return 2e-2 if dt == torch.bfloat16 else 2e-5


def attn_tol(dt):
    """The reference's attention kernel tolerance (tests/test_kernels.py)."""
    return 3e-2 if dt == torch.bfloat16 else 2e-5


def check_close(name, got, want, atol, rtol):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; returns
    the max abs error."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"beyond atol={atol:g} rtol={rtol:g}")
    return err.max().item()


def randn(gen, shape, dt):
    return torch.randn(shape, generator=gen, device=DEV).to(dt)


# ------------------------------------------------------------ phase 1 ----
def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda is not available; this script "
                 "drives the port on an NVIDIA GPU and has no CPU mode")
    log(smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[device] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, regs, spills in ptxas_report(_build.build_log):
        log(f"  ptxas: {name}: {regs} registers, {spills}")


def ptxas_report(text):
    """(kernel, registers, spill line) for each entry function in nvcc's
    ``-Xptxas=-v`` output, the kernel named as in the source (e.g.
    ``flash_wgmma_kernel<64>``)."""
    rows, name, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and name is not None:
            regs = re.search(r"Used (\d+) registers", line)
            rows.append((name, regs.group(1) if regs else "?", spills))
            name = None
    return rows


def kernel_name(sym):
    """The innermost name of a mangled kernel symbol (``_ZN<len><id>...``)
    with its template arguments (bf16, float, integers)."""
    i, name = sym.find("N") + 1, sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        name, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
    args = re.match(r"I(.*?)EE", sym[i:])
    if not args:
        return name
    names = {"13__nv_bfloat16": "bf16", "f": "float", "Lb1": "true",
             "Lb0": "false"}
    toks = re.findall(r"13__nv_bfloat16|Li\d+|Lb[01]|f", args.group(1))
    return f"{name}<{', '.join(names.get(t, t[2:]) for t in toks)}>"


# ------------------------------------------------------------ phase 2 ----
def sweep_kernels():
    """The test-suite shape sweeps of every kernel, fp32 and bf16."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    n = 0
    for k, B, F in [(2, 4, 512), (3, 1, 128), (4, 8, 1000), (6, 2, 257),
                    (2, 4, 784), (2, 1, 784)]:
        for dt in (torch.float32, torch.bfloat16):
            q = randn(gen, (k, B, F), dt)
            c = torch.arange(1.0, k + 1.0, device=DEV)
            check_close(f"encode {k,B,F,dt}", ops.parity_encode_op(q, c),
                        ref.parity_encode_ref(q, c), tol(dt), tol(dt))
            n += 1
    for k, B, V in [(2, 4, 100), (4, 2, 1000), (3, 8, 513), (2, 4, 10),
                    (2, 1, 10)]:
        for dt in (torch.float32, torch.bfloat16):
            outs = randn(gen, (k, B, V), dt)
            par = randn(gen, (B, V), dt)
            c = np.arange(1.0, k + 1.0, dtype=np.float32)   # host values
            for j in range(k):
                avail = torch.tensor(c * (np.arange(k) != j), device=DEV)
                check_close(f"decode {k,B,V,dt} j={j}",
                            ops.parity_decode_op(par, outs, j, coeffs=c),
                            ref.parity_decode_ref(par, outs, avail,
                                                  1.0 / float(c[j])),
                            tol(dt) * k, 2e-2)
                n += 1
    t0 = time.perf_counter()
    _build.library(checked=True)
    log(f"[kernels] checked build (-DREPRO_CHECKED -lineinfo) built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    n += sweep_fused(gen)
    for G, k, B, V in [(1, 2, 1, 9), (5, 3, 4, 100), (4, 4, 2, 257),
                       (1000, 2, 1, 10)]:
        for dt in (torch.float32, torch.bfloat16):
            po = randn(gen, (G, B, V), dt)
            outs = randn(gen, (G, k, B, V), dt)
            idxs = torch.arange(G, device=DEV) % k
            for coeffs in (torch.arange(1.0, k + 1.0, device=DEV),
                           randn(gen, (G, k), torch.float32) + 2.0):
                cg = coeffs if coeffs.ndim == 2 else \
                    coeffs[None].expand(G, k)
                avail = cg * (torch.arange(k, device=DEV)[None]
                              != idxs[:, None])
                inv = 1.0 / torch.gather(cg, 1, idxs[:, None])
                cmat = torch.cat([avail, inv], 1)
                check_close(f"multigroup {G,k,B,V,dt}",
                            ops.multigroup_decode_op(po, outs, idxs, coeffs),
                            ref.multigroup_decode_ref(po, outs, cmat),
                            tol(dt) * k, 2e-2)
                n += 1
    # B5 (r = 11 spills into a second row group) and B6 (the approxifer
    # shapes, flattened to [k, B, F]); tolerance 4x the dtype's, as in the
    # reference's tests
    for H, r, B, F in [(8, 1, 4, 512), (16, 2, 1, 128), (16, 3, 2, 257),
                       (32, 2, 8, 1000), (4, 11, 3, 1000), (16, 1, 1, 3072)]:
        for dt in (torch.float32, torch.bfloat16):
            h = randn(gen, (H, B, F), dt)
            w = randn(gen, (H, r), torch.float32)
            check_close(f"learned_project {H,r,B,F,dt}",
                        ops.learned_project_op(h, w),
                        ref.learned_project_ref(h, w), tol(dt) * 4,
                        tol(dt) * 4)
            n += 1
    for k, r, B, F in [(2, 1, 3, 8), (3, 2, 1, 16), (4, 2, 2, 130),
                       (2, 2, 9, 5), (2, 2, 1, 3072)]:
        for dt in (torch.float32, torch.bfloat16):
            q = randn(gen, (k, B, F), dt)
            c = randn(gen, (r, k), torch.float32)
            check_close(f"berrut_encode {k,r,B,F,dt}",
                        ops.berrut_encode_op(q, c),
                        ref.learned_project_ref(q, c.T), tol(dt) * 4,
                        tol(dt) * 4)
            n += 1
    # B7 / B8: the reference's sweep cases (tests/test_kernels.py) in both
    # dtypes, plus ragged edges, windows and one-token prompts (B7), and
    # per-row pos, a pos past the cache and rep up to 16 (B8).  B7 also at
    # each shape its paths give it: the longest LM prompt (910, a ragged
    # last key tile) at qwen2-0.5b's heads and at deepseek-moe-16b's (16
    # over 16, hd 128: phase 10), phase 9's teacher forwards (1024 tokens,
    # eight full tiles) and launch/serve's reduced qwen2-0.5b (fp32 teacher
    # batch of 4 and single queries, 32 tokens); B8 also on a full serving
    # pool at each model's heads
    for B, Sq, Sk, H, KV, hd, causal, window in [
            (2, 128, 128, 4, 2, 64, True, 0), (1, 256, 256, 4, 4, 64, True, 64),
            (2, 100, 100, 2, 1, 32, False, 0), (1, 128, 128, 8, 2, 128, True, 0),
            (3, 33, 47, 6, 3, 128, False, 16), (2, 70, 70, 4, 2, 32, True, 5),
            (1, 1, 1, 14, 2, 64, True, 0), (2, 129, 129, 14, 2, 128, True, 0),
            (1, 910, 910, 14, 2, 64, True, 0),
            (1, 910, 910, 16, 16, 128, True, 0),
            (1, 1024, 1024, 14, 2, 64, True, 0),
            (4, 32, 32, 4, 2, 64, True, 0), (1, 32, 32, 4, 2, 64, True, 0)]:
        for dt in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, Sq, H, hd), dt)
            k = randn(gen, (B, Sk, KV, hd), dt)
            v = randn(gen, (B, Sk, KV, hd), dt)
            kw = dict(causal=causal, window=window)
            route = k_flash.route_launches[k_flash.ROUTES[dt]]
            before = route.value
            check_close(f"flash_attention {B,Sq,Sk,H,KV,hd,causal,window,dt}",
                        ops.flash_attention_op(q, k, v, **kw),
                        ref.flash_attention_ref(q, k, v, **kw), attn_tol(dt),
                        0.0)
            if route.value != before + 1:
                raise AssertionError(f"flash_attention {dt}: not on the "
                                     f"{k_flash.ROUTES[dt]} route")
            n += 1
    for B, S, H, KV, hd, pos in [
            (2, 512, 4, 2, 64, 100), (1, 1024, 8, 1, 32, 1023),
            (3, 256, 2, 2, 64, 0), (2, 384, 4, 4, 128, 200),
            (1, 1024, 8, 1, 32, 0), (3, 256, 2, 2, 64, 255),
            (3, 16, 4, 2, 64, [2, 9, 5]), (2, 100, 32, 2, 128, [99, 5000]),
            (4, 1280, 14, 2, 64, [300, 1279, 5, 700]),
            (4, 1280, 16, 16, 128, B8_POS),
            (1, 8192, 16, 1, 128, 8191), (1, 8, 4, 2, 32, 0)]:
        for dt in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, hd), dt)
            kc = randn(gen, (B, S, KV, hd), dt)
            vc = randn(gen, (B, S, KV, hd), dt)
            route = k_dattn.route_launches[k_dattn.ROUTES[dt]]
            before = route.value
            check_close(f"decode_attention {B,S,H,KV,hd,pos,dt}",
                        ops.decode_attention_op(q, kc, vc, pos),
                        ref.decode_attention_ref(q, kc, vc, pos),
                        attn_tol(dt), 0.0)
            if route.value != before + 1:
                raise AssertionError(f"decode_attention {dt}: not on the "
                                     f"{k_dattn.ROUTES[dt]} route")
            n += 1
    torch.cuda.synchronize()
    return n


# B2's sweep: ragged F, B and V, unaligned rows, F smaller than the cluster
# (2, 1, 4, 3, 64), F = 0, B = 1, k = 8, and shapes whose fp32 cluster size
# on an H100 is 1, 2 and 4 (5 is the A_d shape's, 8 the small shapes')
FUSED_SWEEP = [(2, 1, 4, 512, 128), (3, 1, 5, 300, 130), (2, 3, 8, 1024, 257),
               (4, 2, 1, 129, 64), (4, 2, 8, 1000, 100), (2, 1, 1000, 784, 200),
               (2, 1, 4, 3, 64), (2, 1, 4, 0, 64), (8, 2, 33, 200, 72),
               (2, 1, 4000, 784, 200), (2, 1, 2400, 784, 256),
               (2, 1, 1280, 784, 256)]


def sweep_fused(gen):
    """B2 over FUSED_SWEEP in the four dtype pairs, through the op and
    through the bounds-checked build (a REPRO_CHECK trap there fails the
    CUDA context, and with it this run); the tolerance follows the queries'
    dtype, the output's."""
    n = 0
    for k, r, B, F, V in FUSED_SWEEP:
        for dx, dw in [(a, b) for a in (torch.float32, torch.bfloat16)
                       for b in (torch.float32, torch.bfloat16)]:
            q = randn(gen, (k, B, F), dx)
            C = randn(gen, (r, k), torch.float32)
            W = randn(gen, (r, F, V), dw)
            mul = math.sqrt(max(F, 1) * k)
            want = ref.fused_encode_forward_ref(q, C, W)
            check_close(f"fused {k,r,B,F,V,dx,dw}",
                        ops.fused_encode_forward_op(q, C, W), want,
                        tol(dx) * mul, tol(dx) * mul)
            check_close(f"fused checked build {k,r,B,F,V,dx,dw}",
                        k_fused.launch(q, C, W, checked=True), want,
                        tol(dx) * mul, tol(dx) * mul)
            n += 1
    torch.cuda.synchronize()
    log(f"[kernels] fused_encode_forward: {n} sweep cases, each also through "
        f"the checked build (REPRO_CHECK on every index): no trap")
    return n


def one_launch(label, fn, kernel):
    """Raise unless 20 calls of ``fn`` issue 20 launches of ``kernel`` and
    no other device operation.  The calls are traced in two windows and
    each operation counted at its larger count: a trace now and then loses
    one kernel event (a window of 20 B8 calls read 19 once), which the
    other window shows; an extra or missing operation of the calls
    themselves shows in both."""
    first, second = device_ops(fn), device_ops(fn)
    seen = {key: max(first.get(key, 0), second.get(key, 0))
            for key in {**first, **second}}
    if first != second:
        log(f"[kernels] {label}: the two traced windows differ ({first} / "
            f"{second}); counted at the larger")
    if len(seen) != 1 or sum(seen.values()) != 20 or \
            kernel not in next(iter(seen)):
        raise AssertionError(f"{label}: 20 calls issued {seen} on the "
                             f"device, not 20 launches of {kernel}")


def empty_launch_ms():
    """Device time of one empty kernel launched through the kernels' ctypes
    path (``repro_empty_launch``): the floor a launch-bound kernel sits
    on."""
    lib = _build.library()
    dev = torch.device(DEV, torch.cuda.current_device())

    def call():
        _build.check(lib.repro_empty_launch(_build.stream(dev)), "empty")
    return device_ms(call, "empty_kernel", iters=200)


def sdpa(q, k, v, **kw):
    """The library yardstick: one scaled_dot_product_attention call on
    [B, H, S, hd] views, GQA by ``enable_gqa`` (timed only, never called by
    the port)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw)


def library_device_ms(fn, iters=50):
    """Device time per call of a library call, summed over every device
    operation it issues (its kernels carry the library's names)."""
    fn()
    _, busy, _ = device_profile(lambda: [fn() for _ in range(iters)])
    return busy / iters * 1e3


def b7_row(gen, P, H, KV, hd):
    """B7 on one causal bf16 prompt of P tokens at batch 1: error against
    the plain version, and the kernel's, plain version's and SDPA's
    times."""
    bf = torch.bfloat16
    B = 1
    q, k, v = (randn(gen, (B, P, n, hd), bf) for n in (H, KV, KV))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    got = k_flash.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    lib_err = check_close("B7 library", sdpa(qt, kt, vt, is_causal=True)
                          .transpose(1, 2), want, attn_tol(bf), 0.0)
    pairs = P * (P + 1) // 2                     # (query, key) the mask keeps
    return dict(
        shape=[B, P, H, KV, hd], replaces="src/repro/kernels/flash_attention.py:73",
        max_abs_err=check_close(f"B7 {[B, P, H, KV, hd]}", got, want,
                                attn_tol(bf), 0.0),
        ms=time_ms(lambda: k_flash.flash_attention(q, k, v), iters=50),
        device_ms=device_ms(lambda: k_flash.flash_attention(q, k, v),
                            "flash_wgmma_kernel"),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=20),
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                           iters=50),
        library_device_ms=library_device_ms(
            lambda: sdpa(qt, kt, vt, is_causal=True)),
        library_err=lib_err,
        # q and out, k and v once each; QK^T and PV, 2 hd each per kept pair
        bound=bound(2 * (B * P * H * hd + B * P * KV * hd) * 2,
                    4 * hd * pairs * H * B, bf))


def b8_row(gen, H, KV, hd, pos, S=None):
    """B8 on a full serving step's cache pool (LM_SLOTS slots of S, LM_SEQ
    by default, bf16) at the per-row positions ``pos``: error against the
    plain version, the kernel's, plain version's and SDPA's times, and a
    check that one call is one launch and no other device operation."""
    bf = torch.bfloat16
    B, S = LM_SLOTS, S or LM_SEQ
    q = randn(gen, (B, H, hd), bf)
    kc, vc = randn(gen, (B, S, KV, hd), bf), randn(gen, (B, S, KV, hd), bf)
    pos = torch.tensor(pos, dtype=torch.int32, device=DEV)
    mask = (torch.arange(S, device=DEV)[None, :] <= pos[:, None])[
        :, None, None, :]
    q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

    def b8():
        return k_dattn.decode_attention(q, kc, vc, pos)

    got = b8()
    want = ref.decode_attention_ref(q, kc, vc, pos)
    one_launch(f"B8 {[B, S, H, KV, hd]}", b8, "decode_cluster_kernel")
    lib_err = check_close("B8 library", sdpa(q4, kt, vt, attn_mask=mask)[:, :,
                                                                        0],
                          want, attn_tol(bf), 0.0)
    valid = int(torch.clamp(pos + 1, max=S).sum())   # cache rows read
    row = dict(
        shape=[B, S, H, KV, hd], pos=pos.tolist(),
        replaces="src/repro/kernels/decode_attention.py:63",
        max_abs_err=check_close(f"B8 {[B, S, H, KV, hd]}", got, want,
                                attn_tol(bf), 0.0),
        ms=time_ms(b8),
        device_ms=device_ms(b8, "decode_cluster_kernel"),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, kc, vc, pos)),
        library_ms=time_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask)),
        library_device_ms=library_device_ms(
            lambda: sdpa(q4, kt, vt, attn_mask=mask)),
        library_err=lib_err,
        # q and out once, each valid cache row of k and v once, pos
        bound=bound(2 * B * H * hd * 2 + 2 * valid * KV * hd * 2 + B * 4,
                    4 * hd * H * valid, bf))
    return row, b8, (q, kc, vc, pos)


# phase 8's per-row decode positions of a full serving step
B8_POS = [300, 1279, 517, 1031]


def attention_rows(gen):
    """B7 and B8 at the shapes the LM paths give them, in bf16: B7 on the
    longest prompt of phases 8 and 10 (qwen2-0.5b's 14 heads over 2 at
    hd 64, deepseek-moe-16b's 16 over 16 at hd 128), B8 on a full serving
    step's cache pool with mixed per-row positions at each model's heads.
    The qwen2 rows are the kernels' JSON rows; the rows at the other
    models' heads (deepseek-moe-16b; phase 11's llama-3.2-vision-11b, 32
    heads over 8 at hd 128, and seamless-m4t-medium, 16 over 16 at hd 64)
    ride in them under the keys of HEAD_ROWS."""
    rows = {}
    P = max(len(p) for p in lm_prompts(get_config(LM_ARCH).vocab))
    rows["flash_attention"] = b7_row(gen, P, 14, 2, 64)
    rows["decode_attention"], b8, (q, kc, vc, pos) = b8_row(
        gen, 14, 2, 64, B8_POS)
    # the device time at each cluster size (the card's pick is above), and
    # with one valid slot per row: what a launch costs whatever pos is
    by_cluster = {}
    for size in k_dattn.CLUSTER_SIZES:
        with forced_cluster(size):
            by_cluster[size] = device_ms(b8, "decode_cluster_kernel")
    pos0 = torch.zeros_like(pos)
    rows["decode_attention"].update(
        device_ms_by_cluster=by_cluster,
        one_slot_device_ms=device_ms(
            lambda: k_dattn.decode_attention(q, kc, vc, pos0),
            "decode_cluster_kernel"))
    log(f"[kernels] decode_attention device ms by cluster size {by_cluster}; "
        f"with pos 0 in every row (one slot) "
        f"{fmt_ms(rows['decode_attention']['one_slot_device_ms'])}")
    moe = get_config(MOE_ARCH)
    H, KV, hd = moe.n_heads, moe.n_kv_heads, moe.resolved_head_dim
    rows["flash_attention"]["deepseek"] = b7_row(gen, P, H, KV, hd)
    rows["decode_attention"]["deepseek"] = b8_row(gen, H, KV, hd,
                                                  B8_POS)[0]
    # phase 11's heads, each on its path's longest prompt and its pool
    for key, arch in HEAD_ROWS[1:]:
        cfg = get_config(arch)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        longest = max(map(len, cross_prompts(cfg)))
        rows["flash_attention"][key] = b7_row(gen, longest, H, KV, hd)
        rows["decode_attention"][key] = b8_row(
            gen, H, KV, hd, CROSS_B8_POS[arch], CROSS_SEQ[arch])[0]
    log("[kernels] decode_attention: 20 calls of the wrapper issue 20 "
        "launches of decode_cluster_kernel and no other device operation "
        "(at the heads of qwen2-0.5b, "
        + ", ".join(arch for _, arch in HEAD_ROWS) + ")")
    for (dt, hd_), (size, capacity) in sorted(
            k_dattn.cluster_decisions().items(), key=str):
        log(f"[kernels] decode_attention cluster decision ({dt}, hd {hd_}): "
            f"{size} CTAs per (b, kv-head); clusters the card holds at once "
            f"by size: {capacity}")
    return rows


@contextlib.contextmanager
def forced_cluster(size):
    """B8 launched with clusters of ``size`` CTAs whatever the card's pick
    (timing only)."""
    chosen = k_dattn.cluster_size
    k_dattn.cluster_size = lambda *_: size
    try:
        yield
    finally:
        k_dattn.cluster_size = chosen


def measure_kernels():
    """Each kernel at the shape the main path gives it (fp32): max abs error
    against its plain version, and the times of kernel, plain version and
    one library call for the same function."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    f32 = torch.float32
    es = 4
    rows = {}

    # B1: one coding group of two 1-sample MNIST queries
    k, B, F = K, 1, 784
    q = randn(gen, (k, B, F), f32)
    c = torch.ones(k, device=DEV)
    got, want = k_enc.parity_encode(q, c), ref.parity_encode_ref(q, c)
    rows["parity_encode"] = dict(
        shape=[k, B, F], replaces="src/repro/kernels/parity_encode.py:28",
        max_abs_err=check_close("B1", got, want, 2e-5, 2e-5),
        ms=time_ms(lambda: k_enc.parity_encode(q, c)),
        device_ms=device_ms(lambda: k_enc.parity_encode(q, c),
                            "encode_kernel"),
        plain_ms=time_ms(lambda: ref.parity_encode_ref(q, c)),
        library_ms=time_ms(lambda: torch.einsum("k,kbf->bf", c, q)),
        library_device_ms=library_device_ms(
            lambda: torch.einsum("k,kbf->bf", c, q)),
        bound=bound((k + 1) * B * F * es + k * 4, 2 * k * B * F, f32))

    # B3: one group's decode, 10 logits per member, with the k + 1
    # coefficients as host values (launch parameters); also timed as the op
    # and as LinearScheme.decode_one (the MLP path's rebuild) call it
    k, B, V = K, 1, 10
    outs = randn(gen, (k, B, V), f32)
    par = randn(gen, (B, V), f32)
    c = np.ones(k, np.float32)
    avail = c * (np.arange(k) != 0)
    inv_c = np.float32(1.0) / c[0]
    avail_d = torch.tensor(avail, device=DEV)
    stack = torch.cat([par[None], outs])
    w = torch.cat([torch.tensor([inv_c], device=DEV), -avail_d * inv_c])
    sum_code = get_scheme("sum", k=k, device=DEV)

    def b3():
        return k_dec.parity_decode(par, outs, avail, inv_c)

    def b3_op():
        return ops.parity_decode_op(par, outs, 0, coeffs=c)

    def b3_scheme():
        return sum_code.decode_one(par, outs, 0)

    want = ref.parity_decode_ref(par, outs, avail_d, inv_c)
    for label, fn in (("wrapper", b3), ("op", b3_op),
                      ("decode_one", b3_scheme)):
        check_close(f"B3 {label}", fn().reshape(want.shape), want, 2e-5 * k,
                    2e-2)
        one_launch(f"B3 {label}", fn, "parity_decode_kernel")
    log("[kernels] parity_decode: 20 calls of the wrapper, of the op and of "
        "LinearScheme.decode_one each issue 20 launches of "
        "parity_decode_kernel and no other device operation")
    rows["parity_decode"] = dict(
        shape=[k, B, V], replaces="src/repro/kernels/parity_decode.py:28",
        max_abs_err=check_close("B3", b3(), want, 2e-5 * k, 2e-2),
        ms=time_ms(b3), op_ms=time_ms(b3_op),
        decode_one_ms=time_ms(b3_scheme),
        device_ms=device_ms(b3, "parity_decode_kernel"),
        plain_ms=time_ms(
            lambda: ref.parity_decode_ref(par, outs, avail_d, inv_c)),
        library_ms=time_ms(lambda: torch.einsum("k,kbv->bv", w, stack)),
        library_device_ms=library_device_ms(
            lambda: torch.einsum("k,kbv->bv", w, stack)),
        bound=bound((k + 2) * B * V * es + (k + 1) * 4,
                    (2 * k + 1) * B * V, f32))

    # B4: the A_d path's decode of 1000 groups at once
    G, k, B, V = 1000, K, 1, 10
    po = randn(gen, (G, B, V), f32)
    outs = randn(gen, (G, k, B, V), f32)
    idxs = torch.arange(G, device=DEV) % k
    cg = torch.ones((G, k), device=DEV)
    avail = cg * (torch.arange(k, device=DEV)[None] != idxs[:, None])
    inv = 1.0 / torch.gather(cg, 1, idxs[:, None])
    cmat = torch.cat([avail, inv], 1)
    stack = torch.cat([po[:, None], outs], 1)
    wg = torch.cat([inv, -avail * inv], 1)
    got = k_mg.multigroup_decode(po, outs, cmat)
    want = ref.multigroup_decode_ref(po, outs, cmat)
    rows["multigroup_decode"] = dict(
        shape=[G, k, B, V],
        replaces="src/repro/kernels/multigroup_decode.py:42",
        max_abs_err=check_close("B4", got, want, 2e-5 * k, 2e-2),
        ms=time_ms(lambda: k_mg.multigroup_decode(po, outs, cmat)),
        device_ms=device_ms(lambda: k_mg.multigroup_decode(po, outs, cmat),
                            "mg_decode_kernel"),
        plain_ms=time_ms(lambda: ref.multigroup_decode_ref(po, outs, cmat)),
        library_ms=time_ms(lambda: torch.einsum("gk,gkbv->gbv", wg, stack)),
        library_device_ms=library_device_ms(
            lambda: torch.einsum("gk,gkbv->gbv", wg, stack)),
        bound=bound(G * (k + 2) * B * V * es + G * (k + 1) * 4,
                    G * (2 * k + 1) * B * V, f32))

    # Back-to-back calls find inputs below 50 MB in L2; cold_device_ms
    # writes 64 MB between calls, so the kernel reads device memory
    flush = torch.empty(64 * 2 ** 20 // 4, device=DEV)

    # B2: the A_d path's fused encode + first layer, 1000 groups; one call
    # is one launch of the cluster kernel and no other device operation
    k, r, B, F, V = K, 1, 1000, 784, 200
    q = randn(gen, (k, B, F), f32)
    C = torch.ones((r, k), device=DEV)
    W = randn(gen, (r, F, V), f32) * 0.05
    got = k_fused.fused_encode_forward(q, C, W)
    want = ref.fused_encode_forward_ref(q, C, W)
    mul = math.sqrt(F * k)

    def b2():
        return k_fused.fused_encode_forward(q, C, W)

    def b2_library():
        return torch.bmm(torch.einsum("rk,kbf->rbf", C, q), W)

    one_launch("B2", b2, "fused_cluster_kernel")
    S, clusters = k_fused.card_plan(q, W)
    _, _, S_plan, grid = k_fused.fused_plan(k, r, B, F, V, clusters)
    if S_plan != S:
        raise AssertionError(f"B2: fused_plan picks {S_plan}, the kernel {S}")
    log(f"[kernels] fused_encode_forward: 20 calls of the wrapper issue 20 "
        f"launches of fused_cluster_kernel and no other device operation; "
        f"clusters of {S} CTAs, grid {grid}; clusters the card holds at once "
        f"by size: {clusters}")
    rows["fused_encode_forward"] = dict(
        shape=[k, B, F, r, V],
        replaces="src/repro/kernels/fused_encode_forward.py:61",
        max_abs_err=check_close("B2", got, want, 2e-5 * mul, 2e-5 * mul),
        ms=time_ms(b2),
        device_ms=device_ms(b2, "fused_cluster_kernel"),
        cold_device_ms=device_ms(lambda: (flush.fill_(0.0), b2()),
                                 "fused_cluster_kernel"),
        plain_ms=time_ms(lambda: ref.fused_encode_forward_ref(q, C, W)),
        library_ms=time_ms(b2_library),
        library_device_ms=library_device_ms(b2_library),
        bound=bound((k * B * F + r * F * V + r * B * V) * es + r * k * 4,
                    2 * r * k * B * F + 2 * r * B * F * V, f32))
    floor = empty_launch_ms()
    beside = ", ".join(f"{name} {fmt_ms(rows[name]['device_ms'])}" for name in
                       ("parity_encode", "parity_decode", "multigroup_decode"))
    log(f"[kernels] empty launch (empty_kernel through the ctypes path) "
        f"device_ms={fmt_ms(floor)}; beside it {beside}")
    for name in ("parity_encode", "parity_decode", "multigroup_decode"):
        rows[name]["empty_launch_device_ms"] = floor

    # B5 and B6 at the four shapes phases 5-6 give them (A_d over 200
    # groups of two 32x32x3 images); the first of each is the JSON row.

    def project_row(label, shape, counter):
        H, B, F, r = shape                  # H is k for the berrut encode
        h = randn(gen, (H, B, F), f32)
        w = randn(gen, (H, r), f32)
        c = w.T.contiguous()                # C [r, k], so that W = C^T

        def call():
            if counter == "berrut_encode":
                return k_berrut.berrut_encode(h, c)
            return k_proj.learned_project(h, w)
        row = dict(
            label=label, shape=[H, B, F, r],
            max_abs_err=check_close(label, call(),
                                    ref.learned_project_ref(h, w), 2e-5 * 4,
                                    2e-5 * 4),
            ms=time_ms(call),
            device_ms=device_ms(call, "project_kernel"),
            plain_ms=time_ms(lambda: ref.learned_project_ref(h, w)),
            library_ms=time_ms(lambda: torch.einsum("hr,hbf->rbf", w, h)),
            library_device_ms=library_device_ms(
                lambda: torch.einsum("hr,hbf->rbf", w, h)),
            cold_device_ms=device_ms(lambda: (flush.fill_(0.0), call()),
                                     "project_kernel"),
            bound=bound((H + r) * B * F * es + H * r * 4, 2 * H * r * B * F,
                        f32))
        rows.setdefault(counter, dict(
            replaces="src/repro/kernels/learned_encoder.py:32"
            if counter == "learned_project"
            else "src/repro/kernels/berrut_encoder.py:23", shapes=[]))
        rows[counter]["shapes"].append(row)

    project_row("learned A_d", (16, 200, 3072, 1), "learned_project")
    project_row("invnet coupling shift", (8, 400, 1536, 1),
                "learned_project")
    project_row("approxifer A_d r=1", (2, 200, 3072, 1), "berrut_encode")
    project_row("approxifer errors r=2", (2, 200, 3072, 2), "berrut_encode")
    for name in ("learned_project", "berrut_encode"):
        first = rows[name]["shapes"][0]
        rows[name].update({key: first[key] for key in (
            "shape", "max_abs_err", "ms", "device_ms", "cold_device_ms",
            "plain_ms", "library_ms", "library_device_ms", "bound")})
    rows.update(attention_rows(gen))
    for name, row in rows.items():
        shapes = row.get("shapes", [dict(row, label="")])
        shapes = shapes + [dict(row[key], label=arch)
                           for key, arch in HEAD_ROWS if key in row]
        for one in shapes:
            dev = fmt_ms(one["device_ms"])
            log(f"[kernels] {name:21s} {one['label']} shape={one['shape']} "
                f"max_abs_err={one['max_abs_err']:.3e} ms={one['ms']:.5f} "
                f"device_ms={dev} "
                + (f"cold_device_ms={fmt_ms(one['cold_device_ms'])} "
                   if "cold_device_ms" in one else "")
                + f"plain_ms={one['plain_ms']:.5f} "
                f"library_ms={one['library_ms']:.5f} "
                + (f"library_device_ms={one['library_device_ms']:.5f} "
                   if "library_device_ms" in one else "")
                + f"bound_ms={one['bound'][0]:.6f} ({one['bound'][1]})")
    b3 = rows["parity_decode"]
    log(f"[kernels] parity_decode with host coefficients: wrapper "
        f"ms={b3['ms']:.5f}, parity_decode_op ms={b3['op_ms']:.5f}, "
        f"LinearScheme.decode_one ms={b3['decode_one_ms']:.5f}")
    for name in ("flash_attention", "decode_attention"):
        for label, one in (("", rows[name]), *(
                (f" {arch}", rows[name][key]) for key, arch in HEAD_ROWS)):
            log(f"[kernels] {name}{label} library call "
                f"(scaled_dot_product_attention) max abs err vs plain "
                f"{one['library_err']:.3e}, device "
                f"ms={one['library_device_ms']:.5f}")
    return rows


# ------------------------------------------------------------ phase 3 ----
def train_deployed(x, y):
    """The deployed MLP, 3 epochs of Adam on softmax cross-entropy."""
    params, fwd = build("mlp", 0, image_shape=IMG, device=DEV)
    params = tree_map(lambda p: p.requires_grad_(True), params)
    leaves = tree_leaves(params)
    opt = AdamConfig(lr=1e-3)
    state = adam_init(params, opt)
    for xb, yb in batched(x, y, 64, epochs=3):
        loss = softmax_xent(fwd(params, xb), yb)
        grads = torch.autograd.grad(loss, leaves)
        adam_update(list(grads), state, leaves, opt)
    return params, fwd, loss.item()


def serve(spec, xs, gap_s=0.008, timeout=120.0):
    with deploy(spec, engine="threads") as sess:
        t0 = time.perf_counter()
        futs = []
        for xq in xs:
            futs.append(sess.submit(xq))
            time.sleep(gap_s)                       # ~125 qps
        if not sess.wait_all(timeout=timeout):
            raise AssertionError("unanswered queries")
        wall = time.perf_counter() - t0
        stats = sess.stats()
    return futs, stats, wall


def phase_serve(x, y, xt, yt):
    params, fwd, loss = train_deployed(x, y)
    with torch.inference_mode():
        a_a = topk_accuracy(fwd(params, xt), yt)
    log(f"[serve] deployed MLP 784-200-100-10 trained: last loss "
        f"{loss:.4f}, A_a={a_a:.4f} on {len(xt)} test images")
    pp, scheme = train_parity_models(
        params, fwd, lambda s: build("mlp", s, image_shape=IMG,
                                     device=DEV)[0],
        x, k=K, epochs=5, device=DEV)
    log(f"[serve] provisioned scheme={scheme.name} k={scheme.k} "
        f"r={scheme.r} backend={scheme.backend} device={scheme.device}")

    n = 120
    xs = [xt[i:i + 1] for i in range(n)]

    def straggle(iid):
        return 0.150 if iid == 0 else 0.0

    spec = DeploymentSpec(
        fwd=fwd, params=params, parity_params=pp[0], strategy="parm",
        scheme=scheme, k=K, m=4, delay_fn=straggle, device=DEV,
        batching=BatchingPolicy(max_size=4, max_delay_ms=2.0))
    cnt = ops.counters()
    futs, stats, wall = serve(spec, xs)
    by = stats.completed_by
    if sum(by.values()) != n or by.get("parity", 0) == 0:
        raise AssertionError(f"serve: completed_by={by}")
    lat = np.array([f.latency_ms for f in futs])
    par = [f for f in futs if f.completed_by == "parity"]
    acc_par = float(np.mean([np.argmax(f.result()) == yt[f.qid]
                             for f in par]))
    check_served(futs, xs, params, pp[0], fwd)
    log(f"[serve] {n} queries in {wall:.2f} s: completed_by={by} "
        f"p50={np.percentile(lat, 50):.2f} ms "
        f"p99={np.percentile(lat, 99):.2f} ms; parity-path accuracy "
        f"{acc_par:.4f} (n={len(par)}); launches parity_encode="
        f"{cnt['parity_encode'].value} parity_decode="
        f"{cnt['parity_decode'].value}")

    # short second pass with every drain forced through the batched decode:
    # main instances are held 30 ms (instance 0 150 ms) while the parity
    # pool is not, so parities land first and member completions drain the
    # decodes through decode_one_many
    def hold_main(iid):
        if pool_of_iid(iid)[0] != "main":
            return 0.0
        return 0.150 if iid == 0 else 0.030

    before = cnt["multigroup_decode"].value
    runtime._FORCE_DECODE = "batched"
    try:
        futs2, stats2, _ = serve(spec.replace(delay_fn=hold_main), xs[:40])
    finally:
        runtime._FORCE_DECODE = None
    grew = cnt["multigroup_decode"].value - before
    if grew <= 0 or stats2.completed_by.get("parity", 0) == 0:
        raise AssertionError(
            f"batched pass: multigroup launches +{grew}, "
            f"completed_by={stats2.completed_by}")
    check_served(futs2, xs[:40], params, pp[0], fwd)
    log(f"[serve] batched-decode pass: completed_by={stats2.completed_by} "
        f"multigroup_decode launches +{grew}")
    return params, fwd, pp, scheme, a_a, acc_par, lat


def check_served(futs, xs, params, pparams, fwd):
    """Every answer is finite with the model's shape; model answers equal
    the deployed model on the query, parity answers equal the subtraction
    decode computed on the plain path (groups are consecutive qid pairs)."""
    with torch.inference_mode():
        model = to_host(fwd(params, np.concatenate(xs)))
        pairs = np.stack(xs).reshape(len(xs) // K, K, 1, -1)
        pout = to_host(fwd(pparams, pairs.sum(1)))           # [G, V]
    for f in futs:
        out = np.asarray(f.result())
        if out.shape != (1, 10) or not np.isfinite(out).all():
            raise AssertionError(f"qid {f.qid}: bad answer {out!r}")
        i = f.qid
        if f.completed_by == "model":
            want = model[i:i + 1]
        else:
            g, j = divmod(i, K)
            want = pout[g:g + 1] - model[g * K + (1 - j):g * K + (2 - j)]
        np.testing.assert_allclose(out, want, atol=1e-3, rtol=1e-3,
                                   err_msg=f"qid {i} ({f.completed_by})")


# ------------------------------------------------------------ phase 4 ----
def a_d(scheme, params, pp, fwd, xt, yt):
    G = len(xt) // K
    groups = xt[:G * K].reshape(G, K, *IMG)
    glabels = yt[:G * K].reshape(G, K)
    with torch.inference_mode():
        member = fwd(params, groups.reshape(G * K, *IMG)).reshape(G, K, 10)
        pouts = fused_parity_outputs(scheme, np.moveaxis(groups, 1, 0), pp,
                                     fwd)                       # [r, G, V]
        return degraded_accuracy(pouts.transpose(0, 1), member, glabels,
                                 scheme), to_host(pouts)


# ------------------------------------------------------------ phase 5 ----
# the JAX package's CI-smoke settings for the registry's A_d ranking
# (benchmarks/accuracy.py:bench_ci_smoke) and its CPU values there
# (benchmarks/BENCH_baseline.json, acc_unavail_*_Ad): accuracies, printed
# only for comparison
SCHEME_SETTINGS = dict(n_train=2000, n_test=400, noise=0.8, deployed_epochs=5,
                       parity_epochs=5, seed=0, k=K)
REFERENCE_A_D = {"sum": 0.2375, "concat": 0.39, "learned": 0.22,
                 "approx_backup": 1.0, "approxifer": 0.945, "fisher": 0.945,
                 "invnet": 0.945}
RESNET_IMG = (32, 32, 3)
# parity outputs (logits) of the kernel path against the plain twin: the
# kernels sum in another order than the plain path's einsum, and the
# difference passes through the resnet's convolutions
POUT_TOL = 1e-3


def counts():
    return {name: c.value for name, c in ops.counters().items()}


class Uncounted:
    """Launch counts of the comparison runs inside a path, which the path's
    own counts leave out."""

    def __init__(self):
        self.n = collections.Counter()

    @contextlib.contextmanager
    def __call__(self):
        before = counts()
        yield
        for name, v in counts().items():
            self.n[name] += v - before[name]


def phase_schemes(uncounted):
    prov = {}
    res = unavail.accuracy_under_unavailability(device=DEV, provisioned=prov,
                                                **SCHEME_SETTINGS)
    params, fwd = prov["deployed"]
    xt, yt = prov["test"]
    a_a, ads = res["A_a"], res["schemes"]
    log(f"[schemes] resnet18s trained on the card: A_a={a_a:.4f} on "
        f"{len(xt)} test images")
    rows = {}
    with uncounted():
        for name, a_d in ads.items():
            scheme, pp, pfwd = prov[name]
            twin = dataclasses.replace(scheme, backend="torch")
            ad_twin = unavail._degraded(twin, pp, pfwd, params, fwd, xt, yt,
                                        10)
            _, p_k = unavail._outputs(scheme, pp, pfwd, params, fwd, xt, 10)
            _, p_t = unavail._outputs(twin, pp, pfwd, params, fwd, xt, 10)
            err = check_close(f"{name} parity outputs", p_k, p_t, POUT_TOL,
                              POUT_TOL)
            log(f"[schemes] {name:13s} A_d={a_d:.4f} plain-twin "
                f"A_d={ad_twin:.4f} (JAX package, CPU: "
                f"{REFERENCE_A_D[name]:.4f}); parity outputs max abs err "
                f"{err:.3e} (tolerance {POUT_TOL:g})")
            if abs(a_d - ad_twin) > 0.01:
                raise AssertionError(f"{name}: A_d {a_d} vs twin {ad_twin}")
            rows[name] = dict(A_d=a_d, A_d_plain=ad_twin, pout_err=err)
    if not a_a > 0.8:
        raise AssertionError(f"A_a={a_a}: the deployed resnet did not learn")
    if not ads["approxifer"] >= ads["sum"] - 0.05:
        raise AssertionError(f"approxifer A_d {ads['approxifer']} below sum "
                             f"{ads['sum']} - 0.05")
    return params, fwd, xt, a_a, rows


# ------------------------------------------------------------ phase 6 ----
def phase_errors():
    """The JAX package's error-rate sweep settings
    (benchmarks/accuracy.py:bench_error_rate_sweep) and the four properties
    its acceptance test asserts."""
    res = unavail.accuracy_under_errors(
        schemes=("sum", "approxifer"), error_rates=(0.0, 0.1, 0.25),
        n_train=1500, n_test=400, noise=0.8, k=K, r=2, deployed_epochs=3,
        parity_epochs=4, seed=0, device=DEV)
    s, a = res["schemes"]["sum"], res["schemes"]["approxifer"]
    log(f"[errors] A_a={res['A_a']:.4f} sum={s} approxifer={a}")
    checks = {"identical clean predictions": s[0.0] == a[0.0],
              "approxifer near-lossless at 10%": a[0.1] >= a[0.0] - 0.03,
              "robustness gap at 25%": a[0.25] > s[0.25] + 0.04,
              "sum degrades at 10%": s[0.1] < s[0.0] - 0.03}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"error sweep: {failed}: {res}")
    return {"sum": s, "approxifer": a}


# ------------------------------------------------------------ phase 7 ----
def phase_byzantine(params, fwd, xt, uncounted):
    """approxifer on the threads engine with the trained resnet18s."""
    cnt = ops.counters()
    xs = [xt[i:i + 1] for i in range(len(xt))]
    with torch.inference_mode():
        fwd(params, xs[0])                      # warm the batch-1 forward
    # (a) k=2, r=2, main server 1 corrupt and slow: its garbage arrives
    # after the clean member and both extra responses, so the vote evicts
    # it and its query is served from a clean reconstruction
    scen = Scenario("byzantine-deterministic", (
        DeterministicCorruption(targets=(("main", 1),), add_ms=700.0),
        DeterministicSlowdown(targets=(("main", 0),), add_ms=50.0),
        DeterministicSlowdown(targets=(("parity0", 0), ("parity1", 0)),
                              add_ms=300.0)))
    spec = DeploymentSpec(fwd=fwd, params=params,
                          parity_params=[params, params], strategy="parm",
                          scheme="approxifer", k=K, r=2, m=K, scenario=scen,
                          device=DEV)
    before = counts()
    sess = deploy(spec, engine="threads")
    try:
        sess.frontend.encode_fn(np.zeros((K,) + xs[0].shape, np.float32))
        futs = [sess.submit(x) for x in xs[:K]]
        if not sess.wait_all(timeout=60):
            raise AssertionError("byzantine: unanswered queries")
    finally:
        sess.shutdown()
    stats = sess.stats()
    if (stats.corrupted_detected, stats.corrected) != (1, 1):
        raise AssertionError(f"byzantine: detected={stats.corrupted_detected}"
                             f" corrected={stats.corrected}")
    with uncounted():
        check_served_approxifer(futs, xs[:K], params, fwd, spec)
    grew = counts()["berrut_encode"] - before["berrut_encode"]
    if grew <= 0:
        raise AssertionError("byzantine: berrut_encode was not launched")
    log(f"[byzantine] k=2 r=2: completed_by={stats.completed_by} "
        f"detected={stats.corrupted_detected} corrected={stats.corrected}; "
        f"answers equal the plain path; berrut_encode launches +{grew}")

    # (b) k=2, r=1 with instance 0 straggling: the r=1 rebuild is
    # approxifer's decode_one, through the subtraction-decode kernel
    def straggle(iid):
        return 0.150 if iid == 0 else 0.0

    spec1 = DeploymentSpec(fwd=fwd, params=params, parity_params=params,
                           strategy="parm", scheme="approxifer", k=K, m=4,
                           delay_fn=straggle, device=DEV)
    before = counts()
    futs, stats1, _ = serve(spec1, xs[:40])
    if stats1.completed_by.get("parity", 0) == 0:
        raise AssertionError(f"approxifer r=1: {stats1.completed_by}")
    with uncounted():
        check_served_approxifer(futs, xs[:40], params, fwd, spec1)
    grew = {name: counts()[name] - before[name]
            for name in ("berrut_encode", "parity_decode")}
    if min(grew.values()) <= 0:
        raise AssertionError(f"approxifer r=1 serve launches {grew}")
    log(f"[byzantine] k=2 r=1 straggler: completed_by={stats1.completed_by}; "
        f"answers equal the plain path; launches +{grew}")
    return stats, stats1


def check_served_approxifer(futs, xs, params, fwd, spec):
    """Model answers equal the deployed model; rebuilt answers equal the
    plain path's approxifer decode of the same member and parity outputs
    (groups are consecutive qid pairs)."""
    twin = get_scheme("approxifer", k=K, r=spec.r or 1, backend="torch",
                      device=DEV)
    with torch.inference_mode():
        model = to_host(fwd(params, np.concatenate(xs)))
        groups = np.stack(xs).reshape(len(xs) // K, K, *xs[0].shape)
        for f in futs:
            out = np.asarray(f.result())
            if out.shape != (1, 10) or not np.isfinite(out).all():
                raise AssertionError(f"qid {f.qid}: bad answer {out!r}")
            g, j = divmod(f.qid, K)
            if f.completed_by == "model":
                want = model[f.qid:f.qid + 1]
            else:
                enc = twin.encode(groups[g])                  # [r, 1, ...]
                pouts = torch.stack([fwd(params, enc[i])
                                     for i in range(twin.r)])
                outs = torch.as_tensor(model[g * K:(g + 1) * K, None],
                                       device=DEV)
                if twin.r == 1:
                    want = to_host(twin.decode_one(pouts[0], outs, j))
                else:
                    want = plain_rebuilds(twin, pouts, outs, j)
            if not any(np.allclose(out, w, atol=1e-3, rtol=1e-3)
                       for w in np.reshape(want, (-1,) + out.shape)):
                raise AssertionError(
                    f"qid {f.qid} ({f.completed_by}): {out} is none of the "
                    f"plain path's answers {want}")


def plain_rebuilds(twin, pouts, outs, j):
    """Member j rebuilt on the plain path from the other members and each
    set of parity responses that can have been in hand when the decode ran:
    the first parity to land makes the group recoverable, so one parity
    alone, or all of them where they landed together."""
    miss = np.arange(K) == j
    sets = [np.arange(twin.r) == i for i in range(twin.r)]
    sets.append(np.ones(twin.r, bool))
    return np.stack([to_host(twin.decode(
        pouts * torch.as_tensor(pa, device=DEV)[:, None, None], outs, miss,
        pa))[j] for pa in sets])


# ------------------------------------------------------------ phase 8 ----
# coded LM serving at the full width of qwen2-0.5b (24 layers, d_model 896,
# 14 heads over 2 KV heads, vocab 151936, bf16), random weights from seed 0
LM_ARCH = "qwen2-0.5b"
LM_SLOTS, LM_SEQ, LM_NEW, LM_REQUESTS = 4, 1280, 16, 8
# A served token may differ from the uncoded greedy loop's only at a bf16
# near-tie: the loop's top-2 logit gap at that step below LM_GAP_TOL, and the
# served token the loop's runner-up.  The server decodes four slots per GEMM
# where the loop decodes one, so the sums round differently in bf16.
LM_GAP_TOL = 0.1
# max |logit| difference between the kernel path and the "torch" backend on
# one teacher-forced sequence: B7 and B8, like the torch twin, round P to
# bf16 before P.V, but against other running maxima (per key tile, per
# 16-slot chunk of each CTA), and the difference passes through 24 bf16
# layers
LM_LOGIT_TOL = 0.1


def lm_prompts(vocab):
    """LM_REQUESTS prompts of 256-1024 random tokens (seeded)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(256, 1025, LM_REQUESTS)]


def lm_greedy(cfg, params, prompt, seq=LM_SEQ, **context):
    """The uncoded greedy loop over the port's prefill / decode_step (batch
    1, scalar pos, a cache of ``seq`` positions, ``context`` the prefill's
    cross_embeds where the plan takes one): tokens, each step's top-2 logit
    gap and runner-up, and each step's eight best tokens with their gaps to
    the best."""
    toks, gaps, second, ranked = [], [], [], []
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, tokens=torch.tensor(
            [prompt], device=DEV), cache_len=seq, **context)
        row = logits[0, -1]
        for pos in range(len(prompt), len(prompt) + LM_NEW):
            top = torch.topk(row, 8)
            toks.append(int(top.indices[0]))
            second.append(int(top.indices[1]))
            gaps.append(float(top.values[0] - top.values[1]))
            ranked.append(dict(zip(top.indices.tolist(),
                                   (top.values[0] - top.values).tolist())))
            if len(toks) == LM_NEW:
                break
            logits, cache = T.decode_step(
                cfg, params, cache, pos,
                token=torch.tensor([[toks[-1]]], device=DEV))
            row = logits[0, 0]
    return toks, gaps, second, ranked


def check_tokens(label, served, loop, any_rank=False):
    """Served tokens against the loop's, under the near-tie rule; returns
    (step, gap) where they first differ, or None.  The served token must be
    the loop's runner-up at a top-2 gap below LM_GAP_TOL or, with
    ``any_rank`` (phase 10), any of the loop's eight best within LM_GAP_TOL
    of its best: an SSM carries the server's batch-4 rounding forward in
    its state, and its bf16 logits meet three-way near-ties."""
    toks, gaps, second, ranked = loop
    if len(served) != LM_NEW:
        raise AssertionError(f"{label}: {len(served)} tokens, not {LM_NEW}")
    for t, (a, b) in enumerate(zip(served, toks)):
        if a != b:
            if gaps[t] < LM_GAP_TOL and a == second[t]:
                return t, gaps[t]
            if any_rank and ranked[t].get(a, LM_GAP_TOL) < LM_GAP_TOL:
                return t, ranked[t][a]
            raise AssertionError(
                f"{label}: token {t} is {a}, the loop's is {b} (top-2 gap "
                f"{gaps[t]:.4f}, runner-up {second[t]}, the served token's "
                f"gap to the best {ranked[t].get(a, 'beyond the top 8')})")
    return None


def lm_teacher_forced(cfg, params, prompt, cont):
    """Prefill and 8 teacher-forced decode steps through the kernels and
    through the "torch" backend; max abs logit difference and max |logit|."""
    out = {}
    for backend in ("kernels", "torch"):
        c = cfg.replace(attn_backend=backend)
        with torch.inference_mode():
            logits, cache = T.prefill(c, params, tokens=torch.tensor(
                [prompt], device=DEV), cache_len=LM_SEQ)
            rows = [logits[0, -1]]
            for j, tok in enumerate(cont[:8]):
                logits, cache = T.decode_step(
                    c, params, cache, len(prompt) + j,
                    token=torch.tensor([[tok]], device=DEV))
                rows.append(logits[0, 0])
        out[backend] = torch.stack(rows)
    err = float((out["kernels"] - out["torch"]).abs().max())
    return err, float(out["torch"].abs().max())


def lm_serve(cfg, params, prompts, straggle_ms, delay_fn=None,
             parity_params=None, mesh=None):
    spec = GenerationSpec(
        cfg=cfg, params=params, parity_params=parity_params, k=K, r=1,
        scheme="sum",
        batching=BatchingPolicy(max_size=LM_SLOTS), max_seq_len=LM_SEQ,
        max_new_tokens=LM_NEW, straggle_ms=straggle_ms, delay_fn=delay_fn,
        mesh=mesh, device=DEV)
    t0 = time.perf_counter()
    with deploy_lm(spec, engine="threads") as sess:
        t1 = time.perf_counter()
        futs = [sess.submit(p) for p in prompts]
        if not sess.wait_all(timeout=300.0):
            raise AssertionError("lm: unfinished requests")
        t2 = time.perf_counter()
        stats = sess.stats()
    return futs, stats, t1 - t0, t2 - t1


def log_serve(label, stats, setup_s, serve_s, straggle_ms, tag="lm"):
    log(f"[{tag}] {label}: straggle_ms={straggle_ms:.1f} set-up {setup_s:.2f} s "
        f"(warm-up included), served in {serve_s:.2f} s; "
        f"completed_by={stats.completed_by} "
        f"reconstructed_steps={stats.reconstructed_steps} "
        f"tokens_per_s={stats.tokens_per_s:.1f} inter-token "
        f"p50={stats.inter_token_p50_ms:.2f} ms p99={stats.p99_ms:.2f} ms "
        f"(n={stats.n} samples, {max(0, int(stats.n * 0.01))} beyond p99)")


def host_ms(fn, iters=5, warmup=1):
    """Host-clock time of one call of ``fn`` under inference mode,
    synchronized, mean of ``iters`` after ``warmup`` calls."""
    with torch.inference_mode():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def decode_step_ms(cfg, params, pos, seq=LM_SEQ):
    """Host-clock time of one full-width decode step at batch LM_SLOTS with
    per-row positions over a pool of ``seq`` positions, synchronized, mean
    of 20 after a warm-up."""
    cache = T.init_cache(cfg, LM_SLOTS, seq, device=DEV)
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=DEV)
    pos = torch.tensor(pos, device=DEV)
    return host_ms(lambda: T.decode_step(cfg, params, cache, pos, token=tok),
                   iters=20, warmup=3)


def prefill_ms(cfg, params, prompt, seq=LM_SEQ, **context):
    """Host-clock time of one full-width prefill of ``prompt`` at batch 1
    into a cache of ``seq`` positions (with the plan's ``context``),
    synchronized, mean of 5 after a warm-up."""
    toks = torch.tensor([prompt], device=DEV)
    return host_ms(lambda: T.prefill(cfg, params, tokens=toks, cache_len=seq,
                                     **context))


def device_profile(fn):
    """Run ``fn`` under torch.profiler: (wall s, device-busy s, device
    operations launched), the last two summed over the device-side events
    (kernels, copies, fills; host ops also carry the device time of what
    they launch, so they are left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy += ev.self_device_time_total / 1e6
            n += ev.count
    return wall, busy, n


def check_straggler_serve(label, futs, stats, loops, tag="lm",
                          any_rank=False):
    """Member 0 late on every job: its streams rebuilt, member 1's equal to
    the uncoded loop (up to bf16 near-ties).  Returns the share of member
    0's tokens that match the loop's."""
    # slots fill member 0 first: rids 0-3 live on member 0, 4-7 on member 1
    member1 = [f for f in futs if f.rid >= LM_SLOTS]
    member0 = [f for f in futs if f.rid < LM_SLOTS]
    if not stats.reconstructed_steps > 0 or any(
            len(f.result()) != LM_NEW for f in futs):
        raise AssertionError(f"lm {label} run: {stats}")
    if any(f.reconstructed_steps for f in member1) or not all(
            f.reconstructed_steps for f in member0):
        raise AssertionError(f"lm {label} run: reconstructions by rid "
                             f"{[f.reconstructed_steps for f in futs]}")
    ties = {f.rid: check_tokens(f"rid {f.rid}", f.result(), loops[f.rid],
                                any_rank) for f in member1}
    agree = float(np.mean([a == b for f in member0
                           for a, b in zip(f.result(), loops[f.rid][0])]))
    log(f"[{tag}] {label}: member-1 streams equal the uncoded loop "
        f"(near-tie (step, gap) by rid: {ties}); member-0 streams rebuilt "
        f"{[f.reconstructed_steps for f in member0]} steps, their tokens "
        f"match the loop's in {agree:.2%} of places (the sum parity is an "
        f"approximation for a nonlinear model)")
    return agree


def phase_lm():
    cfg = get_config(LM_ARCH)
    params = T.init_params(cfg, 0, device=DEV)
    log(f"[lm] {cfg.name} ({cfg.source}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
        f"head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}; {T.param_count(params) / 1e6:.1f} M "
        f"params from seed 0")
    prompts = lm_prompts(cfg.vocab)
    log(f"[lm] {len(prompts)} prompts of {sorted(map(len, prompts))} tokens")

    # comparisons first, before the path's counters are zeroed
    t0 = time.perf_counter()
    loops = [lm_greedy(cfg, params, p) for p in prompts]
    min_gap = min(min(loop[1]) for loop in loops)
    err, scale = lm_teacher_forced(cfg, params, prompts[0], loops[0][0])
    log(f"[lm] uncoded greedy loop over {len(prompts)} prompts in "
        f"{time.perf_counter() - t0:.2f} s (smallest top-2 gap "
        f"{min_gap:.4f}); kernel path vs torch backend, teacher-forced "
        f"prefill + 8 decode steps: max abs logit err {err:.4f} "
        f"(max |logit| {scale:.3f}, tolerance {LM_LOGIT_TOL:g})")
    if not err <= LM_LOGIT_TOL:
        raise AssertionError(f"lm: kernel logits {err} from the torch "
                             f"backend's")

    for c in [*ops.counters().values(), *k_flash.route_launches.values(),
              *k_dattn.route_launches.values()]:
        c.reset()
    uncounted = Uncounted()
    futs, clean, setup_s, serve_s = lm_serve(cfg, params, prompts, 10_000.0)
    served = [f.result() for f in futs]
    log_serve("no straggler", clean, setup_s, serve_s, 10_000.0)
    ties = {f.rid: check_tokens(f"rid {f.rid}", f.result(), loops[f.rid])
            for f in futs}
    if clean.reconstructed_steps or clean.n != LM_REQUESTS * LM_NEW:
        raise AssertionError(f"lm clean run: {clean}")
    log(f"[lm] no straggler: all {LM_REQUESTS} requests answered "
        f"{LM_NEW} tokens equal to the uncoded loop "
        f"(first differing (step, top-2 gap) at a near-tie, by rid: "
        f"{ {r: t for r, t in ties.items() if t is not None} })")

    # the decode step alone, while no serving thread runs, and where a
    # served token's time goes (uncounted)
    pos = [len(p) + LM_NEW // 2 for p in prompts[:LM_SLOTS]]
    longest = max(prompts, key=len)
    with uncounted():
        step_ms = decode_step_ms(cfg, params, pos)
        pre_ms = prefill_ms(cfg, params, longest)
        cache = T.init_cache(cfg, LM_SLOTS, LM_SEQ, device=DEV)
        tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=DEV)

        def three_steps():
            with torch.inference_mode():
                for _ in range(3):
                    T.decode_step(cfg, params, cache, torch.tensor(
                        pos, device=DEV), token=tok)
        _, step_busy, step_ops = device_profile(three_steps)
        serve_wall, serve_busy, _ = device_profile(
            lambda: lm_serve(cfg, params, prompts, 10_000.0))
    log(f"[lm] profiled: one decode step issues {step_ops / 3:.0f} device "
        f"operations and keeps the device busy {step_busy / 3 * 1e3:.3f} ms;"
        f" a clean serve under the profiler keeps it busy "
        f"{serve_busy:.3f} s of {serve_wall:.3f} s "
        f"({100 * serve_busy / serve_wall:.1f}%)")

    # the deadline well above the clean run's step, the straggler well
    # past it on every job
    straggle_ms = max(25.0, 3.0 * clean.inter_token_p50_ms)
    delay_s = 1.5 * straggle_ms / 1e3
    slow = instance_id("main", 0)

    def delay(iid):
        return delay_s if iid == slow else 0.0

    futs, strag, setup_s, serve_s = lm_serve(cfg, params, prompts,
                                             straggle_ms, delay)
    log_serve(f"member 0 delayed {delay_s * 1e3:.0f} ms per job", strag,
              setup_s, serve_s, straggle_ms)
    agree = check_straggler_serve("straggler", futs, strag, loops)
    path3 = {name: v - uncounted.n[name] for name, v in counts().items()}
    routes = {name: c.value for name, c in k_flash.route_launches.items()}
    if routes != {"wgmma": counts()["flash_attention"], "simt": 0}:
        raise AssertionError(f"lm: B7 launches by route {routes}, of "
                             f"{counts()['flash_attention']} in phase 8: not "
                             f"all on the tensor-core route")
    log(f"[lm] B7 on the LM path: {path3['flash_attention']} launches, every "
        f"launch of phase 8 on the tensor-core route (comparison runs "
        f"included: {routes})")
    droutes = {name: c.value for name, c in k_dattn.route_launches.items()}
    if droutes != {"mma": counts()["decode_attention"], "simt": 0}:
        raise AssertionError(f"lm: B8 launches by route {droutes}, of "
                             f"{counts()['decode_attention']} in phase 8: "
                             f"not all on the tensor-core route")
    log(f"[lm] B8 on the LM path: {path3['decode_attention']} launches, every "
        f"launch of phase 8 on the tensor-core route (mma.sync; comparison "
        f"runs included: {droutes})")

    kv_len = int(np.mean(pos)) + 1
    roof_ms = 1e3 * decode_token_cost(cfg, batch=LM_SLOTS, kv_len=kv_len)
    log(f"[roofline] decode step batch {LM_SLOTS} at pos {pos}: measured "
        f"{step_ms:.3f} ms (host clock, synchronized, mean of 20); H100 SXM "
        f"roofline decode_token_cost(batch={LM_SLOTS}, kv_len={kv_len}) "
        f"{roof_ms:.4f} ms; ratio {step_ms / roof_ms:.1f}; prefill of the "
        f"longest prompt ({len(longest)} tokens, batch 1) {pre_ms:.3f} ms "
        f"(host clock, synchronized, mean of 5); serving "
        f"inter-token p50 {clean.inter_token_p50_ms:.2f} ms with "
        f"{K} members and a parity instance on threads")
    return path3, dict(
        clean={"completed_by": clean.completed_by, "n": clean.n,
               "tokens_per_s": clean.tokens_per_s,
               "p50_ms": clean.inter_token_p50_ms, "p99_ms": clean.p99_ms},
        straggler={"completed_by": strag.completed_by, "n": strag.n,
                   "reconstructed_steps": strag.reconstructed_steps,
                   "straggle_ms": straggle_ms,
                   "tokens_per_s": strag.tokens_per_s,
                   "p50_ms": strag.inter_token_p50_ms,
                   "p99_ms": strag.p99_ms},
        logit_err=err, decode_step_ms=step_ms, roofline_ms=roof_ms,
        prefill_ms=pre_ms, prefill_tokens=len(longest),
        flash_routes={"wgmma": path3["flash_attention"], "simt": 0},
        decode_routes={"mma": path3["decode_attention"], "simt": 0},
        decode_step_device_ms=step_busy / 3 * 1e3,
        decode_step_device_ops=step_ops / 3,
        serve_device_busy_share=serve_busy / serve_wall,
        rebuilt_token_agreement=agree), dict(
        cfg=cfg, params=params, prompts=prompts, loops=loops,
        served=served, straggle_ms=straggle_ms, agree=agree)


# ------------------------------------------------------------ phase 9 ----
# parity training at the full width of qwen2-0.5b: phase 8's deployed model
# (seed 0) is the teacher, the parity model starts from seed 1.  Each step
# draws one TRAIN_SEQ-token sequence per member, uniform tokens as phase 8's
# prompts are, so training covers every position the served streams reach.
# TRAIN_LR: Adam's new value is rounded to the bf16 parameter's 8-bit
# mantissa, so a step below half an ulp of a weight is lost (the embedding
# entries, ~0.02, need about 1e-4).  ``--distil-lrs`` runs the distillation
# alone at other rates: 3e-4, 1e-3 and 3e-3 ended further above the MSE of
# a parity model answering zeros than 1e-4 did (readings in PERF.md).
TRAIN_STEPS, TRAIN_SEQ, TRAIN_LR = 60, 1024, 1e-4
JOINT_STEPS = 3
# the last 5 steps' mean MSE at most this share of the first 5 steps'
# (the reference's test_lm_parity_training_loss_decreases)
TRAIN_DROP = 0.7
# the custom VJP against autograd through B7's plain version (naive fp32
# softmax attention) on the same inputs, at qwen2-0.5b's training prefill
# (as tests/test_torch_gpu.py)
VJP_SHAPES = ((1, TRAIN_SEQ, 14, 64), (1, TRAIN_SEQ, 2, 64),
              (1, TRAIN_SEQ, 2, 64))
VJP_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# remat's gradients against no remat's at full width: at most this share of
# the largest gradient (one bf16 ulp of a reordered sum is 2^-8 of it)
REMAT_RTOL = 1e-2
# one parity step's gradients on the card against the same step on the CPU
# at reduced qwen2-0.5b (fp32): every leaf's max abs difference at most this
# share of its max |gradient| (the two differ by fp32 summation order), and
# the loss within it too
GRAD_RTOL = 1e-3


def card_vs_cpu_grads():
    """One reduced qwen2-0.5b parity step (``parity_loss_fn(remat=True)``,
    the loss of ``make_parity_train_step``) on the card, its teacher through
    B7, its forward and backward through the custom VJP, against the same
    step on the CPU from the same parameters and tokens.  Every leaf's
    gradient must be non-zero on the card and agree with the CPU's."""
    rcfg = get_config(LM_ARCH, reduced=True)
    host = {"deployed": T.init_params(rcfg, 0, device="cpu"),
            "parity": T.init_params(rcfg, 1, device="cpu")}
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (K, 2, 64))
    out = {}
    for dev in ("cpu", DEV):
        p = tree_map(lambda t: t.clone().to(dev), host)
        batch = member_batch(rcfg, p["deployed"],
                             torch.as_tensor(toks, device=dev))
        loss, grads = value_and_grad(parity_loss_fn(rcfg, remat=True),
                                     p["parity"], batch)
        out[dev] = float(loss), [g.detach().cpu() for g in grads]
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[DEV]
    rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for a, b in zip(g_card, g_cpu)]
    zero = sum(int(not bool(a.abs().max() > 0)) for a in g_card)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"[train] one reduced parity step ({rcfg.name}, k={K}, tokens "
        f"[{K},2,64], fp32) on the card against the CPU: loss {l_card:.6f} "
        f"vs {l_cpu:.6f}; over its {len(g_card)} gradient leaves max abs "
        f"difference / max |gradient| at most {max(rel):.2e} (tolerance "
        f"{GRAD_RTOL:g}); leaves with no gradient on the card: {zero}")
    if zero or max(rel) > GRAD_RTOL or loss_rel > GRAD_RTOL:
        raise AssertionError(f"train: card step gradients {rel}, {zero} "
                             f"zero leaves, loss {l_card} vs {l_cpu}")
    return {"max_rel_grad_diff": max(rel), "zero_leaves": zero,
            "loss_card": l_card, "loss_cpu": l_cpu}


def teacher_vs_torch(cfg, deployed, toks, teacher):
    """The teacher logits of ``member_batch`` (B7) against the "torch"
    backend's on the same tokens: (max abs difference, max |logit|)."""
    with torch.no_grad():
        want = torch.stack([T.forward(grad_cfg(cfg), deployed, tokens=t)[0]
                            for t in toks]).float()
    return float((teacher.float() - want).abs().max()), \
        float(want.abs().max())


def check_vjp():
    """_FlashCore's output and dq/dk/dv on the card against autograd
    through B7's plain version (naive softmax attention, fp32 inputs), in
    fp32 and bf16; max abs errors by dtype."""
    gen = torch.Generator(device=DEV).manual_seed(9)
    out = {}
    for dt, tol_ in VJP_TOL.items():
        ins = [randn(gen, shape, dt).requires_grad_(True)
               for shape in VJP_SHAPES]
        cot = randn(gen, VJP_SHAPES[0], torch.float32)
        o = L.flash_attention_xla(*ins)
        got = torch.autograd.grad((o.float() * cot).sum(), ins)
        ins32 = [t.detach().float().requires_grad_(True) for t in ins]
        want_o = ref.flash_attention_ref(*ins32)
        want = torch.autograd.grad((want_o * cot).sum(), ins32)
        errs = [check_close(f"vjp {name} {dt}", g.detach(), w, tol_, tol_)
                for name, g, w in zip(("out", "dq", "dk", "dv"),
                                      (o, *got), (want_o, *want))]
        out[str(dt).removeprefix("torch.")] = max(errs)
        log(f"[train] _FlashCore vs autograd through "
            f"ref.flash_attention_ref (fp32 inputs), q {list(VJP_SHAPES[0])} k/v {list(VJP_SHAPES[1])} {dt}: max "
            f"abs err out/dq/dk/dv {[f'{e:.2e}' for e in errs]} (atol = "
            f"rtol = {tol_:g})")
    return out


def member_batch(cfg, params, toks):
    """Member embeddings and the deployed model's logits for ``toks`` [k, 1,
    S], made without a graph (not under inference_mode: autograd refuses to
    save inference tensors); the teacher's attention runs the flash kernel."""
    with torch.no_grad():
        return {"embeds": torch.stack([T.embed_tokens(cfg, params, t)
                                       for t in toks]),
                "teacher": torch.stack([T.forward(cfg, params, tokens=t)[0]
                                        for t in toks])}


def draw_members(rng, vocab):
    return torch.as_tensor(rng.integers(0, vocab, (K, 1, TRAIN_SEQ)),
                           device=DEV)


def distil(cfg, deployed, rng, lr=TRAIN_LR):
    """TRAIN_STEPS of make_parity_train_step(remat=True) from seed 1, the
    first batch's teacher logits also held against the "torch" backend.
    Returns the trained parity params, the last batch and the numbers."""
    parity = T.init_params(cfg, 1, device=DEV)
    opt = AdamConfig(lr=lr)
    state = adam_init(parity, opt)
    step = make_parity_train_step(cfg, opt, remat=True)
    losses, teach_ms, step_ms, zero = [], [], [], []
    b7 = counts()["flash_attention"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        toks = draw_members(rng, cfg.vocab)
        t0 = time.perf_counter()
        batch = member_batch(cfg, deployed, toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            t_err, t_scale = teacher_vs_torch(cfg, deployed, toks,
                                              batch["teacher"])
            log(f"[train] teacher logits through B7 vs the torch backend "
                f"on the first batch ({K} x {TRAIN_SEQ} tokens): max abs "
                f"err {t_err:.4f} (max |logit| {t_scale:.3f}, tolerance "
                f"{LM_LOGIT_TOL:g})")
            if not t_err <= LM_LOGIT_TOL:
                raise AssertionError(f"train: teacher logits {t_err} from "
                                     f"the torch backend's")
            torch.cuda.synchronize()
        t1b = time.perf_counter()
        parity, state, m = step(parity, state, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.append(float(m["loss"]))
        teach_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1b) * 1e3)
        # the MSE of a parity model that answered zeros
        zero.append(float(batch["teacher"].sum(0).square().mean()))
    peak = torch.cuda.max_memory_allocated()
    b7 = counts()["flash_attention"] - b7
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    zero5 = float(np.mean(zero[-5:]))
    med_step, med_teach = float(np.median(step_ms)), float(np.median(
        teach_ms))
    tok_s = K * TRAIN_SEQ / ((med_step + med_teach) / 1e3)
    log(f"[train] distillation: {TRAIN_STEPS} steps of "
        f"make_parity_train_step(remat=True), k={K}, one {TRAIN_SEQ}-token "
        f"sequence per member per step, Adam lr {lr:g}, {cfg.dtype} "
        f"parameters, fp32 moments; MSE by step {[round(x, 4) for x in losses]}")
    log(f"[train] lr {lr:g}: mean MSE first 5 steps {first:.4f}, last 5 "
        f"steps {last:.4f} (ratio {last / first:.3f}); a parity model "
        f"answering zeros would score {zero5:.4f} on the last 5 batches "
        f"(ratio {last / zero5:.3f}) and {np.mean(zero):.4f} over all "
        f"{TRAIN_STEPS}")
    log(f"[train] median train step {med_step:.2f} ms, median teacher "
        f"forwards {med_teach:.2f} ms (host clock, synchronized); "
        f"{tok_s:.0f} member tokens/s ({K}x{TRAIN_SEQ} per step, teacher "
        f"included); peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated); B7 launches during the teacher forwards "
        f"{b7} ({TRAIN_STEPS} steps x {K} members x {cfg.n_layers} layers)")
    del state
    return parity, batch, dict(
        steps=TRAIN_STEPS, lr=lr, seq=TRAIN_SEQ, losses=losses,
        first5=first, last5=last, zero_answer_mse=float(np.mean(zero)),
        zero_answer_mse_last5=zero5, teacher_vs_torch_err=t_err,
        step_ms=med_step, teacher_ms=med_teach,
        member_tokens_per_s=tok_s, peak_bytes=peak, teacher_b7=b7)


def check_distil(cfg, dist):
    first, last = dist["first5"], dist["last5"]
    if not np.all(np.isfinite(dist["losses"])) or \
            not last <= TRAIN_DROP * first:
        raise AssertionError(f"train: MSE {first} -> {last}")
    if dist["teacher_b7"] != TRAIN_STEPS * K * cfg.n_layers:
        raise AssertionError(f"train: {dist['teacher_b7']} B7 launches in "
                             f"the teacher")


def remat_grad_diff(cfg, parity, batch):
    """One step's gradients with and without remat, on the same params and
    batch: max abs difference and max |gradient|; and the remat'd forward
    and backward under torch.profiler: (wall s, device-busy s, device
    operations)."""
    grads = []

    def fwd_bwd(remat):
        grads.append(value_and_grad(parity_loss_fn(cfg, remat=remat),
                                    parity, batch)[1])

    prof = device_profile(lambda: fwd_bwd(True))
    fwd_bwd(False)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(*grads))
    scale = max(float(a.float().abs().max()) for a in grads[0])
    zero = sum(int(not bool(a.abs().max() > 0)) for a in grads[0])
    log(f"[train] one step's gradients with remat on and off: max abs "
        f"difference {diff:.3e} (max |gradient| {scale:.3e}, tolerance "
        f"{REMAT_RTOL:g} of it); leaves with no gradient: {zero} of "
        f"{len(grads[0])}")
    if zero or not diff <= REMAT_RTOL * scale:
        raise AssertionError(f"train: remat gradients differ by {diff}, "
                             f"{zero} leaves without a gradient")
    return diff, scale, prof


def joint_steps(cfg, deployed, rng):
    """JOINT_STEPS of make_joint_parity_train_step with ``learned``, r=1, at
    full width: the loss stays finite and the encoder's alpha leaves 0."""
    scheme = get_scheme("learned", k=K, r=1, device=DEV)
    params = {"enc": tree_map(torch.clone, scheme.enc_params),
              "parity": [T.init_params(cfg, 2, device=DEV)]}
    opt = AdamConfig(lr=TRAIN_LR)
    state = adam_init(params, opt)
    step = make_joint_parity_train_step(cfg, opt, scheme, remat=True)
    losses = []
    for _ in range(JOINT_STEPS):
        batch = member_batch(cfg, deployed, draw_members(rng, cfg.vocab))
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    alpha = float(params["enc"]["alpha"].detach())
    log(f"[train] joint learned-encoder + parity training, r=1: losses "
        f"{[round(x, 4) for x in losses]}, encoder alpha {alpha:.3e} "
        f"(starts at 0)")
    if not np.all(np.isfinite(losses)) or alpha == 0.0:
        raise AssertionError(f"joint training: {losses}, alpha {alpha}")
    return losses, alpha


def phase_train(lm_ctx):
    cfg, deployed = lm_ctx["cfg"], lm_ctx["params"]
    rng = np.random.default_rng(1)
    parity, batch, dist = distil(cfg, deployed, rng)
    check_distil(cfg, dist)
    diff, scale, grad_prof = remat_grad_diff(cfg, parity, batch)
    del batch
    toks = draw_members(rng, cfg.vocab)
    teach_prof = device_profile(lambda: member_batch(cfg, deployed, toks))
    log(f"[train] profiled: the teacher forwards keep the device busy "
        f"{teach_prof[1] * 1e3:.2f} ms of {teach_prof[0] * 1e3:.2f} ms "
        f"({teach_prof[2]} device operations); the parity model's remat'd "
        f"forward and backward {grad_prof[1] * 1e3:.2f} ms of "
        f"{grad_prof[0] * 1e3:.2f} ms ({grad_prof[2]} device operations)")
    joint, alpha = joint_steps(cfg, deployed, rng)

    # phase 8's straggler serve again, the parity instance on the trained
    # model
    straggle_ms = lm_ctx["straggle_ms"]
    slow = instance_id("main", 0)

    def delay(iid):
        return 1.5 * straggle_ms / 1e3 if iid == slow else 0.0

    before = counts()
    futs, strag, setup_s, serve_s = lm_serve(
        cfg, deployed, lm_ctx["prompts"], straggle_ms, delay,
        parity_params=parity)
    served = {name: counts()[name] - before[name]
              for name in ("flash_attention", "decode_attention")}
    log_serve("trained parity, member 0 delayed", strag, setup_s, serve_s,
              straggle_ms)
    if not all(served.values()):
        raise AssertionError(f"trained-parity serve launched {served}")
    agree = check_straggler_serve("trained parity", futs, strag,
                                  lm_ctx["loops"])
    log(f"[train] rebuilt member-0 tokens equal to the uncoded loop: "
        f"{agree:.2%} with the trained parity model, {lm_ctx['agree']:.2%} "
        f"with the deployed weights as parity (phase 8), "
        f"{1 / cfg.vocab:.2e} at random (1/{cfg.vocab})")

    # the reduced launcher end to end (fp32: B7's SIMT route)
    before = counts()
    simt = k_flash.route_launches["simt"].value
    futs, stats = launch_serve.main(["--device", DEV])
    launched = {name: counts()[name] - before[name]
                for name in ("parity_encode", "parity_decode",
                             "flash_attention")}
    simt = k_flash.route_launches["simt"].value - simt
    done = sum(stats["completed_by"].values())
    rebuilt = stats["completed_by"].get("parity", 0)
    log(f"[train] launch/serve (reduced qwen2-0.5b, fp32): {done} of "
        f"{len(futs)} queries answered, {rebuilt} rebuilt from parity; "
        f"launches {launched}, B7 on the SIMT route {simt}; the "
        f"trained-parity serve launched {served}")
    if done != len(futs) or not rebuilt:
        raise AssertionError(f"launch/serve: {stats['completed_by']}")
    if not all(launched.values()) or simt != launched["flash_attention"]:
        raise AssertionError(f"launch/serve launched {launched}, SIMT "
                             f"route {simt}")
    return dict(distillation=dist,
                remat_grad_max_abs_diff=diff, grad_max_abs=scale,
                profiled={"teacher": teach_prof, "fwd_bwd_remat": grad_prof},
                joint_losses=joint, joint_alpha=alpha,
                rebuilt_token_agreement_trained=agree,
                rebuilt_token_agreement_untrained=lm_ctx["agree"],
                random_agreement=1 / cfg.vocab,
                trained_serve={"completed_by": strag.completed_by,
                               "reconstructed_steps":
                                   strag.reconstructed_steps,
                               "tokens_per_s": strag.tokens_per_s},
                launch_serve={"completed_by": stats["completed_by"],
                              "n": len(futs)})


# ----------------------------------------------------------- phase 10 ----
# the MoE, SSM and hybrid LM paths: deepseek-moe-16b (28 MoE layers of 64
# routed experts, top-6, and 2 shared; 16 heads over 16 KV heads at head_dim
# 128; vocab 102400) and mamba2-780m (48 SSD layers, d_inner 3072, 48 heads
# of 64, state 128, tied embeddings) at full width in bf16, random weights
# from seed 0, served as phase 8 serves qwen2-0.5b; then reduced
# jamba-1.5-large-398b (mamba + MLP and attention + MoE layers, fp32)
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = ("deepseek-moe-16b", "mamba2-780m",
                                   "jamba-1.5-large-398b")
# kernels against the torch backend on one teacher-forced sequence, per
# position (max |logit difference| over the vocab): B7 and the torch scan
# round differently, and where that moves a router near-tie (64 experts,
# top-6) a token takes another expert, and with it the capacity places of
# the tokens after it.  The model amplifies any rounding difference so, and
# the same forward through the torch scan in another summation order shows
# how far: the kernel path's p99 and median are held to MOE_FLOOR_FACTOR
# times that floor's (or LM_LOGIT_TOL where the floor is below it).
MOE_FLOOR_FACTOR = 2.0
# mamba2-780m: prefill + 16 decode steps (the recurrence) against the
# teacher-forced forward (the chunked SSD) on the same tokens, per position.
# In fp32 (a copy of the same weights) held to HYBRID_PROP, the reference's
# tolerance; in bf16 each of the 48 layers rounds its output where the two
# algorithms differ, so the max is held to SSM_FLOOR_FACTOR times the bf16
# model's own distance from its fp32 copy (the forward in both), or to
# SSM_LOGIT_TOL where that is smaller
SSM_LOGIT_TOL, SSM_FLOOR_FACTOR = 0.1, 2.0
# reduced jamba (fp32, capacity factor 8 so that nothing drops): kernels vs
# torch backend as the card tests hold it, decode vs forward as the
# reference's tests/test_prefill_decode.py holds it
HYBRID_TOL, HYBRID_PROP = 2e-4, 2e-3


def gib(nbytes):
    return nbytes / 2 ** 30


def pct(d):
    """max, p99 and median of a 1-d tensor."""
    d = d.float().cpu().numpy()
    return float(d.max()), float(np.percentile(d, 99)), float(np.median(d))


@contextlib.contextmanager
def scan_block(block):
    """The torch backend's block scan over KV blocks of ``block`` keys
    instead of its default: the same function summed in another order."""
    default = L.flash_attention_xla
    L.flash_attention_xla = functools.partial(default, block=block)
    try:
        yield
    finally:
        L.flash_attention_xla = default


def backends_per_position(cfg, params, toks, **context):
    """Teacher-forced logits of ``toks`` [1, S] (with the plan's
    ``context``) through the "kernels" backend, the "torch" backend, and the
    "torch" backend with 128-key blocks (its noise floor: the same attention
    in another summation order).  Returns per-position max |difference| of
    kernels vs torch and of torch vs torch-128, the share of positions whose
    argmax agrees in each pair, max |logit|, and the kernels' logits."""
    out = {}
    with torch.inference_mode():
        for backend in ("kernels", "torch"):
            out[backend] = T.forward(cfg.replace(attn_backend=backend),
                                     params, tokens=toks, **context)[0][0]
        with scan_block(128):
            out["torch128"] = T.forward(cfg.replace(attn_backend="torch"),
                                        params, tokens=toks,
                                        **context)[0][0]

    def diff(a, b):
        return ((out[a] - out[b]).abs().amax(-1),
                float((out[a].argmax(-1) == out[b].argmax(-1)).float()
                      .mean()))
    return diff("kernels", "torch"), diff("torch128", "torch"), \
        float(out["torch"].abs().max()), out["kernels"]


def decode_vs_forward(cfg, params, prompt, cont):
    """Prefill of ``prompt`` and one scalar-pos decode step per token of
    ``cont`` against the teacher-forced forward over prompt + cont:
    per-position max |logit difference| over the len(cont) + 1 positions
    the steps predict, and the forward's logits there."""
    toks = torch.tensor([prompt + cont], device=DEV)
    P = len(prompt)
    with torch.inference_mode():
        full = T.forward(cfg, params, tokens=toks)[0][0]
        last, cache = T.prefill(cfg, params, tokens=toks[:, :P],
                                cache_len=LM_SEQ)
        rows = [last[0, -1]]
        for j in range(len(cont)):
            logits, cache = T.decode_step(cfg, params, cache, P + j,
                                          token=toks[:, P + j:P + j + 1])
            rows.append(logits[0, 0])
    want = full[P - 1:P + len(cont)]
    return (torch.stack(rows) - want).abs().amax(-1), want


def route_counts():
    return ({n: c.value for n, c in k_flash.route_launches.items()},
            {n: c.value for n, c in k_dattn.route_launches.items()})


def route_delta(before):
    now = route_counts()
    return tuple({n: now[i][n] - before[i][n] for n in now[i]}
                 for i in range(2))


def served_lm(tag, cfg, params, prompts, loops):
    """Phase 8's two serves on a full-width model: clean (tokens equal to
    the uncoded loop up to bf16 near-ties), then member 0 late on every job
    (reconstructed steps, member 1 equal to the loop)."""
    futs, clean, setup_s, serve_s = lm_serve(cfg, params, prompts, 10_000.0)
    log_serve("no straggler", clean, setup_s, serve_s, 10_000.0, tag=tag)
    ties = {f.rid: check_tokens(f"{tag} rid {f.rid}", f.result(),
                                loops[f.rid], any_rank=True) for f in futs}
    if clean.reconstructed_steps or clean.n != LM_REQUESTS * LM_NEW:
        raise AssertionError(f"{tag} clean run: {clean}")
    log(f"[{tag}] no straggler: all {LM_REQUESTS} requests answered "
        f"{LM_NEW} tokens equal to the uncoded loop (first differing "
        f"(step, top-2 gap) at a near-tie, by rid: "
        f"{ {r: t for r, t in ties.items() if t is not None} })")
    straggle_ms = max(25.0, 3.0 * clean.inter_token_p50_ms)
    delay_s = 1.5 * straggle_ms / 1e3
    slow = instance_id("main", 0)

    def delay(iid):
        return delay_s if iid == slow else 0.0

    futs, strag, setup_s, serve_s = lm_serve(cfg, params, prompts,
                                             straggle_ms, delay)
    log_serve(f"member 0 delayed {delay_s * 1e3:.0f} ms per job", strag,
              setup_s, serve_s, straggle_ms, tag=tag)
    agree = check_straggler_serve("straggler", futs, strag, loops, tag=tag,
                                  any_rank=True)
    return dict(clean={"completed_by": clean.completed_by, "n": clean.n,
                       "tokens_per_s": clean.tokens_per_s,
                       "p50_ms": clean.inter_token_p50_ms,
                       "p99_ms": clean.p99_ms},
                straggler={"completed_by": strag.completed_by, "n": strag.n,
                           "reconstructed_steps": strag.reconstructed_steps,
                           "straggle_ms": straggle_ms,
                           "tokens_per_s": strag.tokens_per_s,
                           "p50_ms": strag.inter_token_p50_ms,
                           "p99_ms": strag.p99_ms},
                rebuilt_token_agreement=agree)


def host_syncs(fn):
    """The warnings of the calls inside ``fn`` that make the host wait for
    the device (``torch.cuda.set_sync_debug_mode("warn")``); inputs made
    before ``fn`` do not count."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.inference_mode():
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def step_costs(tag, cfg, params, prompts, uncounted, seq=LM_SEQ,
               **context):
    """One decode step at batch LM_SLOTS over a pool of ``seq`` positions
    (host ms, device ms and device operations) beside ``decode_token_cost``,
    and the longest prompt's prefill with the plan's ``context`` (uncounted:
    measurement runs)."""
    pos = [len(p) + LM_NEW // 2 for p in prompts[:LM_SLOTS]]
    longest = max(prompts, key=len)
    with uncounted():
        step_ms = decode_step_ms(cfg, params, pos, seq)
        pre_ms = prefill_ms(cfg, params, longest, seq, **context)
        cache = T.init_cache(cfg, LM_SLOTS, seq, device=DEV)
        tok = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=DEV)

        def three_steps():
            with torch.inference_mode():
                for _ in range(3):
                    T.decode_step(cfg, params, cache, torch.tensor(
                        pos, device=DEV), token=tok)
        _, busy, n_ops = device_profile(three_steps)
        pos_d = torch.tensor(pos, device=DEV)
        syncs = host_syncs(lambda: T.decode_step(cfg, params, cache, pos_d,
                                                 token=tok))
        del cache
    log(f"[{tag}] host synchronizations inside one decode step "
        f"(torch.cuda.set_sync_debug_mode): {len(syncs)}"
        + (f", the first: {syncs[0]}" if syncs else ""))
    if syncs:
        raise AssertionError(f"{tag}: the decode step waits on the device "
                             f"{len(syncs)} times: {syncs}")
    kv_len = int(np.mean(pos)) + 1
    roof_ms = 1e3 * decode_token_cost(cfg, batch=LM_SLOTS, kv_len=kv_len)
    log(f"[{tag}] decode step batch {LM_SLOTS} at pos {pos}: host "
        f"{step_ms:.3f} ms (synchronized, mean of 20), device busy "
        f"{busy / 3 * 1e3:.3f} ms in {n_ops / 3:.0f} device operations "
        f"(profiled, mean of 3); H100 SXM roofline decode_token_cost("
        f"batch={LM_SLOTS}, kv_len={kv_len}) {roof_ms:.4f} ms (active "
        f"parameters only), host/roofline {step_ms / roof_ms:.1f}; prefill "
        f"of the longest prompt ({len(longest)} tokens, batch 1) "
        f"{pre_ms:.3f} ms (host, synchronized, mean of 5)")
    return dict(decode_step_ms=step_ms, decode_step_device_ms=busy / 3 * 1e3,
                decode_step_device_ops=n_ops / 3, roofline_ms=roof_ms,
                prefill_ms=pre_ms, prefill_tokens=len(longest))


def full_width(tag, arch):
    """A full-width model from seed 0: (cfg, params, a line's facts)."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device=DEV)
    torch.cuda.synchronize()
    n = T.param_count(params)
    info = dict(params=n, estimate=estimate_param_count(cfg),
                allocated_gib=gib(torch.cuda.memory_allocated()),
                init_s=time.perf_counter() - t0)
    log(f"[{tag}] {cfg.name} ({cfg.source}), {cfg.dtype}: {n} parameters "
        f"from seed 0 (roofline estimate_param_count {info['estimate']}); "
        f"{info['allocated_gib']:.2f} GiB allocated after init "
        f"({info['init_s']:.1f} s)")
    return cfg, params, info


def phase_moe(uncounted):
    cfg, params, info = full_width("moe", MOE_ARCH)
    log(f"[moe] {cfg.n_layers} layers, all MoE: {cfg.n_experts} routed "
        f"experts top-{cfg.moe_top_k} and {cfg.n_shared_experts} shared, "
        f"moe_d_ff {cfg.moe_d_ff}; d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads over {cfg.n_kv_heads} KV heads at head_dim "
        f"{cfg.resolved_head_dim}; vocab {cfg.vocab}, untied head")
    prompts = lm_prompts(cfg.vocab)
    before_routes = route_counts()
    # comparisons first, uncounted
    t0 = time.perf_counter()
    with uncounted():
        loops = [lm_greedy(cfg, params, p) for p in prompts]
        toks = torch.tensor([prompts[0] + loops[0][0]], device=DEV)
        (d, agree), (floor, floor_agree), scale, _ = backends_per_position(
            cfg, params, toks)
    err, base = pct(d), pct(floor)
    log(f"[moe] uncoded greedy loop over {len(prompts)} prompts of "
        f"{sorted(map(len, prompts))} tokens in "
        f"{time.perf_counter() - t0:.2f} s; teacher-forced forward over "
        f"{toks.shape[1]} tokens, per-position max |logit err| (max, p99, "
        f"median): kernel path vs torch backend "
        f"{tuple(round(x, 4) for x in err)}, argmax equal at "
        f"{agree:.2%} of positions; torch backend with 128-key blocks vs "
        f"torch (the same attention summed in another order: the noise "
        f"floor) {tuple(round(x, 4) for x in base)}, argmax equal at "
        f"{floor_agree:.2%}; position 0 (attends to itself only) "
        f"{float(d[0]):.4f}; max |logit| {scale:.3f}; tolerance: p99 and "
        f"median at most {MOE_FLOOR_FACTOR:g}x the floor's or "
        f"{LM_LOGIT_TOL:g}")
    if not all(e <= max(MOE_FLOOR_FACTOR * f, LM_LOGIT_TOL)
               for e, f in zip(err[1:], base[1:])):
        raise AssertionError(f"moe: kernel logits vs torch backend {err}, "
                             f"noise floor {base}")
    served = served_lm("moe", cfg, params, prompts, loops)
    costs = step_costs("moe", cfg, params, prompts, uncounted)
    flash, dec = route_delta(before_routes)
    if flash != {"wgmma": sum(flash.values()), "simt": 0} or \
            not flash["wgmma"]:
        raise AssertionError(f"moe: B7 launches by route {flash}")
    if dec != {"mma": sum(dec.values()), "simt": 0} or not dec["mma"]:
        raise AssertionError(f"moe: B8 launches by route {dec}")
    path = {name: counts()[name] - uncounted.n[name]
            for name in ("flash_attention", "decode_attention")}
    log(f"[moe] B7 and B8 at {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"(rep {cfg.n_heads // cfg.n_kv_heads}), head_dim "
        f"{cfg.resolved_head_dim}: "
        f"{path['flash_attention']} and {path['decode_attention']} launches "
        f"on the path so far; every launch of the deepseek runs on the "
        f"tensor-core routes (comparison runs included: B7 {flash}, B8 "
        f"{dec})")
    del params
    torch.cuda.empty_cache()
    return dict(info, logit_err=dict(zip(("max", "p99", "median"), err),
                                     argmax_agree=agree),
                logit_noise_floor=dict(zip(("max", "p99", "median"), base),
                                       argmax_agree=floor_agree),
                flash_routes=flash, decode_routes=dec, **served, **costs)


def phase_ssm(uncounted):
    cfg, params, info = full_width("ssm", SSM_ARCH)
    log(f"[ssm] {cfg.n_layers} SSD layers, d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, conv {cfg.ssm_conv}; "
        f"vocab {cfg.vocab}, tied embeddings")
    prompts = lm_prompts(cfg.vocab)
    before = counts()
    t0 = time.perf_counter()
    with uncounted():
        loops = [lm_greedy(cfg, params, p) for p in prompts]
        d, want = decode_vs_forward(cfg, params, prompts[0], loops[0][0])
        p32 = tree_map(lambda x: x.float(), params)
        d32, want32 = decode_vs_forward(cfg.replace(dtype="float32"), p32,
                                        prompts[0], loops[0][0])
        del p32
    floor = (want - want32).abs().amax(-1)
    mx, p99, med = pct(d)
    mx32, mxf = float(d32.max()), float(floor.max())
    tol16 = max(SSM_LOGIT_TOL, SSM_FLOOR_FACTOR * mxf)
    log(f"[ssm] uncoded greedy loop over {len(prompts)} prompts in "
        f"{time.perf_counter() - t0:.2f} s; prefill of {len(prompts[0])} "
        f"tokens + {LM_NEW} decode steps (the recurrence) vs the "
        f"teacher-forced forward (the chunked SSD), per-position max |logit "
        f"err| over {len(d)} positions: bf16 max {mx:.4f} p99 {p99:.4f} "
        f"median {med:.4f} (max |logit| {float(want.abs().max()):.3f}; "
        f"tolerance {tol16:.4f}: {SSM_FLOOR_FACTOR:g}x the bf16 forward's "
        f"distance from its fp32 copy, max {mxf:.4f}, or {SSM_LOGIT_TOL:g}); "
        f"fp32 copy of the weights max {mx32:.3e} (tolerance "
        f"{HYBRID_PROP:g})")
    if not (mx <= tol16 and mx32 <= HYBRID_PROP):
        raise AssertionError(f"ssm: decode vs forward bf16 {mx} (tolerance "
                             f"{tol16}), fp32 {mx32}")
    served = served_lm("ssm", cfg, params, prompts, loops)
    costs = step_costs("ssm", cfg, params, prompts, uncounted)
    launched = {name: counts()[name] - before[name]
                for name in ("flash_attention", "decode_attention")}
    log(f"[ssm] B7 and B8 launches on this path: {launched} — none, as "
        f"expected: mamba2-780m is attention-free (no layer of its plan "
        f"attends), so its serving runs no kernel of the port")
    if any(launched.values()):
        raise AssertionError(f"ssm: attention kernels launched {launched}")
    del params
    torch.cuda.empty_cache()
    return dict(info, decode_vs_forward={"max": mx, "p99": p99,
                                         "median": med, "fp32_max": mx32,
                                         "bf16_vs_fp32_forward_max": mxf},
                attention_launches=launched, **served, **costs)


def phase_hybrid():
    """Reduced jamba (fp32) on the card: "kernels" against "torch", and
    decode against forward; B7 and B8 on their SIMT routes."""
    cfg = get_config(HYBRID_ARCH, reduced=True).replace(capacity_factor=8.0)
    params = T.init_params(cfg, 0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(3)
    B, P, N = 2, 16, 8
    toks = torch.randint(0, cfg.vocab, (B, P + N), generator=gen,
                         device=DEV)
    before, before_routes = counts(), route_counts()
    out = {}
    with torch.inference_mode():
        for backend in ("kernels", "torch"):
            c = cfg.replace(attn_backend=backend)
            full, aux = T.forward(c, params, tokens=toks)
            last, cache = T.prefill(c, params, tokens=toks[:, :P],
                                    cache_len=P + N)
            rows = [last[:, 0]]
            for t in range(P, P + N - 1):
                logits, cache = T.decode_step(
                    c, params, cache, torch.full((B,), t, device=DEV),
                    token=toks[:, t:t + 1])
                rows.append(logits[:, 0])
            out[backend] = (full, aux, torch.stack(rows, 1))
    k_full, k_aux, k_steps = out["kernels"]
    t_full, t_aux, t_steps = out["torch"]
    err = max(float((k_full - t_full).abs().max()),
              float((k_steps - t_steps).abs().max()),
              abs(float(k_aux - t_aux)))
    prop = float((k_steps - k_full[:, P - 1:P + N - 1]).abs().max())
    launched = {name: counts()[name] - before[name]
                for name in ("flash_attention", "decode_attention")}
    flash, dec = route_delta(before_routes)
    log(f"[hybrid] {cfg.name} (fp32, capacity factor 8, plan "
        f"{[(s['mixer'], s['ffn']) for s in T.layer_plan(cfg)]}): kernels "
        f"vs torch backend max abs err {err:.3e} over forward, aux and "
        f"{N} decode positions (tolerance {HYBRID_TOL:g}); decode vs "
        f"forward {prop:.3e} (tolerance {HYBRID_PROP:g}); aux "
        f"{float(k_aux):.4f}; launches {launched}, B7 by route {flash}, B8 "
        f"by route {dec}")
    if not (err <= HYBRID_TOL and prop <= HYBRID_PROP):
        raise AssertionError(f"hybrid: kernels vs torch {err}, decode vs "
                             f"forward {prop}")
    if not all(launched.values()) or flash != {
            "wgmma": 0, "simt": launched["flash_attention"]} or dec != {
            "mma": 0, "simt": launched["decode_attention"]}:
        raise AssertionError(f"hybrid: launches {launched}, routes {flash} "
                             f"{dec}")
    return dict(kernels_vs_torch=err, decode_vs_forward=prop,
                launches=launched)


def phase10():
    """The MoE / SSM / hybrid path: (main-path launches, summary)."""
    for c in ops.counters().values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    uncounted = Uncounted()
    moe = phase_moe(uncounted)
    ssm = phase_ssm(uncounted)
    hybrid = phase_hybrid()
    path = {name: v - uncounted.n[name] for name, v in counts().items()}
    peak = gib(torch.cuda.max_memory_allocated())
    log(f"[hybrid] main-path launches {path} (comparison and measurement "
        f"launches left out: {dict(uncounted.n)}); peak memory of the "
        f"phase {peak:.2f} GiB")
    missing = [name for name in PATH5 if path[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the MoE / SSM / "
                             f"hybrid serving path: {missing}")
    return path, dict(moe=moe, ssm=ssm, hybrid=hybrid, peak_gib=peak)


# ----------------------------------------------------------- phase 11 ----
# the cross-attention and encoder-decoder paths at full width, bf16, random
# weights from seed 0: llama-3.2-vision-11b (40 layers, every fifth a
# cross-attention layer to 1600 stub patch embeddings; 32 heads over 8 KV
# heads at head_dim 128; d_ff 14336; vocab 128256, untied) and
# seamless-m4t-medium (12 bidirectional encoder layers over 1024 stub frames,
# 12 decoder layers that cross-attend to the encoder's output; 16 heads over
# 16 at head_dim 64; ReLU, d_ff 4096; vocab 256206).  ``deploy_lm`` takes no
# modality context (``launch/serve`` strips these layers, as the reference's
# does), so the path is the model's own serving loop: each stream prefilled
# at batch 1 with its context into a slot of a LM_SLOTS-slot pool (its cross
# K/V written once), then LM_NEW greedy decode steps at batch LM_SLOTS with a
# [LM_SLOTS] pos vector, which read the cross K/V from the pool.  Cross
# attention and the encoder run the torch block scan on both backends, as in
# the reference: B7 launches only for the decoder's causal self attention.
VLM_ARCH, ENC_DEC_ARCH = "llama-3.2-vision-11b", "seamless-m4t-medium"
CROSS_SEQ = {VLM_ARCH: LM_SEQ, ENC_DEC_ARCH: 512}
# seamless's decoder prompts: 32-256 tokens
ENC_DEC_PROMPTS = (256, 181, 97, 32)
# phase 2's per-row B8 positions on each model's pool, its last slot too
CROSS_B8_POS = {VLM_ARCH: B8_POS, ENC_DEC_ARCH: [264, 511, 105, 40]}
CROSS_TRAIN_STEPS = 3
# the rows of B7's and B8's JSON entries at other models' heads (phase 2)
HEAD_ROWS = (("deepseek", MOE_ARCH), ("llama_vision", VLM_ARCH),
             ("seamless", ENC_DEC_ARCH))


def cross_prompts(cfg):
    """Phase 11's LM_SLOTS text prompts: phase 8's first (seeded, 463-910
    tokens) for the VLM; seeded tokens of ENC_DEC_PROMPTS lengths for the
    encoder-decoder model."""
    if not cfg.enc_dec:
        return lm_prompts(cfg.vocab)[:LM_SLOTS]
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in ENC_DEC_PROMPTS]


def cross_context(cfg):
    """Stub patch or frame embeddings [LM_SLOTS, n_modality_tokens, D]:
    0.02 N(0, 1), the reference launcher's draw, from a generator on the
    card seeded 0, in the model dtype."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    return (0.02 * torch.randn((LM_SLOTS, cfg.n_modality_tokens, cfg.d_model),
                               generator=gen, device=DEV)).to(
        L.torch_dtype(cfg))


def cross_leaves(cache):
    return [leaf for layer in cache if "cross" in layer
            for leaf in tree_leaves(layer["cross"])]


def cross_generate(cfg, params, prompts, ctx, seq):
    """The path: each stream prefilled at batch 1 into its slot of a
    LM_SLOTS-slot pool of ``seq`` positions, then LM_NEW greedy decode steps
    at batch LM_SLOTS with a [LM_SLOTS] pos vector.  Returns each stream's
    LM_NEW + 1 tokens, its logit rows [LM_SLOTS, LM_NEW + 1, V] (its
    prefill's last, then each step's), the B7 launches of each prefill, the
    B8 launches of each step, and whether the pool's cross K/V after the
    steps are bit-equal to what the prefills wrote."""
    pool = T.init_cache(cfg, LM_SLOTS, seq, device=DEV)
    first, b7, b8 = [], [], []
    with torch.inference_mode():
        for b, prompt in enumerate(prompts):
            before = counts()["flash_attention"]
            logits, one = T.prefill(cfg, params, tokens=torch.tensor(
                [prompt], device=DEV), cross_embeds=ctx[b:b + 1],
                cache_len=seq)
            b7.append(counts()["flash_attention"] - before)
            for dst, src in zip(tree_leaves(pool), tree_leaves(one)):
                dst[:, b:b + 1] = src
            first.append(logits[0, -1])
        written = [leaf.clone() for leaf in cross_leaves(pool)]
        rows = [torch.stack(first)]
        toks = [rows[0].argmax(-1)]
        pos = torch.tensor([len(p) for p in prompts], device=DEV)
        for step in range(LM_NEW):
            before = counts()["decode_attention"]
            logits, pool = T.decode_step(cfg, params, pool, pos + step,
                                         token=toks[-1][:, None])
            b8.append(counts()["decode_attention"] - before)
            rows.append(logits[:, 0])
            toks.append(rows[-1].argmax(-1))
        kept = all(torch.equal(a, b)
                   for a, b in zip(written, cross_leaves(pool)))
    return torch.stack(toks, 1).tolist(), torch.stack(rows, 1), b7, b8, kept


def within_floor(err, floor):
    """The phase-10 rule: p99 and median at most MOE_FLOOR_FACTOR times the
    floor's, or LM_LOGIT_TOL where that is larger."""
    return all(e <= max(MOE_FLOOR_FACTOR * f, LM_LOGIT_TOL)
               for e, f in zip(err[1:], floor[1:]))


def phase_cross_model(tag, arch, uncounted):
    cfg, params, info = full_width(tag, arch)
    seq = CROSS_SEQ[arch]
    prompts, ctx = cross_prompts(cfg), cross_context(cfg)
    plan = T.layer_plan(cfg)
    n_self = sum(s["mixer"] == "attn" for s in plan) * cfg.n_groups
    n_cross = sum(s["cross"] for s in plan) * cfg.n_groups
    log(f"[{tag}] {cfg.n_layers} decoder layers ({n_self} self attention, "
        f"{n_cross} cross-attending"
        + (f"; {cfg.n_enc_layers} bidirectional encoder layers" if
           cfg.enc_dec else "") + f"), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads at head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} ({cfg.act}), vocab "
        f"{cfg.vocab}; {LM_SLOTS} streams of {list(map(len, prompts))} prompt "
        f"tokens, each with {ctx.shape[1]} stub "
        f"{'frames' if cfg.enc_dec else 'patch embeddings'}; pool of "
        f"{LM_SLOTS} slots x {seq} positions")
    before_routes = route_counts()
    t0 = time.perf_counter()
    with uncounted():
        loops = [lm_greedy(cfg, params, p, seq, cross_embeds=ctx[b:b + 1])
                 for b, p in enumerate(prompts)]
    loop_s = time.perf_counter() - t0

    # the path, counted
    t0 = time.perf_counter()
    served, rows, b7, b8, kept = cross_generate(cfg, params, prompts, ctx,
                                                seq)
    path_s = time.perf_counter() - t0
    ties = {b: check_tokens(f"{tag} stream {b}", served[b][:LM_NEW],
                            loops[b], any_rank=True)
            for b in range(LM_SLOTS)}
    log(f"[{tag}] {LM_SLOTS} streams prefilled into the pool and "
        f"{LM_NEW} decode steps at batch {LM_SLOTS} in {path_s:.2f} s "
        f"(uncoded greedy loops, batch 1: {loop_s:.2f} s); served tokens "
        f"equal to the loop's (first differing (step, gap) at a near-tie, "
        f"by stream: { {b: t for b, t in ties.items() if t is not None} }); "
        f"B7 launches per prefill {b7}, B8 launches per decode step "
        f"{sorted(set(b8))} (expected {n_self}: the decoder's causal self "
        f"attention only); cross K/V in the pool bit-equal after the "
        f"{LM_NEW} steps: {kept}")
    if b7 != [n_self] * LM_SLOTS or b8 != [n_self] * LM_NEW:
        raise AssertionError(f"{tag}: B7 launches per prefill {b7}, B8 per "
                             f"step {b8}, expected {n_self} each")
    if not kept:
        raise AssertionError(f"{tag}: a decode step changed the cross K/V")

    # kernels vs torch backend, and each decode row vs the forward, per
    # position (uncounted)
    with uncounted():
        diffs = collections.defaultdict(list)
        for b, prompt in enumerate(prompts):
            toks = torch.tensor([prompt + served[b][:LM_NEW]], device=DEV)
            (d, agree), (floor, floor_agree), scale, full = \
                backends_per_position(cfg, params, toks,
                                      cross_embeds=ctx[b:b + 1])
            P = len(prompt)
            diffs["kernels"].append(d)
            diffs["floor"].append(floor)
            diffs["decode"].append(
                (rows[b] - full[P - 1:P + LM_NEW]).abs().amax(-1))
            diffs["agree"].append(agree)
            diffs["floor_agree"].append(floor_agree)
            diffs["scale"].append(scale)
        if cfg.enc_dec:
            before = counts()
            enc_ms = host_ms(lambda: T.run_encoder(cfg, params, ctx[:1]))
            enc_launches = {n: counts()[n] - before[n] for n in PATH6}
    err, base, dec = (pct(torch.cat(diffs[key]))
                      for key in ("kernels", "floor", "decode"))
    log(f"[{tag}] teacher-forced forward over prompt + {LM_NEW} served "
        f"tokens of each stream ({sum(map(len, diffs['kernels']))} "
        f"positions), per-position max |logit err| (max, p99, median): "
        f"kernel path vs torch backend {tuple(round(x, 4) for x in err)}, "
        f"argmax equal at {np.mean(diffs['agree']):.2%}; torch backend with "
        f"128-key blocks vs torch (the noise floor) "
        f"{tuple(round(x, 4) for x in base)}, argmax equal at "
        f"{np.mean(diffs['floor_agree']):.2%}; each decode step's logits "
        f"(batch {LM_SLOTS}, pos vector) vs the forward at the same position "
        f"({sum(map(len, diffs['decode']))} positions) "
        f"{tuple(round(x, 4) for x in dec)}; max |logit| "
        f"{max(diffs['scale']):.3f}; tolerance: p99 and median at most "
        f"{MOE_FLOOR_FACTOR:g}x the floor's or {LM_LOGIT_TOL:g}")
    if not (within_floor(err, base) and within_floor(dec, base)):
        raise AssertionError(f"{tag}: kernels vs torch {err}, decode vs "
                             f"forward {dec}, noise floor {base}")
    costs = step_costs(tag, cfg, params, prompts, uncounted, seq,
                       cross_embeds=ctx[:1])
    if cfg.enc_dec:
        log(f"[{tag}] encoder alone over {ctx.shape[1]} frames (batch 1): "
            f"{enc_ms:.3f} ms (host, synchronized, mean of 5) of the "
            f"{costs['prefill_ms']:.3f} ms prefill; B7/B8 launches of the "
            f"encoder {enc_launches} (its attention is the block scan)")
        if any(enc_launches.values()):
            raise AssertionError(f"{tag}: the encoder launched "
                                 f"{enc_launches}")
        costs["encoder_ms"] = enc_ms
    # what decode_token_cost (the reference's arithmetic) counts and leaves
    # out for these plans
    kv_len = int(np.mean([len(p) for p in prompts])) + LM_NEW // 2 + 1
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    cross_bytes = sum(leaf.numel() * leaf.element_size()
                      for leaf in cross_leaves(T.init_cache(
                          cfg, LM_SLOTS, 1, device="meta")))
    enc_params = T.param_count(params.get("encoder", {}))
    log(f"[{tag}] decode_token_cost counts estimate_param_count "
        f"{info['estimate']} parameters (the tree holds {info['params']}"
        + (f", {enc_params} of them in the encoder, which a decode step "
           f"does not read" if enc_params else "")
        + f") and kv_cache_bytes {kv_cache_bytes(cfg, kv_len, LM_SLOTS)} "
        f"(self-attention K/V of {cfg.n_layers} layers at kv_len {kv_len}); "
        f"it leaves out the cross K/V each step reads, {n_cross} layers x "
        f"{LM_SLOTS} streams x {cfg.n_modality_tokens} rows x {KV} x {hd} "
        f"x 2 (k, v): {cross_bytes} bytes, "
        f"{cross_bytes / HBM_BPS * 1e3:.4f} ms at 3.35 TB/s")
    flash, dec_routes = route_delta(before_routes)
    if flash != {"wgmma": sum(flash.values()), "simt": 0} or \
            dec_routes != {"mma": sum(dec_routes.values()), "simt": 0}:
        raise AssertionError(f"{tag}: B7 by route {flash}, B8 {dec_routes}")
    log(f"[{tag}] every B7 launch on the wgmma route, every B8 on mma "
        f"(comparison runs included: B7 {flash}, B8 {dec_routes})")
    del params
    torch.cuda.empty_cache()
    return dict(info, logit_err=dict(zip(("max", "p99", "median"), err)),
                logit_noise_floor=dict(zip(("max", "p99", "median"), base)),
                decode_vs_forward=dict(zip(("max", "p99", "median"), dec)),
                b7_per_prefill=b7[0], b8_per_step=b8[0],
                cross_kv_unchanged=kept, cross_kv_bytes=cross_bytes,
                near_ties={b: t for b, t in ties.items() if t is not None},
                flash_routes=flash, decode_routes=dec_routes, **costs)


def train_launcher(arch):
    """``launch/train`` at reduced size on the card for CROSS_TRAIN_STEPS
    steps: its logged losses, each finite."""
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", arch, "--steps", str(CROSS_TRAIN_STEPS),
                           "--log-every", "1"])
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.getvalue().splitlines()
              if line.startswith("step")]
    log(f"[cross] launch/train --arch {arch} (reduced, on the card): "
        f"losses {losses}")
    if len(losses) != CROSS_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{arch}: train launcher losses {losses}")
    return losses


def phase11():
    """The cross-attention / encoder-decoder path: (main-path launches,
    summary)."""
    for c in ops.counters().values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    uncounted = Uncounted()
    vlm = phase_cross_model("vlm", VLM_ARCH, uncounted)
    enc_dec = phase_cross_model("enc_dec", ENC_DEC_ARCH, uncounted)
    train = {arch: train_launcher(arch) for arch in (VLM_ARCH, ENC_DEC_ARCH)}
    path = {name: v - uncounted.n[name] for name, v in counts().items()}
    peak = gib(torch.cuda.max_memory_allocated())
    log(f"[cross] main-path launches {path} (comparison and measurement "
        f"launches left out: {dict(uncounted.n)}); peak memory of the "
        f"phase {peak:.2f} GiB")
    missing = [name for name in PATH6 if path[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the cross-attention "
                             f"/ encoder-decoder path: {missing}")
    return path, dict(llama_vision=vlm, seamless=enc_dec,
                      train_launcher=train, peak_gib=peak)


# ----------------------------------------------------------- phase 12 ----
# the launch layer on the card: phase 8's qwen2-0.5b (seed 0, the same
# weights) on a (1, 1) mesh over one NCCL rank, the launcher's logical rules
# active; then the host-only dry run of two full-size pairs on (16, 16)
DRY_PAIRS = (("qwen2-0.5b", "decode_32k", "pod"),
             ("deepseek-moe-16b", "prefill_32k", "pod"))


def launches_per_call(fn, name):
    """``fn()`` and the launches of kernel ``name`` it made."""
    before = counts()[name]
    out = fn()
    return out, counts()[name] - before


def mesh_steps(cfg, params, mesh, ref, uncounted):
    """The prefill and decode steps under the rules: prefill bit-equal to
    T.prefill without rules (uncounted), decode giving phase 8's loop
    tokens.  Returns a summary."""
    per_prefill, per_step, same = [], [], 0
    with torch.inference_mode():
        for prompt, loop in zip(ref["prompts"], ref["loops"]):
            toks = torch.tensor([prompt], device=DEV)
            with uncounted():
                plain = T.prefill(cfg, params, tokens=toks)
            with logical_rules(*rules_for_mesh(mesh), mesh):
                (logits, cache), n = launches_per_call(
                    lambda: launch_steps.make_prefill_step(cfg)(
                        params, {"tokens": toks}), "flash_attention")
                per_prefill.append(n)
                if not all(torch.equal(a, b) for a, b in zip(
                        tree_leaves((logits, cache)), tree_leaves(plain))):
                    raise AssertionError("distributed: the prefill step under"
                                         " the rules is not bit-equal to "
                                         "T.prefill")
                # decode from a pool of LM_SEQ slots holding the prefill, as
                # phase 8's loop decodes
                pool = T.init_cache(cfg, 1, LM_SEQ, device=DEV)
                for dst, src in zip(tree_leaves(pool), tree_leaves(cache)):
                    dst[:, :, :src.shape[2]] = src
                row, out = logits[0, -1], []
                for pos in range(len(prompt), len(prompt) + LM_NEW):
                    out.append(int(torch.topk(row, 8).indices[0]))
                    if len(out) == LM_NEW:
                        break
                    (logits, pool), n = launches_per_call(
                        lambda: launch_steps.make_decode_step(cfg, pos)(
                            params, pool, {"token": torch.tensor(
                                [[out[-1]]], device=DEV)}),
                        "decode_attention")
                    per_step.append(n)
                    row = logits[0, 0]
            same += out == loop[0]
            del plain, cache, pool
    if same != len(ref["prompts"]):
        raise AssertionError(f"distributed: the decode step's tokens equal "
                             f"phase 8's loop for {same} of "
                             f"{len(ref['prompts'])} prompts")
    L_ = cfg.n_layers
    if set(per_prefill) != {L_} or set(per_step) != {L_}:
        raise AssertionError(f"distributed: B7 launches per prefill "
                             f"{sorted(set(per_prefill))}, B8 per decode step "
                             f"{sorted(set(per_step))}, not {L_}")
    log(f"[distributed] prefill step under the rules bit-equal to T.prefill "
        f"without rules on all {len(per_prefill)} of phase 8's prompts, "
        f"{L_} B7 launches per prefill; decode step, {LM_NEW - 1} steps per "
        f"prompt, {L_} B8 launches per step, tokens equal to phase 8's loop "
        f"on {same} of {len(ref['prompts'])} prompts")
    return {"prefills": len(per_prefill), "b7_per_prefill": L_,
            "decode_steps": len(per_step), "b8_per_step": L_,
            "prompts_equal_to_loop": same}


def coded_steps(cfg, params, mesh, prompts, uncounted):
    """Both coded-serve flavours (k=2) on members' prompts paired from
    phase 8's (the longer cut to the shorter): the optimized flavour's
    [B, 1, V] logits held to the baseline's last position within
    LM_LOGIT_TOL, argmax equal unless the baseline's top-2 gap is below
    LM_GAP_TOL; each flavour's host and device ms (the timing runs
    uncounted)."""
    rows = []
    with logical_rules(*rules_for_mesh(mesh), mesh):
        for a, b in zip(prompts[0::2], prompts[1::2]):
            S = min(len(a), len(b))
            toks = torch.tensor([[a[:S]], [b[:S]]], device=DEV)  # [2, 1, S]
            out, times = {}, {}
            for opt in (False, True):
                step = launch_steps.make_coded_serve_step(cfg, K, opt)

                def run(step=step, toks=toks):
                    with torch.inference_mode():
                        return step(params, {"tokens": toks})[0]
                out[opt] = run()
                with uncounted():
                    _, busy, n_ops = device_profile(run)
                    times[opt] = {"host_ms": host_ms(run),
                                  "device_ms": busy * 1e3,
                                  "device_ops": n_ops}
            base, fast = out[False][0, -1], out[True][0, -1]
            err = float((fast - base).abs().max())
            top = torch.topk(base, 2).values
            gap = float(top[0] - top[1])
            tie_ok = int(fast.argmax()) == int(base.argmax()) or \
                gap < LM_GAP_TOL
            if tuple(out[True].shape) != (1, 1, cfg.vocab) or \
                    not err <= LM_LOGIT_TOL or not tie_ok:
                raise AssertionError(
                    f"distributed: coded-serve flavours differ at S={S}: "
                    f"shape {tuple(out[True].shape)}, max abs logit err "
                    f"{err}, argmax {int(fast.argmax())} vs "
                    f"{int(base.argmax())} (top-2 gap {gap})")
            rows.append({"S": S, "max_abs_err": err, "top2_gap": gap,
                         "baseline": times[False], "optimized": times[True]})
            log(f"[distributed] coded-serve step k={K}, members of {S} "
                f"tokens: optimized [1,1,V] vs baseline's last position max "
                f"abs logit err {err:.4f} (tolerance {LM_LOGIT_TOL:g}), "
                f"argmax {'equal' if int(fast.argmax()) == int(base.argmax()) else 'differs at a near-tie'}; "
                f"baseline host {times[False]['host_ms']:.3f} ms, device "
                f"{times[False]['device_ms']:.3f} ms "
                f"({times[False]['device_ops']} ops); optimized host "
                f"{times[True]['host_ms']:.3f} ms, device "
                f"{times[True]['device_ms']:.3f} ms "
                f"({times[True]['device_ops']} ops)")
    return rows


def meshed_serve(cfg, params, mesh, ref):
    """deploy_lm with GenerationSpec(mesh=...) on phase 8's requests: the
    tokens of phase 8's serve without a mesh (a stream that differs must
    still meet phase 8's near-tie rule against the loop)."""
    futs, stats, setup_s, serve_s = lm_serve(cfg, params, ref["prompts"],
                                             10_000.0, mesh=mesh)
    log_serve("mesh (1, 1), no straggler", stats, setup_s, serve_s,
              10_000.0, tag="distributed")
    served = [f.result() for f in futs]
    same = sum(a == b for a, b in zip(served, ref["served"]))
    for f in futs:
        check_tokens(f"distributed rid {f.rid}", f.result(),
                     ref["loops"][f.rid])
    if stats.reconstructed_steps or stats.n != LM_REQUESTS * LM_NEW:
        raise AssertionError(f"distributed serve: {stats}")
    log(f"[distributed] deploy_lm on the (1, 1) mesh: {same} of "
        f"{len(served)} streams token for token equal to phase 8's serve "
        f"without a mesh")
    return {"streams_equal_to_unmeshed": same, "n": stats.n,
            "tokens_per_s": stats.tokens_per_s}


def dry_runs():
    out = {}
    for arch, shape, mesh in DRY_PAIRS:
        r = dryrun.run_pair(arch, shape, mesh, verbose=False)
        mem, roof = r["memory"], r["roofline"]
        log(f"[distributed] dry run {arch} {shape} on {mesh} "
            f"({r['chips']} devices, host only, torch {r['torch']}): per "
            f"device arguments {gib(mem['argument_bytes']):.3f} GiB, outputs "
            f"{gib(mem['output_bytes']):.3f} GiB, temporaries (eager peak) "
            f"{gib(mem['temp_bytes']):.3f} GiB, peak live "
            f"{gib(mem['peak_live_bytes']):.3f} GiB; roofline on "
            f"{roof['hardware']['name']}: compute {roof['compute_s'] * 1e3:.3f}"
            f" ms, memory {roof['memory_s'] * 1e3:.3f} ms, collective "
            f"{roof['collective_s'] * 1e3:.3f} ms ({roof['dominant']}); "
            f"{r['compile_s']:.1f} s")
        out[f"{arch}__{shape}__{mesh}"] = {
            "memory": mem, "compute_s": roof["compute_s"],
            "memory_s": roof["memory_s"],
            "collective_s": roof["collective_s"],
            "dominant": roof["dominant"], "seconds": r["compile_s"]}
    return out


def phase12(ref):
    """The launch steps on a one-device mesh (path 7) and the dry run:
    (main-path launches, summary)."""
    log(f"[distributed] torch {torch.__version__} (CUDA "
        f"{torch.version.cuda})")
    cfg = get_config(LM_ARCH)
    params = T.init_params(cfg, 0, device=DEV)
    for c in ops.counters().values():
        c.reset()
    uncounted = Uncounted()
    with launch_mesh.card_world():
        mesh = launch_mesh.make_test_mesh((1, 1), device_type="cuda")
        log(f"[distributed] mesh {mesh} over one NCCL rank; params stay "
            f"plain tensors on the card")
        steps = mesh_steps(cfg, params, mesh, ref, uncounted)
        coded = coded_steps(cfg, params, mesh, ref["prompts"], uncounted)
        serve = meshed_serve(cfg, params, mesh, ref)
    path = {name: v - uncounted.n[name] for name, v in counts().items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dry = dry_runs()
    log(f"[distributed] main-path launches {path} (comparison and "
        f"measurement launches left out: {dict(uncounted.n)})")
    missing = [name for name in PATH7 if path[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the distributed "
                             f"path: {missing}")
    return path, dict(torch=torch.__version__, steps=steps, coded=coded,
                      serve=serve, dry_run=dry)


def head_entry(row):
    """A kernel's measurements at another model's heads (phase 2)."""
    return {"shape": row["shape"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            **({"pos": row["pos"]} if "pos" in row else {})}


def kernel_entry(name, row, launches, by_path):
    source = CSRC_ATTN if name in PATH3 else CSRC
    return {"name": name, "route": "cuda", "source": source,
            "replaces": row["replaces"], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "shape": row["shape"],
            "launches_by_path": by_path,
            **{key: head_entry(row[key]) for key, _ in HEAD_ROWS
               if key in row},
            **{key: row[key] for key in (
                "op_ms", "decode_one_ms", "library_device_ms",
                "cold_device_ms", "empty_launch_device_ms",
                "device_ms_by_cluster",
                "one_slot_device_ms") if key in row}}


PATH1 = ("parity_encode", "fused_encode_forward", "parity_decode",
         "multigroup_decode")
PATH2 = ("parity_encode", "parity_decode", "multigroup_decode",
         "learned_project", "berrut_encode")
PATH3 = ("flash_attention", "decode_attention")
PATH4 = ("parity_encode", "parity_decode", "flash_attention",
         "decode_attention")
PATH5 = ("flash_attention", "decode_attention")
PATH6 = ("flash_attention", "decode_attention")
PATH7 = ("flash_attention", "decode_attention")


def main():
    t0 = time.perf_counter()
    phase_device()
    t1 = time.perf_counter()
    log(f"[time] phase 1 device: {t1 - t0:.1f} s")
    n = sweep_kernels()
    log(f"[kernels] {n} sweep cases held against the plain versions")
    rows = measure_kernels()
    t2 = time.perf_counter()
    log(f"[time] phase 2 kernels: {t2 - t1:.1f} s")

    # ---- path 1: coded MLP serving (phases 3-4)
    x, y, tmpl = cluster_images(3000, noise=2.0, seed=0, image_shape=IMG)
    xt, yt, _ = cluster_images(2000, noise=2.0, seed=1, templates=tmpl,
                               image_shape=IMG)
    for c in ops.counters().values():
        c.reset()
    params, fwd, pp, scheme, a_a, acc_par, lat = phase_serve(x, y, xt, yt)
    t3 = time.perf_counter()
    log(f"[time] phase 3 serve: {t3 - t2:.1f} s")
    before = counts()
    ad, pouts = a_d(scheme, params, pp, fwd, xt, yt)
    path1 = counts()
    for name in ("fused_encode_forward", "multigroup_decode"):
        if path1[name] <= before[name]:
            raise AssertionError(f"A_d phase did not launch {name}")
    log(f"[A_d] A_d={ad:.4f} over {len(xt) // K} groups; main-path "
        f"launches {path1}")
    missing = [name for name in PATH1 if path1[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the MLP serving "
                             f"path: {missing}")

    plain = get_scheme("sum", k=K, backend="torch", device=DEV)
    ad_plain, pouts_plain = a_d(plain, params, pp, fwd, xt, yt)
    err = float(np.abs(pouts - pouts_plain).max())
    log(f"[A_d] plain-path A_d={ad_plain:.4f}; fused parity outputs max abs "
        f"err vs plain {err:.3e}")
    if not ad > 0.1 or abs(ad - ad_plain) > 0.01:
        raise AssertionError(f"A_d={ad} vs plain {ad_plain}")
    t4 = time.perf_counter()
    log(f"[time] phase 4 A_d: {t4 - t3:.1f} s")

    # ---- path 2: the scheme registry on resnet18s (phases 5-7)
    for c in ops.counters().values():
        c.reset()
    uncounted = Uncounted()
    r_params, r_fwd, r_xt, r_a_a, scheme_rows = phase_schemes(uncounted)
    t5 = time.perf_counter()
    log(f"[time] phase 5 schemes: {t5 - t4:.1f} s")
    errors = phase_errors()
    t6 = time.perf_counter()
    log(f"[time] phase 6 errors: {t6 - t5:.1f} s")
    byz, straggle = phase_byzantine(r_params, r_fwd, r_xt, uncounted)
    path2 = {name: v - uncounted.n[name] for name, v in counts().items()}
    t7 = time.perf_counter()
    log(f"[time] phase 7 byzantine: {t7 - t6:.1f} s")
    log(f"[schemes] main-path launches {path2} (comparison launches left "
        f"out: {dict(uncounted.n)})")
    missing = [name for name in PATH2 if path2[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the scheme "
                             f"registry's path: {missing}")

    # ---- path 3: coded LM serving on full-width qwen2-0.5b (phase 8)
    path3, lm, lm_ctx = phase_lm()
    t8 = time.perf_counter()
    log(f"[time] phase 8 lm: {t8 - t7:.1f} s")
    log(f"[lm] main-path launches {path3}")
    missing = [name for name in PATH3 if path3[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the LM serving "
                             f"path: {missing}")

    # ---- path 4: LM parity training and serving the trained model
    # (phase 9); the comparisons first, before the path's counters are
    # zeroed
    vjp = check_vjp()
    card_cpu = card_vs_cpu_grads()
    for c in ops.counters().values():
        c.reset()
    train = phase_train(lm_ctx)
    train.update(vjp_max_abs_err=vjp, card_vs_cpu_step=card_cpu)
    path4 = counts()
    lm_ref = {key: lm_ctx[key] for key in ("prompts", "loops", "served")}
    del lm_ctx
    t9 = time.perf_counter()
    log(f"[time] phase 9 train: {t9 - t8:.1f} s")
    log(f"[train] main-path launches {path4}")
    missing = [name for name in PATH4 if path4[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the LM training "
                             f"path: {missing}")

    # ---- path 5: MoE / SSM / hybrid LM serving (phase 10), with phases 8
    # and 9's models freed first
    gc.collect()
    torch.cuda.empty_cache()
    path5, hybrid = phase10()
    t10 = time.perf_counter()
    log(f"[time] phase 10 moe/ssm/hybrid: {t10 - t9:.1f} s")

    # ---- path 6: cross-attention and encoder-decoder LM serving (phase
    # 11), with phase 10's models freed
    gc.collect()
    torch.cuda.empty_cache()
    path6, cross = phase11()
    t11 = time.perf_counter()
    log(f"[time] phase 11 cross: {t11 - t10:.1f} s")

    # ---- path 7: the launch steps on a one-device mesh (phase 12), with
    # phase 11's models freed
    gc.collect()
    torch.cuda.empty_cache()
    path7, distributed = phase12(lm_ref)
    t12 = time.perf_counter()
    log(f"[time] phase 12 distributed: {t12 - t11:.1f} s")

    kernels = []
    for name in ("parity_encode", "fused_encode_forward", "parity_decode",
                 "multigroup_decode", "learned_project", "berrut_encode",
                 "flash_attention", "decode_attention"):
        by_path = {"mlp_serving": path1[name], "schemes": path2[name],
                   "lm_serving": path3[name], "lm_training": path4[name],
                   "moe_ssm_serving": path5[name],
                   "cross_serving": path6[name],
                   "distributed": path7[name]}
        kernels.append(kernel_entry(name, rows[name], sum(by_path.values()),
                                    by_path))
    log(json.dumps({"summary": {
        "A_a": a_a, "A_d": ad, "A_d_plain": ad_plain,
        "parity_path_accuracy": acc_par,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "resnet18s_A_a": r_a_a, "resnet18s_schemes": scheme_rows,
        "errors": {name: {str(rate): acc for rate, acc in per.items()}
                   for name, per in errors.items()},
        "byzantine": {"detected": byz.corrupted_detected,
                      "corrected": byz.corrected,
                      "completed_by": byz.completed_by},
        "approxifer_r1_completed_by": straggle.completed_by,
        "lm": lm,
        "lm_training": train,
        "moe_ssm_hybrid": hybrid,
        "cross": cross,
        "distributed": distributed,
        "seconds": time.perf_counter() - t0}}))
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def lr_sweep(lrs):
    """Phase 9's distillation alone, once at each learning rate of
    ``lrs`` from the same parameters and batches; prints its lines and no
    result line."""
    phase_device()
    cfg = get_config(LM_ARCH)
    deployed = T.init_params(cfg, 0, device=DEV)
    for lr in lrs:
        distil(cfg, deployed, np.random.default_rng(1), lr)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--distil-lrs", default=None,
                    help="comma-separated learning rates: run phase 9's "
                         "distillation alone at each and stop")
    args = ap.parse_args()
    if args.distil_lrs:
        lr_sweep([float(x) for x in args.distil_lrs.split(",")])
    else:
        main()
