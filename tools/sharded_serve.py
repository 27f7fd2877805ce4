"""Sharded LM serving on several cards: the port's ``deploy_lm`` with
``GenerationSpec(mesh=...)`` on a ("data", "model") mesh of one NCCL rank
per card, and the launch steps on the same mesh as a control.

    python3 tools/sharded_serve.py [--phases LIST] [--src DIR] [--out DIR]

It needs four cards, one per rank of a (2, 2) mesh.  One process
per rank is spawned; each meets the others at ``tcp://localhost:<a free
port>`` with a process-group timeout of ``PG_TIMEOUT_S`` (120 s) and
runs the phases in order, each on every rank:

* ``control`` — the launch steps (``launch/steps.py``), single-threaded:
  the prefill step (B7 on each rank's shard) and three decode steps on
  ``attn_backend="torch"`` (the kernel route refuses a sequence-sharded
  cache, ROADMAP.md B.5) over full-width qwen2-0.5b in fp32 at batch 4,
  parameters at the inference layout, the cache at ``cache_specs``;
  logits held to the same steps on one card within ``CONTROL_TOL``.
* ``qwen`` — ``chip_smoke.sharded_serves``: full-width qwen2-0.5b (bf16,
  seed 0) serves phase 8's 8 requests at k=2, r=1, 4 slots per member,
  4 new tokens each: clean, tokens equal to the one-card uncoded loop up
  to bf16 near-ties (a served token among the loop's best within
  ``chip_smoke.LM_GAP_TOL``, the rule of phase 10); then member 0 late on
  every decode step, its steps rebuilt and member 1 equal to the loop.
  Every B7 and B8 launch on the tensor-core routes.  Then the mesh's
  teacher-forced logits over the first prompt and its loop's tokens
  against one card's kernel path, beside one card's own bf16 floor
  (``mesh_vs_card``, phase 10's rule).
* ``step`` — the serving decode step on the mesh (each rank) beside the
  plain step on the rank's card (``chip_smoke.mesh_step_costs``); after the
  world ends, rank 0 measures the same step on a (1, 1) mesh.
* ``fail`` — a failure planted on rank ``FAIL_RANK`` (member 0's first
  decode job raises after gathering its logits): every rank's
  ``wait_all`` must raise, naming that rank, within ``FAIL_S``.
* ``moe``, ``ssm``, ``hybrid`` — one plan of each family served on the
  mesh (``family_serves``), each in fp32 and in bf16 with its own weights
  from seed 0: phase 8's 8 requests, 4 new tokens each, clean and with
  member 0 late (``chip_smoke.sharded_serves``), then the teacher-forced
  logits over the first prompt and its loop's tokens on the mesh against
  one card (``mesh_vs_card``).  In fp32, where rounding cannot move a
  token, the serves are held to the one-card loop under the token rule
  and the logits' p99 and median to ``CONTROL_TOL``; B7 and B8 on their
  SIMT routes.  In bf16 the serves are held to the mesh's own loop
  (``chip_smoke.lm_greedy`` on the mesh, summed as the serve sums), the
  logits to one card's bf16 floor (phase 10's rule), and how many streams
  leave the one-card loop outside the token rule is printed; every B7 and
  B8 launch on the tensor-core routes.  ``moe``: full-width
  deepseek-moe-16b (bf16 at 28 layers, ~17 GB of weights a card at TP 2;
  fp32 at ``MOE_FP32_LAYERS`` of 28, the most a card holds beside the
  one-card reference).  ``ssm``: full-width mamba2-780m, attention-free
  (no B7 or B8 launch).  ``hybrid``: reduced jamba-1.5-large-398b (a
  full-width period holds ~45 B parameters, more than a card).  A check
  that fails ends its dtype's part and the run's "ok"; the other dtype and
  the later phases go on.

The parent process prints the cards' ``nvidia-smi`` name and power limit,
builds the kernels once, then prints each phase's lines from every rank's
log and checks that the ranks agree (tokens, completion mix, rebuilt
steps) serve by serve.  The last line is one JSON object: ``ok``, the
cards, and rank 0's outcome of each family phase by dtype
(``families``); every rank's results go to ``summary.json`` under
``--out``.  It exits non-zero on any mismatch, unmet check, error, hang or
timeout: a failed check is recorded, never passed over.

Nothing may hang past its bound.  Each phase has a deadline
(``DEADLINES``): 20 s before it a rank dumps PyTorch's NCCL flight
recorder (each process group's collectives by sequence number and state),
and at it ``faulthandler`` dumps every thread's Python stack and ends the
rank.  A collective that waits past the process-group timeout is ended by
the NCCL watchdog, which dumps the flight recorder too.  Everything lands
in ``--out`` (default ``build/sharded_serve/``): ``rank{r}.log``,
``rank{r}.json``, ``stacks_rank{r}.txt``, ``flight_{phase}_rank{r}.pkl``,
``nccl_trace_rank_{r}`` (the watchdog's dumps), ``nccl.*.log``
(``NCCL_DEBUG=INFO``) and ``summary.json``; the parent prints a summary
of every flight recorder dump it finds.

``--src DIR`` runs another tree's ``repro_torch`` (a parent commit unpacked
with ``git archive``).  ``--device cpu`` runs the same phases on CPU
ranks over gloo at reduced size (one torch thread each), with no ``step``
phase: a check of this script itself.
"""
from __future__ import annotations

import argparse
import datetime
import faulthandler
import gc
import json
import math
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("control", "qwen", "step", "fail", "moe", "ssm", "hybrid")
# seconds a phase may take on a rank, start-up included in the first
DEADLINES = {"control": 240, "qwen": 420, "step": 180, "fail": 180,
             "moe": 900, "ssm": 600, "hybrid": 300}
PG_TIMEOUT_S = 120.0
# the control's fp32 logits, mesh against one card: the two differ only
# in the order of their sums (the tensor-parallel all-reduces)
CONTROL_TOL = 1e-3
CONTROL_BATCH, CONTROL_STEPS = 4, 3
FAIL_RANK, FAIL_S = 2, 60.0
# after one rank fails, how long the others may take to end
FAIL_GRACE_S = 30.0
QWEN = "qwen2-0.5b"
# the plan served by each family's phase; jamba at full width holds ~45 B
# parameters in one 8-layer period (90 GB in bf16), which no card holds
# beside the one-card reference, so it runs reduced on the cards too
FAMILIES = {"moe": "deepseek-moe-16b", "ssm": "mamba2-780m",
            "hybrid": "jamba-1.5-large-398b"}
# deepseek-moe-16b in fp32: its 28 layers take 67.5 GB, which no card holds
# beside a rank's 34 GB shard; 14 layers take 34.5 GB
MOE_FP32_LAYERS = 14
# each family phase's two parts, in order
DTYPES = ("float32", "bfloat16")
MESH = (2, 2)
# what a run writes into --out
OUTPUTS = ("rank*.log", "rank*.json", "stacks_rank*.txt", "flight_*.pkl",
           "nccl_trace_rank_*", "nccl.*.log", "summary.json")


# --------------------------------------------------------------------------
# on every rank
# --------------------------------------------------------------------------
class Watch:
    """A phase's deadline on this rank: 20 s before it the NCCL flight
    recorder is dumped, at it every thread's stack, and the rank ends."""

    def __init__(self, out, rank, stacks):
        self.out, self.rank, self.stacks = out, rank, stacks
        self.timer = None

    def start(self, phase, seconds):
        faulthandler.dump_traceback_later(seconds, exit=True,
                                          file=self.stacks)
        self.timer = threading.Timer(max(1.0, seconds - 20.0),
                                     dump_flight_recorder,
                                     (self.out, phase, self.rank))
        self.timer.daemon = True
        self.timer.start()

    def stop(self):
        faulthandler.cancel_dump_traceback_later()
        self.timer.cancel()


def dump_flight_recorder(out, phase, rank):
    import torch
    path = out / f"flight_{phase}_rank{rank}.pkl"
    try:
        path.write_bytes(torch._C._distributed_c10d._dump_nccl_trace())
        print(f"[sharded_serve] rank {rank}: phase {phase} near its "
              f"deadline; NCCL flight recorder dumped to {path}", flush=True)
    except Exception as e:          # a diagnostic: its own failure is told
        print(f"[sharded_serve] rank {rank}: no flight recorder dump: "
              f"{type(e).__name__}: {e}", flush=True)


def control(cs, mesh, dev, reduced):
    """The launch steps on ``mesh`` against the same steps on one card."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.distributed.logical import (logical_rules,
                                                 rules_for_mesh)
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(QWEN, reduced=reduced).replace(dtype="float32")
    tcfg = cfg.replace(attn_backend="torch")
    params = T.init_params(cfg, 0, device=dev)
    prompts = cs.lm_prompts(cfg.vocab)[:CONTROL_BATCH]
    P = min(map(len, prompts))
    S = (P + CONTROL_STEPS + 7) // 8 * 8    # divides over the model axis
    toks = torch.tensor([p[:P] for p in prompts], dtype=torch.int32,
                        device=dev)

    def full(x):
        return (x.full_tensor() if isinstance(x, DTensor) else x).float()

    with torch.no_grad():
        want, feed = [ST.make_prefill_step(cfg)(params,
                                                {"tokens": toks})[0]], []
        _, cache = T.prefill(cfg, params, tokens=toks, cache_len=S)
        one_card = tree_map(torch.clone, cache)
        logits = want[0]
        for i in range(CONTROL_STEPS):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            feed.append(tok)
            logits, cache = ST.make_decode_step(tcfg, P + i)(
                params, cache, {"token": tok})
            want.append(logits)

    rules = ShardingRules(mesh, fsdp_params=False)
    lrules, sizes = rules_for_mesh(mesh)
    lrules["fsdp_params"] = False
    sparams = rules.distribute(params, rules.params(params))
    place = rules.batch_specs({"t": toks})["t"]
    b7 = ops.counters()["flash_attention"].value
    with logical_rules(lrules, sizes, mesh), implicit_replication(), \
            torch.no_grad():
        got = [ST.make_prefill_step(cfg)(
            sparams, {"tokens": rules.distribute(toks, place)})[0]]
        b7 = ops.counters()["flash_attention"].value - b7
        # the decode steps from the one-card prefill's cache, placed
        scache = rules.distribute(one_card, rules.cache_specs(one_card))
        placements = [str(p) for p in tree_leaves(scache)[0].placements]
        for i, tok in enumerate(feed):
            logits, scache = ST.make_decode_step(tcfg, P + i)(
                sparams, scache, {"token": rules.distribute(tok, place)})
            got.append(logits)
    errs = [float((full(a) - b).abs().max()) for a, b in zip(got, want)]
    scale = max(float(b.abs().max()) for b in want)
    cs.log(f"[control] {QWEN} fp32, batch {CONTROL_BATCH} of {P} tokens: "
           f"the launch prefill step on the mesh (B7 {b7} launches on this "
           f"rank) against one card max abs logit err {errs[0]:.3g}; "
           f"{CONTROL_STEPS} decode steps (torch backend, cache of {S} "
           f"placed {placements}) {[float(f'{e:.3g}') for e in errs[1:]]}; "
           f"tolerance {CONTROL_TOL:g}, max |logit| {scale:.3f}")
    return {"batch": CONTROL_BATCH, "prompt": P, "cache_len": S,
            "cache_placements": placements,
            "prefill_err": errs[0], "decode_errs": errs[1:],
            "max_abs_logit": scale, "b7_launches_in_prefill": b7,
            "ok": max(errs) <= CONTROL_TOL}


def qwen_phase(cs, mesh, dev, reduced):
    """Serve phase 8's requests on ``mesh``, clean and with member 0 late
    (``chip_smoke.sharded_serves``), then hold the mesh's teacher-forced
    logits to one card's (``mesh_vs_card``)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as k_dattn
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = get_config(QWEN, reduced=reduced)
    params = T.init_params(cfg, 0, device=dev)
    prompts = cs.lm_prompts(cfg.vocab)
    t0 = time.perf_counter()
    loops = [cs.lm_greedy(cfg, params, p) for p in prompts]
    loops_s = time.perf_counter() - t0
    for c in [*ops.counters().values(), *k_flash.route_launches.values(),
              *k_dattn.route_launches.values()]:
        c.reset()
    # tensor parallelism splits each bf16 matmul's sum over the model
    # axis's cards, so the logits round otherwise than on one card, and a
    # near-tie of three may fall to the loop's third: the served token is
    # held to any of the loop's best within LM_GAP_TOL, phase 10's rule
    out = cs.sharded_serves(cfg, params, mesh, prompts, loops,
                            any_rank=True)
    launches = {n: c.value for n, c in ops.counters().items() if c.value}
    routes = {n: c.value for n, c in k_flash.route_launches.items()}
    droutes = {n: c.value for n, c in k_dattn.route_launches.items()}
    if dev == "cuda" and (
            routes != {"wgmma": launches.get("flash_attention", 0),
                       "simt": 0} or
            droutes != {"mma": launches.get("decode_attention", 0),
                        "simt": 0} or not routes["wgmma"] or
            not droutes["mma"]):
        raise AssertionError(f"{QWEN}: B7 launches by route {routes}, B8 "
                             f"{droutes}, of {launches}: not all on the "
                             f"tensor-core routes")
    cs.log(f"[sharded] {QWEN}: launches {launches}, B7 by route {routes}, "
           f"B8 by route {droutes}; the one-card loops took {loops_s:.1f} s")
    # the sessions' placed parameters and pools go first
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["teacher_forced"] = mesh_vs_card(cs, cfg, params, mesh,
                                         prompts[0] + loops[0][0])
    return {**out, "launches": launches, "b7_routes": routes,
            "b8_routes": droutes}


def family_phase(cs, mesh, dev, reduced, family):
    """``family``'s plan served on ``mesh`` in fp32 and in bf16
    (``family_serves``), each with its own weights from seed 0.  A check
    that fails ends its dtype's part, which the summary reports, and the
    other goes on: every rank meets the same check on the same tokens and
    logits, so every rank fails it alike."""
    from repro_torch.configs.base import get_config
    base = get_config(FAMILIES[family],
                      reduced=reduced or family == "hybrid")
    return {dtype: family_dtype(cs, base.replace(dtype=dtype), mesh, dev,
                                reduced) for dtype in DTYPES}


def family_dtype(cs, cfg, mesh, dev, reduced):
    """One dtype's part of a family phase: ``family_serves``' outcome, or
    the check it failed."""
    cut = None
    if cfg.family == "moe" and cfg.dtype == "float32" and not reduced:
        cut = f"{MOE_FP32_LAYERS} of {cfg.n_layers} layers"
        cfg = cfg.replace(n_layers=MOE_FP32_LAYERS)
    try:
        out = {**family_serves(cs, cfg, mesh, dev, cut,
                               hold_floor=not reduced), "ok": True}
    except AssertionError as e:
        cs.log(f"[{cfg.family}] {cfg.name} {cfg.dtype}: NOT met: {e}")
        out = {"ok": False, "failed": str(e), "cut": cut}
    free(dev)
    return out


def free(dev):
    """What the last serve or comparison left, given back to the card."""
    import torch
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def family_serves(cs, cfg, mesh, dev, cut, hold_floor=True):
    """Phase 8's requests served on ``mesh`` (``chip_smoke.sharded_serves``:
    clean, then member 0 late), SHARDED_NEW tokens each, then the mesh's
    teacher-forced logits against one card's (``mesh_vs_card``).

    In fp32 the serves' tokens are held to the one-card loop under the
    token rule and the logits' p99 and median to CONTROL_TOL: rounding
    cannot move them, so a miss is a fault.  In bf16 tensor parallelism
    sums in another order than one card, and top-k routing turns that into
    other experts, so the tokens are held to the mesh's own loop
    (``chip_smoke.mesh_greedy``: the same sums as the serve) and
    the logits to one card's bf16 floor; how many streams first leave the
    one-card loop outside the token rule is printed, not held.  At reduced
    size (``hold_floor`` False) the bf16 logits are printed beside the
    floor, not held to it: two layers do not carry any rounding to the
    same saturated spread as a full-depth model, so there the rule would
    weigh the mesh's rounding against the floor's, not the model's answer
    to either.  B7 and B8 on their SIMT routes in fp32, on the tensor-core
    routes in bf16, none for an attention-free plan."""
    import torch
    from repro_torch.kernels import decode_attention as k_dattn
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.generation import place_inference_params
    fp32, new = cfg.dtype == "float32", cs.SHARDED_NEW
    tag = f"{cfg.name} {cfg.dtype}" + (f" ({cut})" if cut else "")
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device=dev)
    prompts = cs.lm_prompts(cfg.vocab)
    loops = [cs.lm_greedy(cfg, params, p, new=new) for p in prompts]
    out = {"layers": cfg.n_layers, "cut": cut,
           "params": T.param_count(params)}
    cs.log(f"[sharded] {tag}: {out['params']} parameters from seed 0; the "
           f"one-card loops over {len(prompts)} prompts in "
           f"{time.perf_counter() - t0:.1f} s (init included)")
    held, held_to = loops, "the one-card fp32 loop"
    if not fp32:
        t0 = time.perf_counter()
        sparams = place_inference_params(params, mesh)
        held = cs.mesh_greedy(cfg, sparams, mesh, prompts, new=new)
        del sparams
        free(dev)
        held_to = "the mesh's own loop"
        same = sum(a[0] == b[0] for a, b in zip(held, loops))
        misses = token_misses(cs, [a[0] for a in held], loops)
        out["mesh_loop"] = {"streams_equal_to_card_loop": same,
                            "outside_rule_vs_card_loop": misses,
                            "seconds": time.perf_counter() - t0}
        cs.log(f"[sharded] {tag}: the mesh's own loop in "
               f"{out['mesh_loop']['seconds']:.1f} s; {same} of "
               f"{len(prompts)} streams token for token equal to the "
               f"one-card loop; first differences outside the token rule "
               f"(rid, step, gap to the best): {misses}")
    for c in [*ops.counters().values(), *k_flash.route_launches.values(),
              *k_dattn.route_launches.values()]:
        c.reset()
    out.update(cs.sharded_serves(cfg, params, mesh, prompts, held,
                                 any_rank=True, held_to=held_to))
    out["held_to"] = held_to
    launches = {n: c.value for n, c in ops.counters().items() if c.value}
    routes = {n: c.value for n, c in k_flash.route_launches.items()}
    droutes = {n: c.value for n, c in k_dattn.route_launches.items()}
    attends = any(s["mixer"] == "attn" for s in T.layer_plan(cfg))
    b7, b8 = ("simt", "simt") if fp32 else ("wgmma", "mma")
    n7, n8 = (launches.get(n, 0) for n in ("flash_attention",
                                           "decode_attention"))
    # the routes' counts sum to the launches: all on b7 / b8, or none
    if dev == "cuda" and (routes[b7] != n7 or droutes[b8] != n8 or
                          attends != bool(n7) or attends != bool(n8)):
        raise AssertionError(f"{tag}: launches {launches}, B7 by route "
                             f"{routes}, B8 by route {droutes}: not all on "
                             f"the {b7} / {b8} routes"
                             + ("" if attends else ", or some launched by "
                                "an attention-free plan"))
    if not fp32:
        out["outside_rule_vs_card_loop"] = token_misses(
            cs, out["clean"]["tokens"], loops)
    cs.log(f"[sharded] {tag}: tokens held to {held_to}; launches "
           f"{launches}, B7 by route {routes}, B8 by route {droutes}"
           + ("" if fp32 else
              f"; the clean serve's first differences from the one-card "
              f"loop outside the token rule (rid, step, gap to the best), "
              f"printed and not held: {out['outside_rule_vs_card_loop']}"))
    out.update(launches=launches, b7_routes=routes, b8_routes=droutes)
    free(dev)
    out["teacher_forced"] = mesh_vs_card(
        cs, cfg, params, mesh, prompts[0] + loops[0][0],
        tol=CONTROL_TOL if fp32 else None, hold=fp32 or hold_floor)
    return out


def token_misses(cs, tokens, loops):
    """(rid, step, the served token's gap to the loop's best, None beyond
    its top 8) of each stream whose first token unequal to the loop's
    falls outside the token rule (``chip_smoke.check_tokens`` with
    ``any_rank``); the later tokens follow another history."""
    out = []
    for rid, (got, (toks, _, _, ranked)) in enumerate(zip(tokens, loops)):
        t = next((t for t, (a, b) in enumerate(zip(got, toks)) if a != b),
                 None)
        if t is not None:
            gap = ranked[t].get(got[t])
            if gap is None or gap >= cs.LM_GAP_TOL:
                out.append((rid, t, gap))
    return out


def mesh_vs_card(cs, cfg, params, mesh, tokens, tol=None, hold=True):
    """Teacher-forced logits of ``tokens`` on ``mesh`` (the parameters at
    the inference layout, under the serving rules) against one card's
    kernel path, per position (max, p99, median of the max |logit
    difference|).  With ``tol`` (fp32) p99 and median are held to it.
    Otherwise they are held beside one card's own noise floor to phase
    10's rule (``chip_smoke.within_floor``): for a plan that attends, its
    torch backend in two summation orders
    (``chip_smoke.backends_per_position``); for an attention-free plan,
    phase 10's SSM floor, the bf16 forward against an fp32 copy of its
    weights.  ``hold`` False: the outcome is printed, not raised."""
    import torch
    from repro_torch.convert import tree_map
    from repro_torch.distributed import logical
    from repro_torch.models import transformer as T
    from repro_torch.serving.generation import (place_inference_params,
                                                serving_rules)
    toks = torch.tensor([tokens], device=cs.DEV)
    base = None
    if tol is None and any(s["mixer"] == "attn" for s in T.layer_plan(cfg)):
        _, (floor, _), scale, card = cs.backends_per_position(cfg, params,
                                                              toks)
        base = cs.pct(floor)
        what = "one card's floor (torch backend, 128-key blocks vs default)"
    else:
        with torch.inference_mode():
            card = T.forward(cfg, params, tokens=toks)[0][0]
            scale = float(card.abs().max())
            if tol is None:
                p32 = tree_map(lambda x: x.float(), params)
                base = cs.pct((card - T.forward(
                    cfg.replace(dtype="float32"), p32,
                    tokens=toks)[0][0]).abs().amax(-1))
                del p32
                what = ("one card's floor (the bf16 forward vs an fp32 "
                        "copy of its weights, phase 10's SSM floor)")
    sparams = place_inference_params(params, mesh)
    with logical.logical_rules(*serving_rules(mesh)), \
            logical.implicit_replication(), torch.no_grad():
        logits = cs.whole(T.forward(cfg, sparams, tokens=toks)[0])
    del sparams
    d = (logits[0].float() - card.float()).abs().amax(-1)
    agree = float((logits[0].argmax(-1) == card.argmax(-1)).float().mean())
    err = cs.pct(d)
    if tol is not None:
        ok = err[1] <= tol and err[2] <= tol
        rule = f"p99 and median at most {tol:g}"
    else:
        ok = cs.within_floor(err, base)
        rule = (f"{what} {tuple(round(x, 4) for x in base)}; phase 10's "
                f"rule (p99 and median at most {cs.MOE_FLOOR_FACTOR:g}x "
                f"the floor's or {cs.LM_LOGIT_TOL:g})")
    cs.log(f"[sharded] {cfg.name} {cfg.dtype} teacher-forced over "
           f"{toks.shape[1]} tokens, per-position max |logit err| (max, "
           f"p99, median): the {tuple(mesh.shape)} mesh vs one card's kernel "
           f"path {tuple(float(f'{x:.4g}') for x in err)}, argmax equal at "
           f"{agree:.2%}; max |logit| {scale:.3f}; {rule}: "
           f"{'met' if ok else 'NOT met'}{'' if hold else ' (not held)'}")
    if hold and not ok:
        raise AssertionError(f"{cfg.name} {cfg.dtype}: the mesh's logits "
                             f"{err} against one card's ({rule})")
    return {"tokens": toks.shape[1], "err": err, "floor": base, "tol": tol,
            "argmax_agree": agree, "max_abs_logit": scale, "met": ok,
            "held": hold}


def step_phase(cs, mesh, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.generation import place_inference_params
    cfg = get_config(QWEN)
    params = T.init_params(cfg, 0, device=dev)
    dparams = place_inference_params(params, mesh)
    pos = cs.step_positions(cs.lm_prompts(cfg.vocab))
    costs = cs.mesh_step_costs(cfg, params, dparams, mesh, pos)
    cs.log_step_costs(str(tuple(mesh.shape)), pos, costs)
    return {"pos": pos, **costs}


def one_card_step(cs, dev):
    """The step phase's (1, 1) mesh, after the world has ended."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import transformer as T
    cfg = get_config(QWEN)
    params = T.init_params(cfg, 0, device=dev)
    pos = cs.step_positions(cs.lm_prompts(cfg.vocab))
    with launch_mesh.card_world():
        mesh = launch_mesh.make_test_mesh((1, 1), device_type="cuda")
        costs = cs.mesh_step_costs(cfg, params, cs.replicated(params, mesh),
                                   mesh, pos)
    cs.log_step_costs("(1, 1)", pos, costs)
    return {"pos": pos, **costs}


def fail_phase(cs, mesh, dev, reduced):
    """Member 0's first decode job on FAIL_RANK raises once it has gathered
    its logits: how every rank's ``wait_all`` raises, and how soon."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import generation as G
    from repro_torch.serving.api import BatchingPolicy, deploy_lm
    cfg = get_config(QWEN, reduced=reduced)
    params = T.init_params(cfg, 0, device=dev)
    real, served = G.to_host, []

    def planted(x):
        # the running job is the session's last record (made before it runs)
        y = real(x)
        if dist.get_rank() == FAIL_RANK and y.ndim == 3 and served and \
                served[0].issued[-1][0] == "lm-member-0":
            raise RuntimeError("planted decode failure")
        return y
    spec = G.GenerationSpec(
        cfg=cfg, params=params, k=cs.K, r=1,
        batching=BatchingPolicy(max_size=cs.LM_SLOTS),
        max_seq_len=cs.LM_SEQ, max_new_tokens=cs.SHARDED_NEW,
        straggle_ms=10_000.0, mesh=mesh, device=dev)
    G.to_host = planted
    try:
        with deploy_lm(spec) as sess:
            served.append(sess)
            for p in cs.lm_prompts(cfg.vocab):
                sess.submit(p)
            t0, error = time.monotonic(), None
            try:
                sess.wait_all(timeout=FAIL_S)
            except RuntimeError as e:
                error = str(e)
            seconds = time.monotonic() - t0
    finally:
        G.to_host = real
    want = f"rank {FAIL_RANK}: RuntimeError: planted decode failure"
    cs.log(f"[sharded] failure planted on rank {FAIL_RANK}: wait_all "
           f"raised after {seconds:.2f} s: {error}")
    if error is None or want not in error or not seconds < FAIL_S:
        raise AssertionError(f"the planted failure: {error!r} after "
                             f"{seconds:.2f} s")
    return {"error": error, "raised_after_s": seconds}


def rank_main(rank, world, args, port):
    out = Path(args.out)
    log = open(out / f"rank{rank}.log", "w", buffering=1)
    sys.stdout = sys.stderr = log
    stacks = open(out / f"stacks_rank{rank}.txt", "w")
    faulthandler.enable(file=stacks, all_threads=True)
    watch = Watch(out, rank, stacks)
    results, path = {"rank": rank}, out / f"rank{rank}.json"

    def save():
        path.write_text(json.dumps(results))
    try:
        sys.path.insert(0, str(Path(args.src).resolve()))
        import repro_torch  # noqa: F401  (this tree's, before chip_smoke)
        sys.path.insert(1, str(ROOT))
        import chip_smoke as cs
        import torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_test_mesh
        cs.DEV = args.device
        reduced = args.device == "cpu"
        if reduced:
            torch.set_num_threads(1)
        phases = args.phases.split(",")
        watch.start(phases[0], DEADLINES[phases[0]])
        kw = {}
        if args.device == "cuda":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
            # the fp32 control and serves: no TF32 in a matmul or a conv
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "nccl" if args.device == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S), **kw)
        mesh = make_test_mesh(MESH, device_type=args.device)
        cs.log(f"[sharded_serve] rank {rank} of {world}: mesh {mesh}, "
               f"backend {dist.get_backend()}, torch {torch.__version__}")
        for i, phase in enumerate(phases):
            if i:
                watch.start(phase, DEADLINES[phase])
            t0 = time.perf_counter()
            if phase == "control":
                res = control(cs, mesh, args.device, reduced)
            elif phase == "qwen":
                res = qwen_phase(cs, mesh, args.device, reduced)
            elif phase == "step":
                res = step_phase(cs, mesh, args.device)
            elif phase == "fail":
                res = fail_phase(cs, mesh, args.device, reduced)
            else:
                res = family_phase(cs, mesh, args.device, reduced, phase)
            res["seconds"] = time.perf_counter() - t0
            watch.stop()
            cs.log(f"[time] {phase}: {res['seconds']:.1f} s")
            results[phase] = res
            save()
            if phase == "control" and not res["ok"]:
                raise AssertionError(f"control: {res}")
            if args.device == "cuda":
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        if "step" in phases and rank == 0:
            watch.start("step", DEADLINES["step"])
            results["step_one_card"] = one_card_step(cs, args.device)
            watch.stop()
            save()
    except BaseException:
        traceback.print_exc()
        results["error"] = traceback.format_exc()
        save()
        log.flush()
        os._exit(1)
    log.flush()
    os._exit(0)


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------
def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def summarize_flight(path):
    """Lines of one flight recorder dump: per process group, the last
    collectives by sequence number with their state and sizes."""
    try:
        d = pickle.loads(path.read_bytes())
    except Exception as e:
        return [f"  {path.name}: unreadable ({type(e).__name__}: {e})"]
    by_pg = {}
    for e in d.get("entries", []):
        by_pg.setdefault(str(e.get("process_group")), []).append(e)
    lines = [f"  {path.name}: {len(d.get('entries', []))} entries"]
    for pg, entries in by_pg.items():
        tail = entries[-4:]
        lines.append(f"    pg {pg}: " + "; ".join(
            f"#{e.get('collective_seq_id')} {e.get('profiling_name')} "
            f"{e.get('state')} in {e.get('input_sizes')}" for e in tail))
    return lines


AGREE = ("tokens", "completed_by", "reconstructed_steps", "n")


def serves_of(phases):
    """(name, the keys down to its two serves) of every served plan."""
    return [("qwen", ("qwen",))] * ("qwen" in phases) + [
        (f"{p} {dt}", (p, dt)) for p in phases if p in FAMILIES
        for dt in DTYPES]


def at(res, keys):
    for key in keys:
        res = res.get(key, {})
    return res


def check_agreement(results, phases):
    """The ranks' tokens, completion mixes and rebuilt steps agree, serve
    by serve."""
    def pick(serve):
        return {k: serve[k] for k in AGREE if k in serve}
    return [f"{name} {part}: rank {r} differs from rank 0"
            for name, keys in serves_of(phases)
            for r, res in enumerate(results[1:], 1)
            for part in ("clean", "straggler")
            if pick(at(res, keys).get(part, {})) !=
            pick(at(results[0], keys).get(part, {}))]


def family_summary(first, phases):
    """Rank 0's outcome of each family phase, by dtype."""
    out = {}
    for p in phases:
        if p not in FAMILIES:
            continue
        out[p] = {}
        for dt in DTYPES:
            res = at(first, (p, dt))
            tf = res.get("teacher_forced", {})
            out[p][dt] = {
                "ok": res.get("ok", False), "failed": res.get("failed"),
                "arch": FAMILIES[p], "layers": res.get("layers"),
                "cut": res.get("cut"), "held_to": res.get("held_to"),
                "clean": {k: res.get("clean", {}).get(k) for k in (
                    "completed_by", "p50_ms")},
                "straggler_reconstructed_steps": res.get(
                    "straggler", {}).get("reconstructed_steps"),
                "teacher_forced_err": tf.get("err"),
                "teacher_forced_floor": tf.get("floor"),
                "teacher_forced_tol": tf.get("tol"),
                "outside_rule_vs_card_loop": res.get(
                    "outside_rule_vs_card_loop"),
                "launches": res.get("launches")}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch runs")
    ap.add_argument("--out", default=str(ROOT / "build" / "sharded_serve"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    world = math.prod(MESH)
    phases, cards = args.phases.split(","), []
    if any(p not in PHASES for p in phases):
        ap.error(f"phases are {PHASES}")
    if args.device == "cpu" and "step" in phases:
        ap.error("the step phase times the card: not with --device cpu")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for pattern in OUTPUTS:                 # an earlier run's, not others'
        for old in out.glob(pattern):
            old.unlink()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < world:
            print(f"needs {world} CUDA devices, have "
                  f"{torch.cuda.device_count()}", flush=True)
            return 2
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print("\n".join(cards), flush=True)
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.library()
        print(f"[sharded_serve] kernels built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        os.environ.update({
            "TORCH_NCCL_TRACE_BUFFER_SIZE": "2000",
            "TORCH_NCCL_DUMP_ON_TIMEOUT": "1",
            "TORCH_NCCL_DEBUG_INFO_TEMP_FILE": str(out / "nccl_trace_rank_"),
            "NCCL_DEBUG": "INFO",
            "NCCL_DEBUG_FILE": str(out / "nccl.%h.%p.log")})
    print(f"[sharded_serve] {world} ranks on {args.device}, mesh "
          f"{MESH}, phases {phases}, src {args.src}, torch "
          f"{torch.__version__}", flush=True)
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, world, args, port))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    bound = sum(DEADLINES[p] for p in phases) + (
        DEADLINES["step"] if "step" in phases else 0) + 60
    deadline, ended = time.monotonic() + bound, None
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if ended is None and any(p.exitcode for p in procs):
            # a rank failed: the others wait for it in a collective; give
            # them FAIL_GRACE_S to end or dump, then stop them
            ended = time.monotonic()
            deadline = min(deadline, ended + FAIL_GRACE_S)
        time.sleep(0.5)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    wall = time.perf_counter() - t0

    results, failed = [], list(hung)
    for r, p in enumerate(procs):
        path = out / f"rank{r}.json"
        results.append(json.loads(path.read_text()) if path.exists()
                       else {"rank": r})
        if p.exitcode != 0 or "error" in results[-1]:
            failed.append(r)
    lines = (out / "rank0.log").read_text().splitlines() if (
        out / "rank0.log").exists() else []
    print("\n".join(f"[rank 0] {line}" for line in lines), flush=True)
    for r in sorted(set(failed) - {0}):
        log = out / f"rank{r}.log"
        tail = log.read_text().splitlines()[-40:] if log.exists() else []
        print("\n".join(f"[rank {r}] {line}" for line in tail), flush=True)
    dumps = sorted(out.glob("flight_*.pkl")) + sorted(
        out.glob("nccl_trace_rank_*"))
    for path in dumps:
        print("\n".join(summarize_flight(path)), flush=True)
    for r in range(world):
        stack = out / f"stacks_rank{r}.txt"
        if stack.exists() and stack.stat().st_size:
            print(f"[sharded_serve] rank {r}'s thread stacks "
                  f"({stack}):\n" + stack.read_text()[-6000:], flush=True)
    bad = [] if failed else check_agreement(results, phases)
    families = family_summary(results[0], phases)
    unmet = [f"{p} {dt}" for p, by in families.items()
             for dt, res in by.items() if not res["ok"]]
    for res in results:
        res.pop("error", None)
    for res in results[1:]:         # equal to rank 0's where it matters
        for _, keys in serves_of(phases):
            for part in ("clean", "straggler"):
                at(res, keys).get(part, {}).pop("tokens", None)
    ok = not failed and not bad and not unmet
    print(f"[sharded_serve] {wall:.1f} s; ranks hung {hung}, failed "
          f"{sorted(set(failed))}; disagreements {bad}; checks not met "
          f"{unmet}", flush=True)
    last = {"ok": ok, "mesh": MESH, "device": args.device, "cards": cards,
            "wall_s": wall, "families": families}
    (out / "summary.json").write_text(json.dumps({**last,
                                                  "ranks": results}))
    print(json.dumps(last), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
