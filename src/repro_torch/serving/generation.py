"""Coded autoregressive LM serving: token-level continuous batching with
per-step parity reconstruction.  DESIGN.md §13 is the authoring guide.

ParM codes one-shot queries; this module extends the same framework to
*generation*.  A ``GenerationSpec`` deploys k member instances plus r parity
instances of a decode-capable model (``prefill`` / ``decode_step`` /
``init_cache``).  Each member serves ``n_slots`` independent token streams
out of one fixed-shape KV-cache pool (continuous batching: streams join and
leave at token boundaries; the pool never reshapes, so resident streams are
never recompiled or perturbed).  The coding group is a *slot column*: slot s
of every member plus slot s of every parity instance.

Reconstruction semantics per decode step (the JAX package's
``make_joint_parity_train_step`` LM substrate, ApproxIFER's model-agnostic
stance for the default parity params):

* encode over input EMBEDDINGS — each step the parity stream consumes
  ``sum_i C[j,i] * embed(token_i)`` and advances its own KV cache;
* decode over LOGITS — a member that misses the per-step straggle deadline
  has its logits row recovered by the scheme's existing linear decoders from
  the parity logits and the on-time members' logits.

The recovered stream never stalls: the emitted token is the argmax of the
*reconstructed* logits, and because a decode step's cache update depends
only on its INPUT token (never on which logits won the race), the
straggler's still-running step repairs its own cache in the background —
its executor queue serializes the late step before the next one, so by the
time the next decode wants the cache it is exact.  That is the cache-repair
rule: repair-by-completion + canonical token feedback.

Scheduler states per stream: WAITING (queued) -> ADMITTED (prefill into a
free (member, slot), first token emitted from prefill logits, parity slot
column rebuilt from the encoded prompt) -> DECODING (one coded step per
token) -> FINISHED (future fulfilled, slot freed, parity column rebuilt for
the remaining occupants).

Engines:

* ``deploy_lm(spec, engine="threads")`` — real PyTorch inference on executor
  threads (on ``spec.device``), wall-clock straggle deadlines, scenario delay
  adapters;
* ``deploy_lm(spec, engine="sim")``     — every decode step becomes one DES
  query at a service time calibrated from ``launch/roofline.py``
  (``decode_token_cost``), so 10M-token tail studies of the big configs
  (qwen3_moe_235b, jamba_1_5_large_398b, mamba2_780m) run on the
  simulator's fast path unchanged.

The port keeps the reference's engine and differs where PyTorch does: the
cache pools are written in place (``models/transformer.decode_step``
writes key/value rows, SSM states and conv tails, admissions copy a prefill
into their slot column), and every write to instance i's pool runs on
instance i's executor (on a mesh, the rank's device thread), whose FIFO
queue still serializes a straggler's late step before its next one — the
cache-repair rule is unchanged.  A decode advances an SSM state, so each
served pool sees exactly the decodes the reference keeps: one per coded
step, and none from the warm-up.  Executors launch on PyTorch's current
stream; ``to_host`` on the logits is the sync point.  ``GenerationSpec``
keeps the reference's ``mesh`` (``place_inference_params``) and gains
``device`` and ``hardware`` (the sim engine's roofline device).

On a mesh the session is SPMD, where the reference drives every device
from one process: every rank builds the same session and submits the same
requests, the mesh's first rank decides every scheduler round and
broadcasts it (``GenerationSession``), and one device thread per rank runs
every instance's device work of a decided round, in one fixed order
(admissions' prefills, parity rebuilds, members 0..k-1, parities 0..r-1),
on one stream, under the mesh's logical rules and over the mesh's own
process groups.  So every rank issues the collectives of every
communicator in the same order, from one thread: no interleaving of
several threads' collectives can deadlock the ranks.  The pools are
DTensors with the sequence whole on each rank (``place_cache_pool``), so
B7 and B8 run on each rank's shard of the batch and the KV heads
(``models.layers``).

"Late" on a mesh: every instance there shares every card, as in the
reference's single GSPMD process, so an instance is not slower than
another by itself.  A simulated straggle (``delay_fn``, a scenario's
adapters) holds back the instance's answer until its job's start plus the
delay: the job runs at once in its place in the order, and the decider
reads the answer as late, as it would a job slept that long.  Sleeping in
the device thread would hold every instance's collectives behind one
instance's straggle.  The cache-repair rule holds as without a mesh: a
late step has run before its instance's next one.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.convert import (resolve_device, to_host, tree_leaves,
                                 tree_map)
from repro_torch.distributed import logical
from repro_torch.core.scheme import get_scheme
from repro_torch.serving.api import (BatchingPolicy, DeploymentSpec, Trace,
                                     deploy)
from repro_torch.serving.report import ServingReport
from repro_torch.serving.scenarios import get_scenario, instance_id
from repro_torch.trace import span

_SHUTDOWN = object()


# --------------------------------------------------------------------------
# Spec
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class GenerationSpec:
    """Frozen description of one coded LM deployment.

    ``cfg`` / ``params`` drive the default transformer substrate
    (``repro_torch.models.transformer``); ``parity_params`` defaults to the
    deployed params (ApproxIFER-style model-agnostic parity — retraining a
    parity model per token position is a non-starter, and for linear
    substrates the deployed model already satisfies the code exactly).
    ``prefill_fn`` / ``decode_fn`` / ``embed_fn`` / ``init_cache_fn``
    override the substrate (tests inject exactly-linear stubs).

    The threads engine sizes its cache pools from
    ``batching.max_size`` (= slots per member) and ``max_seq_len``;
    ``straggle_ms`` is the per-step deadline after which a missing member
    row is reconstructed from parity.  ``m`` / ``utilization`` / ``kv_len``
    / ``tp`` / ``hardware`` calibrate the sim engine's token-level service
    model.  ``device`` is where the threads engine runs (default ``"cuda"``;
    constructing a spec raises without a card unless ``device="cpu"``).
    ``mesh``, a ``("data", "model")`` ``DeviceMesh``, puts the parameters
    on its inference layout (``place_inference_params``).  On a mesh of one
    device they stay plain tensors and the session serves as without a
    mesh; on a larger mesh (CPU ranks over gloo, or cards over NCCL) the
    session is SPMD (``GenerationSession``).  DTensor parameters on a mesh
    of one device also take the SPMD path: that is a hook for checking the
    sharded path on one card (``chip_smoke.py`` phase 14), not a way to
    deploy.  A substrate override serves on a mesh too: its parameters are
    placed as the transformer's are (names the rules do not know
    replicated) and its pool is replicated.  A cross-attending plan does
    not serve on a mesh and raises ``ValueError`` here, naming
    ``ROADMAP.md`` B.5 (``_refusal``).
    """

    cfg: Any = None
    params: Any = None
    parity_params: Any = None            # None -> params (model-agnostic)
    scheme: Union[str, Any] = "sum"
    strategy: Union[str, Any] = "parm"   # sim engine strategy
    k: int = 2
    r: int = 1
    batching: BatchingPolicy = field(
        default_factory=lambda: BatchingPolicy(max_size=4))
    max_seq_len: int = 64
    max_new_tokens: int = 8
    straggle_ms: float = 200.0

    # fault injection (threads engine wall-clock adapters; the sim engine
    # realizes the same scenario hazards in simulated time)
    scenario: Any = None
    scenario_seed: int = 0
    scenario_time_scale: float = 1.0
    scenario_horizon_ms: float = 600_000.0
    delay_fn: Optional[Callable] = None  # iid -> seconds, composes

    # substrate overrides (tests / non-transformer models)
    prefill_fn: Optional[Callable] = None
    decode_fn: Optional[Callable] = None
    embed_fn: Optional[Callable] = None
    init_cache_fn: Optional[Callable] = None

    # distributed placement: params on the mesh's inference layout
    # (distributed/sharding.py, fsdp_params=False)
    mesh: Any = None

    device: str = "cuda"

    # sim-engine calibration: m member streams at `utilization` of the
    # roofline decode-step service time for cfg at kv_len / tensor-parallel
    # degree tp on `hardware` (None: launch.roofline.H100_SXM)
    m: int = 12
    utilization: float = 0.7
    kv_len: int = 4096
    tp: int = 1
    hardware: Any = None

    def __post_init__(self):
        if self.k < 1 or self.r < 1:
            raise ValueError(f"k and r must be >= 1, got k={self.k} "
                             f"r={self.r}")
        if not isinstance(self.batching, BatchingPolicy):
            raise TypeError(
                f"batching must be a BatchingPolicy, got {self.batching!r}")
        if self.mesh is not None and (self.mesh.size() > 1 or any(
                isinstance(x, DTensor) for x in tree_leaves(self.params))):
            why = _refusal(self)
            if why is not None:
                raise ValueError(
                    f"GenerationSpec does not serve on the mesh "
                    f"{tuple(self.mesh.shape)}: {why[0]} (ROADMAP.md "
                    f"{why[1]})")
        resolve_device(self.device)

    def replace(self, **changes) -> "GenerationSpec":
        return replace(self, **changes)


# --------------------------------------------------------------------------
# Futures and stream state
# --------------------------------------------------------------------------
class GenerationFuture:
    """Async handle for one generation request: the emitted token ids, how
    many steps were served from a parity reconstruction, and the per-token
    emission timestamps."""

    def __init__(self, rid):
        self.rid = rid
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._tokens: List[int] = []
        self._recon_steps = 0
        self._times: List[float] = []
        self.completed_by = None         # "model" | "flushed"

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} unfinished after {timeout}s")
        return list(self._tokens)

    @property
    def tokens_so_far(self) -> List[int]:
        with self._lock:
            return list(self._tokens)

    @property
    def reconstructed_steps(self) -> int:
        return self._recon_steps

    @property
    def inter_token_ms(self) -> List[float]:
        with self._lock:
            t = self._times
            return [1e3 * (b - a) for a, b in zip(t, t[1:])]

    def _emit(self, token, now, reconstructed):
        with self._lock:
            self._tokens.append(int(token))
            self._times.append(now)
            if reconstructed:
                self._recon_steps += 1

    def _finish(self, how="model"):
        self.completed_by = how
        self._event.set()

    def __repr__(self):
        state = (self.completed_by or "done") if self.done() else "pending"
        return f"GenerationFuture(rid={self.rid}, {state})"


class _Stream:
    """One admitted request living in (member, slot)."""

    __slots__ = ("rid", "prompt", "max_new", "pos", "next_token", "future",
                 "t_admit")

    def __init__(self, rid, prompt, max_new, future, t_admit):
        self.rid = rid
        self.prompt = prompt             # list[int], inputs already consumed
        self.max_new = max_new
        self.pos = len(prompt)           # cache fill == next write position
        self.next_token = None           # canonical feedback token
        self.future = future
        self.t_admit = t_admit           # the decider's clock

    @property
    def history(self):
        """All input tokens consumed so far (prompt + fed-back emissions)."""
        return self.prompt + self.future.tokens_so_far[:-1] \
            if self.future.tokens_so_far else self.prompt


class _Executor(threading.Thread):
    """A worker thread draining a FIFO job queue: one per model instance
    without a mesh, one per rank on a mesh (the device thread, which runs
    every instance's jobs).

    FIFO order IS the cache-repair rule: a straggling decode step finishes
    (and updates its instance's cache) before the instance's next step
    dequeues.  A job's simulated straggle (``delay``, seconds) is slept in
    the thread before the job runs; with ``hold`` (the device thread) the
    job runs at once and its answer is held back until its start plus the
    delay.  The device thread runs under the mesh's logical rules
    (``rules``, thread-local) and on a stream of its own, and each job
    under ``per_job`` (the shared implicit replication).  A job's error is
    also handed to ``on_error``.  Every job is recorded in ``issued`` as
    (instance, kind, round, delay s, thread id) before it runs, and runs in
    a ``repro_torch.lm.job.<kind>`` span (``repro_torch.trace``)."""

    def __init__(self, name, dev, issued, rules=None, per_job=nullcontext,
                 on_error=None, hold=False):
        super().__init__(name=name, daemon=True)
        self.jobs = queue.Queue()
        self.dev, self.rules, self.per_job = dev, rules, per_job
        self.issued, self.on_error, self.hold = issued, on_error, hold

    def submit(self, fn, label, delay=None):
        """Queue ``fn`` under ``label`` (instance, kind, round); ``delay``
        gives the job's straggle in seconds when it starts."""
        evt, out = threading.Event(), {}
        self.jobs.put((fn, evt, out, label, delay))
        return evt, out

    def run(self):
        if self.dev.type == "cuda":
            # the current device is per thread; the kernels launch on it
            torch.cuda.set_device(self.dev)
        stream = torch.cuda.Stream(self.dev) if (
            self.rules and self.dev.type == "cuda") else None
        with (logical.logical_rules(*self.rules) if self.rules
              else nullcontext()), \
                (torch.cuda.stream(stream) if stream else nullcontext()):
            while True:
                job = self.jobs.get()
                if job is _SHUTDOWN:
                    break
                fn, evt, out, label, delay = job
                t0, d = time.monotonic(), 0.0
                try:
                    d = delay() if delay is not None else 0.0
                    self.issued.append((*label, d, threading.get_ident()))
                    if d and not self.hold:
                        time.sleep(d)
                    with self.per_job(), span("repro_torch.lm.job." +
                                              label[1]):
                        out["result"] = fn()
                except Exception as e:    # surfaced at collection time
                    out["error"] = e
                    if self.on_error is not None:
                        self.on_error(e)
                wait = t0 + d - time.monotonic() if self.hold else 0.0
                if wait > 0:
                    timer = threading.Timer(wait, evt.set)
                    timer.daemon = True
                    timer.start()
                else:
                    evt.set()

    def stop(self):
        self.jobs.put(_SHUTDOWN)


class _Stopped(RuntimeError):
    """A scheduler exchange on a mesh failed, or reported a rank's
    failure: every rank raises it at the same exchange."""


def _result(job):
    """Block for a submitted job; its result, or its error raised here."""
    evt, out = job
    evt.wait()
    if "error" in out:
        raise out["error"]
    return out["result"]


class _Instance:
    """One of the k + r model instances: its name, its executor, the
    parameters it serves, the deployed parameters it embeds tokens with (a
    parity instance encodes the members' embeddings) and its cache pool."""

    __slots__ = ("name", "ex", "params", "embed_params", "pool", "iid")

    def __init__(self, name, ex, params, embed_params, iid):
        self.name, self.ex = name, ex
        self.params, self.embed_params = params, embed_params
        self.iid, self.pool = iid, None


# --------------------------------------------------------------------------
# Default substrate: repro_torch.models.transformer
# --------------------------------------------------------------------------
def _transformer_fns(spec, grad_off=torch.inference_mode):
    from repro_torch.models import transformer as T
    cfg = spec.cfg

    # grad_off is per thread: each call enters it on the executor thread
    # that runs it (inference_mode, or no_grad for DTensors, which fail
    # under inference_mode)
    @grad_off()
    def prefill_fn(params, tokens=None, embeds=None, cache_len=0):
        return T.prefill(cfg, params, tokens=tokens, embeds=embeds,
                         cache_len=cache_len)

    @grad_off()
    def decode_fn(params, cache, pos, token=None, embed=None):
        return T.decode_step(cfg, params, cache, pos, token=token,
                             embed=embed)

    @grad_off()
    def embed_fn(params, tokens):
        return T.embed_tokens(cfg, params, tokens)

    def init_cache_fn(params, batch, cache_len):
        return T.init_cache(cfg, batch, cache_len, device=spec.device)

    return prefill_fn, decode_fn, embed_fn, init_cache_fn


def _resolve_fns(spec, grad_off=torch.inference_mode):
    if spec.prefill_fn is not None:
        return (spec.prefill_fn, spec.decode_fn, spec.embed_fn,
                spec.init_cache_fn)
    if spec.cfg is None or spec.params is None:
        raise ValueError(
            "GenerationSpec needs cfg= and params= (or a full "
            "prefill_fn/decode_fn/embed_fn/init_cache_fn substrate)")
    return _transformer_fns(spec, grad_off)


def place_inference_params(params, mesh):
    """Put a param tree on the inference layout of ``mesh``:
    ``ShardingRules(mesh, fsdp_params=False)`` — tensor-parallel over the
    model axis, replicated over the data axis (every member instance holds
    a full replica); plain tensors on a mesh of one device."""
    from repro_torch.distributed.sharding import ShardingRules
    rules = ShardingRules(mesh, fsdp_params=False)
    return rules.distribute(params, rules.params(params))


def place_cache_pool(pool, mesh, known=True):
    """A serving cache pool (``init_cache``'s tree, leaves [G, slots, ...])
    as DTensors on ``mesh``, a mesh of one device too (the pool of DTensor
    parameters): attention K/V [G, slots, S, KV, hd] with the slots over
    the batch axes where they divide them, the KV heads over ``model``
    where it divides them and the sequence whole on every rank; SSM states
    and conv tails as ``ShardingRules.cache_specs`` places them.

    The sequence stays whole because the decode-attention kernel (B8) runs
    on each rank's local shard and returns no log-sum-exp that shards of a
    sequence could be combined with (``layers._decode_kernel``).  Each rank
    keeps its own block of the (zero) pool: nothing is communicated.  A
    substrate override's pool (``known`` False), whose leaves the rules
    cannot name, is replicated whole on every rank."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.logical import placements
    from repro_torch.distributed.sharding import ShardingRules, _zip_map
    rules = ShardingRules(mesh, fsdp_params=False)
    specs = rules.cache_specs(pool, whole_seq=True) if known else \
        tree_map(lambda x: (None,) * x.ndim, pool)
    return _zip_map(lambda x, spec: distribute_tensor(
        x, mesh, placements(spec, mesh), src_data_rank=None), pool, specs)


def serving_rules(mesh):
    """The logical rules a serving thread enters on ``mesh`` (arguments of
    ``logical.logical_rules``): the launcher's, with the inference layout's
    resident expert weights (``fsdp_params`` False)."""
    lrules, sizes = logical.rules_for_mesh(mesh)
    lrules["fsdp_params"] = False
    return lrules, sizes, mesh


def _write_slot(pool, one, s):
    """Copy a batch-1 cache ``one`` into slot column s of ``pool``, leaf by
    leaf, in place (axis 1 is the slot axis, as in the reference's
    ``pool.at[:, s:s+1].set(one)``).  A DTensor leaf takes an elementwise
    select over a slot mask on each rank's shard, then ``copy_``: DTensor
    runs a slice assignment on a gathered copy and loses the write
    (``ROADMAP.md`` C.1)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models.layers import _replicated
    for dst, src in zip(tree_leaves(pool), tree_leaves(one)):
        if not isinstance(dst, DTensor):
            dst[:, s:s + 1] = src
            continue
        mesh, pl = dst.device_mesh, list(dst.placements)
        src_pl = [Replicate() if p == Shard(1) else p for p in pl]
        hit_pl = [Shard(0) if p == Shard(1) else Replicate() for p in pl]
        hit = torch.arange(dst.shape[1], device=dst.device) == s
        lead = (1,) * (dst.ndim - 2)

        def select(c, r, m, lead=lead):
            return torch.where(m.view(1, -1, *lead), r, c)
        dst.copy_(local_map(select, out_placements=pl,
                            in_placements=(pl, src_pl, hit_pl),
                            device_mesh=mesh, redistribute_inputs=True)(
            dst, src.to(dst.dtype), _replicated(hit, mesh)))


def _refusal(spec):
    """Why ``spec`` may not serve on its mesh and the ``ROADMAP.md`` item
    that says so, or None: a cross-attending plan, whose prefill the
    session hands no ``cross_embeds``, as the reference's does not (B.5).
    A substrate override is the user's model, not ``cfg``'s."""
    cfg = spec.cfg
    if spec.prefill_fn is None and cfg is not None and (
            cfg.enc_dec or cfg.cross_attn_every):
        return (f"{cfg.name} cross-attends, and the session hands its "
                f"prefill no cross_embeds", "B.5")
    return None


# --------------------------------------------------------------------------
# Threads engine
# --------------------------------------------------------------------------
class GenerationSession:
    """Token-level continuous batching with per-step coded redundancy.

    ``submit(prompt)`` -> ``GenerationFuture``; ``stats()`` ->
    ``ServingReport`` whose completions are decode steps (so ``median_ms``
    etc. ARE inter-token latencies) plus the per-token fields
    (``tokens_per_s``, ``inter_token_p50/p999_ms``, ``reconstructed_steps``).

    On a mesh of more than one device the session is SPMD: every rank
    builds it from the same spec, and callers submit the same requests in
    the same order on every rank, as in any ``torch.distributed`` program.
    The mesh's first rank decides each scheduler round (which waiting
    request enters which (member, slot), which members missed the step's
    deadline, the tokens emitted and so which streams finish, when to
    stop), with its own clock's timestamps, and broadcasts the round on a
    gloo side group; the other ranks apply it.  So no rank decides on its
    own clock, and ``stats()`` and every future agree on every rank.
    Every exchange also carries each rank's failure, if it has one (a job's
    error, or its scheduler's): then every rank's scheduler stops there and
    ``wait_all`` raises it on every rank.  Each rank's device thread runs
    the rounds' device work in the decided order (see the module
    docstring), so every rank issues the same collectives in the same order
    from one thread; ``issued`` records the jobs it ran (instance, kind,
    round, delay s, thread id), the last ``ISSUED_KEPT``.  Without a mesh
    (or on a mesh of one device with plain parameters) every instance has
    an executor thread of its own, as in the reference.
    """

    engine = "threads"
    ISSUED_KEPT = 4096

    def __init__(self, spec: GenerationSpec):
        self.spec = spec
        self.dev = resolve_device(spec.device)
        if self.dev.type == "cuda" and self.dev.index is None:
            # this thread's card, for every serving thread
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.scheme = get_scheme(spec.scheme, k=spec.k, r=spec.r,
                                 device=self.dev)
        self.coeffs = to_host(self.scheme.coeffs).astype(np.float32)  # [r, k]
        self.k, self.r = spec.k, spec.r
        self.n_slots = spec.batching.max_size
        self.max_seq = spec.max_seq_len

        params = spec.params
        pparams = spec.parity_params if spec.parity_params is not None \
            else params
        if spec.mesh is not None:
            params = place_inference_params(params, spec.mesh)
            pparams = params if spec.parity_params is None else \
                place_inference_params(pparams, spec.mesh)
        self.params, self.parity_params = params, pparams
        self._sharded = spec.mesh is not None and any(
            isinstance(x, DTensor) for x in tree_leaves((params, pparams)))
        fns = _resolve_fns(spec, torch.no_grad if self._sharded
                           else torch.inference_mode)
        self._prefill, self._decode, self._embed, self._init_cache = fns

        # the decider: the mesh's first rank, exchanging on a gloo group
        self._side, self._src = None, None
        self._failed = None              # this rank's first failure
        if spec.mesh is not None and spec.mesh.size() > 1:
            ranks = spec.mesh.mesh.flatten().tolist()
            self._src = ranks[0]
            self._side_ranks = sorted(ranks)  # the group's own rank order
            self._side = dist.new_group(ranks, backend="gloo")
        self._decides = self._src is None or dist.get_rank() == self._src

        # fault adapters: scenario delays compose with the user delay_fn
        delay_fn = spec.delay_fn
        self.scenario = None
        if spec.scenario is not None:
            self.scenario = get_scenario(spec.scenario)
            pool_sizes = {"main": self.k}
            for j in range(self.r):
                pool_sizes[f"parity{j}"] = 1
            delay_fn, _ = self.scenario.adapters(
                pool_sizes, seed=spec.scenario_seed,
                horizon_ms=spec.scenario_horizon_ms,
                time_scale=spec.scenario_time_scale, extra=delay_fn)
        self._delay_fn = delay_fn

        # k members and r parity instances: an executor thread each, or on
        # a mesh the rank's one device thread for all of them
        self.issued = collections.deque(maxlen=self.ISSUED_KEPT)
        self._round = 0
        device = None
        if self._sharded:
            device = _Executor("lm-device", self.dev, self.issued,
                               serving_rules(spec.mesh),
                               logical.implicit_replication, self._fail,
                               hold=True)
        roles = [("member", i, params, instance_id("main", i))
                 for i in range(self.k)] + \
            [("parity", j, pparams, instance_id(f"parity{j}", 0))
             for j in range(self.r)]
        self._members, self._parities = [], []
        for role, n, p, iid in roles:
            name = f"lm-{role}-{n}"
            ex = device or _Executor(name, self.dev, self.issued)
            inst = _Instance(name, ex, p, params, iid)
            (self._members if role == "member" else self._parities).append(
                inst)
        self._instances = self._members + self._parities
        self._executors = list(dict.fromkeys(
            inst.ex for inst in self._instances))
        if self._sharded and self.dev.type == "cuda":
            # the parameters, placed on this thread's stream, before the
            # device thread's own stream reads them
            torch.cuda.current_stream(self.dev).synchronize()
        for ex in self._executors:
            ex.start()

        # one fixed-shape cache pool per instance (slots never reshape),
        # then the prefill and both decode paths warmed before any deadline
        # is armed: the kernels' build and first launches would otherwise
        # read as a multi-second straggle on every instance at once, which
        # no code survives.  The decodes write a scratch pool of the served
        # layout that is then dropped, as the reference drops its warm-up
        # caches: a decode advances an SSM state, so no served pool may see
        # one.  On a mesh every instance warms on the device thread, in
        # order; without one, once, here.
        if self._sharded:
            for job in [self._submit(inst, "warm",
                                     lambda inst=inst: self._warm(inst))
                        for inst in self._instances]:
                _result(job)
        else:
            for inst in self._instances:
                inst.pool = self._new_pool(inst)
            self._warm_once()
        self._ppos = np.zeros((self.r, self.n_slots), np.int64)

        # (member, slot) occupancy
        self._slots: List[List[Optional[_Stream]]] = [
            [None] * self.n_slots for _ in range(self.k)]
        self._dirty = set()              # slot columns needing parity rebuild

        self._waiting: Dict[int, tuple] = {}   # rid -> request, in order
        self._lock = threading.Condition()
        self._stopping = False
        self._error = None
        self._idle = threading.Event()   # set while nothing queued/active
        self._idle.set()
        self._gaps_ms: List[float] = []
        self._completed_by: Dict[str, int] = {}
        self._recon_steps = 0
        self._t0 = None
        self._t1 = None
        self._next_rid = 0
        self._scheduler = threading.Thread(target=self._loop,
                                           name="lm-scheduler", daemon=True)
        self._scheduler.start()

    def _new_pool(self, inst):
        pool = self._init_cache(inst.params, self.n_slots, self.max_seq)
        if self._sharded:
            pool = place_cache_pool(pool, self.spec.mesh,
                                    known=self.spec.prefill_fn is None)
        return pool

    def _submit(self, inst, kind, fn, delayed=False):
        """Queue ``fn`` on ``inst``'s executor, labelled with this round;
        ``delayed``: the job takes the instance's simulated straggle."""
        return inst.ex.submit(
            fn, (inst.name, kind, self._round),
            (lambda: self._sleep_for(inst.iid)) if delayed else None)

    def _warm_once(self):
        tok0 = torch.zeros((self.n_slots, 1), dtype=torch.int32,
                           device=self.dev)
        pos0 = torch.zeros((self.n_slots,), dtype=torch.int32,
                           device=self.dev)
        self._prefill(self.params, tokens=tok0[:1], cache_len=self.max_seq)
        scratch = self._new_pool(self._members[0])
        self._decode(self.params, scratch, pos0, token=tok0)
        self._decode(self.parity_params, scratch, pos0,
                     embed=self._embed(self.params, tok0))

    def _warm(self, inst):
        inst.pool = self._new_pool(inst)
        tok0 = torch.zeros((self.n_slots, 1), dtype=torch.int32,
                           device=self.dev)
        pos0 = torch.zeros((self.n_slots,), dtype=torch.int32,
                           device=self.dev)
        scratch = self._new_pool(inst)
        if inst in self._members:
            self._prefill(inst.params, tokens=tok0[:1],
                          cache_len=self.max_seq)
            self._decode(inst.params, scratch, pos0, token=tok0)
        else:
            self._prefill(inst.params, embeds=self._embed(
                inst.embed_params, tok0[:1]), cache_len=self.max_seq)
            self._decode(inst.params, scratch, pos0,
                         embed=self._embed(inst.embed_params, tok0))

    # -- public surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens=None) -> GenerationFuture:
        """Queue one generation request (prompt: sequence of token ids).  On
        a mesh of more than one device, every rank submits the same
        requests in the same order (see the class docstring)."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("session is shut down")
            rid = self._next_rid
            self._next_rid += 1
            fut = GenerationFuture(rid)
            self._idle.clear()
            self._waiting[rid] = ([int(t) for t in prompt],
                                  max_new_tokens or self.spec.max_new_tokens,
                                  fut)
            self._lock.notify_all()
        return fut

    def wait_all(self, timeout: float = 120.0) -> bool:
        """Block until every submitted request has finished; raises the
        scheduler's error if it stopped on one."""
        done = self._idle.wait(timeout)
        if self._error is not None:
            raise RuntimeError(f"the LM scheduler failed: {self._error}") \
                from self._error
        return done

    def stats(self) -> ServingReport:
        with self._lock:
            gaps = np.asarray(self._gaps_ms, float)
            n = len(gaps)
            span = (self._t1 - self._t0) if (self._t0 is not None
                                             and self._t1 is not None
                                             and self._t1 > self._t0) else 0.0
            pct = (lambda q: float(np.percentile(gaps, q))) if n else \
                (lambda q: float("nan"))
            return ServingReport(
                engine="threads", strategy="parm",
                scheme=getattr(self.scheme, "name", str(self.spec.scheme)),
                scenario=getattr(self.scenario, "name", None),
                n=n, median_ms=pct(50), p99_ms=pct(99), p999_ms=pct(99.9),
                mean_ms=float(gaps.mean()) if n else float("nan"),
                max_ms=float(gaps.max()) if n else float("nan"),
                completed_by=dict(self._completed_by),
                reconstructions=self._recon_steps,
                tokens_per_s=(n / span) if span else 0.0,
                inter_token_p50_ms=pct(50), inter_token_p999_ms=pct(99.9),
                reconstructed_steps=self._recon_steps)

    def shutdown(self):
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            self._lock.notify_all()
        self._scheduler.join(timeout=60.0)
        for ex in self._executors:
            ex.stop()
        # every issued job ends before the side group goes: on a mesh the
        # device thread's jobs hold collectives that the other ranks meet.
        # After a failure a job may wait for a rank that never comes; the
        # group is then left to its timeout.
        wait_s = 300.0 if self._side is not None and self._error is None \
            else 10.0
        deadline = time.monotonic() + wait_s
        for ex in self._executors:
            ex.join(timeout=max(0.0, deadline - time.monotonic()))
        if self._side is not None and not any(
                ex.is_alive() for ex in self._executors):
            dist.destroy_process_group(self._side)
            self._side = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- scheduler ---------------------------------------------------------
    def _fail(self, e):
        """Record this rank's first failure, for the next exchange."""
        if self._failed is None:
            self._failed = f"{type(e).__name__}: {e}"

    def _share(self, obj):
        """The decider's ``obj`` on every rank (``obj`` itself off a mesh).
        Every rank sends its failure with it, if it has one; then every
        rank raises ``_Stopped`` here, naming the ranks that failed."""
        if self._side is None:
            return obj
        box = [None] * len(self._side_ranks)
        try:
            dist.all_gather_object(
                box, (self._failed, obj if self._decides else None),
                group=self._side)
        except Exception as e:
            raise _Stopped(f"the scheduler exchange failed: {e}") from e
        failed = [f"rank {r}: {f}" for r, (f, _) in
                  zip(self._side_ranks, box) if f is not None]
        if failed:
            raise _Stopped("; ".join(failed))
        return box[self._side_ranks.index(self._src)][1]

    def _active(self):
        return [(i, s) for i in range(self.k) for s in range(self.n_slots)
                if self._slots[i][s] is not None]

    def _free(self):
        return [(i, s) for i in range(self.k) for s in range(self.n_slots)
                if self._slots[i][s] is None]

    def _loop(self):
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
        try:
            while True:
                self._round += 1
                plan = self._share(self._decide() if self._decides
                                   else None)
                if plan == "stop":
                    break
                self._admit(plan)
                active = self._active()
                if active:
                    self._step(active)
                with self._lock:
                    if not self._active() and not self._waiting:
                        self._idle.set()
        except Exception as e:           # surfaced by wait_all
            if self._side is not None and not isinstance(e, _Stopped):
                # the other ranks stop at the exchange they meet next, and
                # every rank raises what that exchange says
                self._fail(e)
                try:
                    self._share(None)
                except _Stopped as stopped:
                    e = stopped
            self._error = e
            self._idle.set()

    def _decide(self):
        """The decider's next round: the admissions [(rid, prompt,
        max_new, member, slot, t_admit)] into free (member, slot) pairs in
        order, once there are active streams or an admission; "stop" once
        shut down with nothing active or waiting.  Waits while idle; on a
        mesh, for a second at most, so that idle ranks still exchange (a
        failure reaches them, and no exchange outwaits its group's
        timeout)."""
        beat = time.monotonic() + 1.0
        with self._lock:
            while True:
                free, active = self._free(), self._active()
                plan = [(rid, prompt, max_new, i, s, time.monotonic())
                        for (rid, (prompt, max_new, _)), (i, s)
                        in zip(self._waiting.items(), free)]
                if plan or active:
                    return plan
                if not self._waiting:
                    self._idle.set()
                    if self._stopping:
                        return "stop"
                if self._side is not None and time.monotonic() > beat:
                    return plan
                self._lock.wait(1e-3)

    def _take(self, rid, prompt):
        """Request ``rid`` out of the waiting queue: the decider's, or, on
        another rank, the same request submitted there (waited for)."""
        with self._lock:
            if not self._lock.wait_for(lambda: rid in self._waiting,
                                       timeout=300.0):
                raise TimeoutError(
                    f"request {rid} was admitted on rank {self._src} but "
                    f"never submitted here: on a mesh every rank submits "
                    f"the same requests in the same order")
            mine, _, fut = self._waiting.pop(rid)
        if mine != prompt:
            raise ValueError(f"request {rid} differs between ranks: on a "
                             f"mesh every rank submits the same requests in "
                             f"the same order")
        return fut

    def _sleep_for(self, iid):
        if self._delay_fn is None:
            return 0.0
        try:
            return float(self._delay_fn(iid) or 0.0)
        except TypeError:
            return 0.0

    def _admit(self, plan):
        """Prefill the decided admissions into their (member, slot) pairs,
        emit each first token, and rebuild the parity columns whose
        occupancy changed."""
        if plan:
            self._prefill_admitted(plan)
        for s in sorted(self._dirty):
            self._rebuild_parity(s)
        self._dirty.clear()

    def _prefill_admitted(self, plan):
        with span("repro_torch.lm.admit.prefill"):
            jobs = []
            for rid, prompt, max_new, i, s, t_admit in plan:
                stream = _Stream(rid, prompt, max_new,
                                 self._take(rid, prompt), t_admit)
                self._slots[i][s] = stream
                if self._t0 is None:
                    with self._lock:
                        self._t0 = t_admit
                inst = self._members[i]

                def job(prompt=prompt, inst=inst, s=s):
                    toks = torch.tensor([prompt], dtype=torch.int32,
                                        device=self.dev)          # [1, P]
                    logits, one = self._prefill(inst.params, tokens=toks,
                                                cache_len=self.max_seq)
                    _write_slot(inst.pool, one, s)
                    with span("repro_torch.lm.sync"):
                        return to_host(logits[0, -1])
                jobs.append(self._submit(inst, "prefill", job, delayed=True))
            # first tokens come from the prefill logits (admission path,
            # uncoded); decode steps from here on are coded
            rows = [_result(job) for job in jobs]
        firsts, now = self._share(
            ([int(np.argmax(row)) for row in rows], time.monotonic())
            if self._decides else None)
        for (_, _, _, i, s, _), tok in zip(plan, firsts):
            stream = self._slots[i][s]
            stream.future._times.append(stream.t_admit)
            stream.future._emit(tok, now, reconstructed=False)
            stream.next_token = tok
            self._record(now - stream.t_admit, now, reconstructed=False)
            self._dirty.add(s)
            if stream.max_new <= 1:
                self._finish(i, s)

    def _encode(self, j, embs):
        """Parity j's input: ``sum_i C[j, i] * embs[i]`` in fp32 (``embs[i]``
        None for an empty member), in the embeddings' dtype; python
        coefficients, so the sum runs on DTensors as it does on tensors."""
        enc = None
        for i, e in enumerate(embs):
            if e is not None:
                term = float(self.coeffs[j, i]) * e.float()
                enc = term if enc is None else enc + term
        return enc.to(next(e.dtype for e in embs if e is not None))

    def _rebuild_parity(self, s):
        """Re-prefill parity slot column s from the encoded histories of its
        current occupants (right-aligned; empty members contribute zeros).

        Occupants admitted at different times sit at different positions;
        right-alignment matches the newest suffix, which is exact for
        position-independent substrates and the trained-parity
        approximation otherwise (DESIGN.md §13)."""
        from repro_torch.models.layers import pad_seq
        hists = []
        for i in range(self.k):
            st = self._slots[i][s]
            hists.append(st.history if st is not None else [])
        L = max((len(h) for h in hists), default=0)
        if L == 0:
            for j in range(self.r):
                self._ppos[j, s] = 0
            return
        with span("repro_torch.lm.admit.rebuild"):
            jobs = []
            for j, inst in enumerate(self._parities):
                def job(j=j, inst=inst):
                    # encoded prompt embeddings [1, L, D], left-padded
                    embs = [pad_seq(self._embed(
                        inst.embed_params, torch.tensor(
                            [h], dtype=torch.int32, device=self.dev)),
                        L - len(h), 0) if h else None for h in hists]
                    _, one = self._prefill(inst.params,
                                           embeds=self._encode(j, embs),
                                           cache_len=self.max_seq)
                    _write_slot(inst.pool, one, s)
                jobs.append(self._submit(inst, "rebuild", job))
            for j, job in enumerate(jobs):
                _result(job)
                self._ppos[j, s] = L

    def _step(self, active):
        """One coded decode step for every active stream."""
        k, n_slots = self.k, self.n_slots
        tok = np.zeros((k, n_slots, 1), np.int32)
        pos = np.zeros((k, n_slots), np.int32)
        occ = np.zeros((k, n_slots), bool)
        for i, s in active:
            st = self._slots[i][s]
            tok[i, s, 0] = st.next_token
            pos[i, s] = st.pos
            occ[i, s] = True

        # member jobs: full fixed-shape batch, per-slot positions (each job
        # moves its own inputs to the card, on its instance's stream)
        member_out = []
        for i, inst in enumerate(self._members):
            def job(inst=inst, ti=tok[i], pi=pos[i]):
                logits, inst.pool = self._decode(
                    inst.params, inst.pool,
                    torch.as_tensor(pi, device=self.dev),
                    token=torch.as_tensor(ti, device=self.dev))
                with span("repro_torch.lm.sync"):
                    return to_host(logits)         # [n_slots, 1, V]

            member_out.append(self._submit(inst, "decode", job,
                                           delayed=True))

        # parity jobs: encoded input embedding, own cache column positions.
        # Unoccupied (member, slot) cells carry token 0 only for shape — mask
        # their embeddings to zero so they contribute nothing to the code.
        parity_out = []
        active_slots = {s for _, s in active}
        for j, inst in enumerate(self._parities):
            def pjob(j=j, inst=inst, ppos_j=self._ppos[j].astype(np.int32)):
                toks = torch.as_tensor(tok.reshape(k * n_slots, 1),
                                       device=self.dev)
                mask = torch.as_tensor(occ, device=self.dev)
                embs = self._embed(inst.embed_params, toks).reshape(
                    k, n_slots, 1, -1) * mask[:, :, None, None]
                logits, inst.pool = self._decode(
                    inst.params, inst.pool,
                    torch.as_tensor(ppos_j, device=self.dev),
                    embed=self._encode(j, embs.unbind(0)))
                with span("repro_torch.lm.sync"):
                    return to_host(logits)
            parity_out.append(self._submit(inst, "decode", pjob,
                                           delayed=True))
            self._ppos[j][list(active_slots)] += 1

        outcome = self._share(self._collect(active, member_out, parity_out,
                                            occ) if self._decides else None)
        tokens, reconstructed, used, now = outcome
        if not self._decides:
            # the jobs whose results the decider used; their errors here
            for i in used[0]:
                _result(member_out[i])
            for j in used[1]:
                _result(parity_out[j])

        # emit canonical tokens; feed them back regardless of which side
        # (member or parity decode) produced the logits
        for (i, s), tok_out in zip(active, tokens):
            st = self._slots[i][s]
            recon = i in reconstructed
            gap = now - st.future._times[-1]
            st.future._emit(tok_out, now, reconstructed=recon)
            self._record(gap, now, reconstructed=recon)
            st.next_token = tok_out
            st.pos += 1
            if len(st.future.tokens_so_far) >= st.max_new or \
                    st.pos >= self.max_seq - 1:
                self._finish(i, s)

    def _collect(self, active, member_out, parity_out, occ):
        """The decider's outcome of a step: the members' logits within the
        per-step straggle deadline, a missing member's rebuilt from the
        parity logits, and from them (tokens by active (member, slot) in
        order, the rebuilt members, (the members and parities whose
        results were used), the time)."""
        k, n_slots = self.k, self.n_slots
        deadline = time.monotonic() + self.spec.straggle_ms / 1e3
        logits = [None] * k
        missing = []
        for i, (evt, out) in enumerate(member_out):
            if evt.wait(max(0.0, deadline - time.monotonic())):
                logits[i] = _result((evt, out))
            else:
                missing.append(i)

        reconstructed, used_p = set(), []
        if missing:
            pavail = np.zeros((self.r,), bool)
            plogits = [None] * self.r
            for j, (evt, out) in enumerate(parity_out):
                if evt.wait(max(0.0, deadline - time.monotonic())):
                    plogits[j] = _result((evt, out))
                    pavail[j] = True
            if len(missing) <= int(pavail.sum()):
                used_p = [j for j in range(self.r) if pavail[j]]
                V = next(x for x in logits if x is not None).shape[-1] \
                    if any(x is not None for x in logits) else \
                    plogits[int(np.argmax(pavail))].shape[-1]
                outs = np.stack([
                    x if x is not None else
                    np.zeros((n_slots, 1, V), np.float32)
                    for x in logits])                       # [k, n, 1, V]
                # an available member's unoccupied slots decoded garbage
                # (token 0) that the parity never encoded — mask them so
                # the residual subtraction stays exact
                outs = outs * occ[:, :, None, None]
                pouts = np.stack([
                    p if p is not None else
                    np.zeros((n_slots, 1, V), np.float32)
                    for p in plogits])                      # [r, n, 1, V]
                mask = np.zeros((k,), bool)
                mask[missing] = True
                rec = to_host(self.scheme.decode(
                    pouts.astype(np.float32), outs.astype(np.float32), mask,
                    pavail))
                for i in missing:
                    logits[i] = rec[i]
                    reconstructed.add(i)
            else:
                # irrecoverable this step: block for the stragglers
                for i in missing:
                    logits[i] = _result(member_out[i])
        tokens = [int(np.argmax(logits[i][s, 0])) for i, s in active]
        used_m = [i for i in range(k) if i not in reconstructed]
        return tokens, sorted(reconstructed), (used_m, used_p), \
            time.monotonic()

    def _record(self, gap_s, now, *, reconstructed):
        with self._lock:
            self._gaps_ms.append(1e3 * gap_s)
            key = "parity" if reconstructed else "model"
            self._completed_by[key] = self._completed_by.get(key, 0) + 1
            if reconstructed:
                self._recon_steps += 1
            self._t1 = now

    def _finish(self, i, s):
        st = self._slots[i][s]
        self._slots[i][s] = None
        self._dirty.add(s)
        st.future._finish("model")


# --------------------------------------------------------------------------
# Sim engine: roofline-calibrated token-level DES
# --------------------------------------------------------------------------
def token_service_ms(spec: GenerationSpec) -> float:
    """Roofline decode-step service time (ms) for the spec's config on
    ``spec.hardware`` (default: the H100 SXM data sheet)."""
    from repro_torch.launch.roofline import H100_SXM, decode_token_cost
    if spec.cfg is None:
        raise ValueError("sim engine calibration needs spec.cfg")
    return 1e3 * decode_token_cost(spec.cfg, batch=spec.batching.max_size,
                                   kv_len=spec.kv_len, tp=spec.tp,
                                   hw=spec.hardware or H100_SXM)


def _tokenize_report(report: ServingReport, tokens_per_s: float):
    """Surface a DES report's completions under their per-token names: each
    DES query was one decode step, so median/p999 ARE inter-token
    latencies."""
    from dataclasses import replace as drep
    return drep(report, tokens_per_s=tokens_per_s,
                inter_token_p50_ms=report.median_ms,
                inter_token_p999_ms=report.p999_ms,
                reconstructed_steps=report.reconstructions)


class LMSimSession:
    """Token-level DES: every decode step of ``m`` member streams is one
    simulated query at the roofline-calibrated service time, so the
    existing simulator (fast path included) prices 10M-token tail studies
    of the big configs without running a single matmul."""

    engine = "sim"

    def __init__(self, spec: GenerationSpec):
        self.spec = spec
        self._last: Optional[ServingReport] = None

    def replay(self, n_tokens: int = 100_000, *, seed: int = 0,
               service_cv: float = 0.1, **trace_overrides) -> ServingReport:
        spec = self.spec
        step_ms = token_service_ms(spec)
        qps = spec.utilization * spec.m * 1e3 / step_ms
        dspec = DeploymentSpec(
            strategy=spec.strategy, scheme=spec.scheme, k=spec.k, r=spec.r,
            m=spec.m, scenario=spec.scenario,
            batching=BatchingPolicy(max_size=1), device=spec.device)
        trace = Trace(n_queries=int(n_tokens), qps=qps, service_ms=step_ms,
                      service_cv=service_cv, seed=seed, **trace_overrides)
        report = deploy(dspec, engine="sim").replay(trace)
        self._last = _tokenize_report(report, tokens_per_s=qps)
        return self._last

    def stats(self) -> ServingReport:
        if self._last is None:
            raise RuntimeError("no replay has run yet — call "
                               "session.replay(n_tokens=...) first")
        return self._last

    def shutdown(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def deploy_lm(spec: GenerationSpec, engine: str = "threads"):
    """Bring a ``GenerationSpec`` up on one of the two serving engines."""
    if not isinstance(spec, GenerationSpec):
        raise TypeError(f"deploy_lm() takes a GenerationSpec, got {spec!r}")
    if engine == "threads":
        return GenerationSession(spec)
    if engine == "sim":
        return LMSimSession(spec)
    raise ValueError(f"unknown engine {engine!r}; one of ('threads', 'sim')")
