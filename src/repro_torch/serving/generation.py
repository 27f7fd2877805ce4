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
instance i's executor, whose FIFO queue still serializes a straggler's late
step before its next one — the cache-repair rule is unchanged.  A decode
advances an SSM state, so each served pool sees exactly the decodes the
reference keeps: one per coded step, and none from the warm-up.  Executors launch on PyTorch's current
stream; ``to_host`` on the logits is the sync point.  ``GenerationSpec``
drops the reference's ``mesh`` (the port serves on one card) and gains
``device`` and ``hardware`` (the sim engine's roofline device).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.convert import resolve_device, to_host, tree_leaves
from repro_torch.core.scheme import get_scheme
from repro_torch.serving.api import (BatchingPolicy, DeploymentSpec, Trace,
                                     deploy)
from repro_torch.serving.report import ServingReport
from repro_torch.serving.scenarios import get_scenario, instance_id

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
    The reference's ``mesh`` (a sharded inference layout) is dropped: the
    port serves on one card.
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

    def __init__(self, rid, prompt, max_new, future):
        self.rid = rid
        self.prompt = prompt             # list[int], inputs already consumed
        self.max_new = max_new
        self.pos = len(prompt)           # cache fill == next write position
        self.next_token = None           # canonical feedback token
        self.future = future
        self.t_admit = time.monotonic()

    @property
    def history(self):
        """All input tokens consumed so far (prompt + fed-back emissions)."""
        return self.prompt + self.future.tokens_so_far[:-1] \
            if self.future.tokens_so_far else self.prompt


class _Executor(threading.Thread):
    """One model instance: a worker thread draining a FIFO job queue.

    FIFO order IS the cache-repair rule: a straggling decode step finishes
    (and updates this instance's cache) before the next step dequeues."""

    def __init__(self, name):
        super().__init__(name=name, daemon=True)
        self.jobs = queue.Queue()

    def submit(self, fn):
        evt, out = threading.Event(), {}
        self.jobs.put((fn, evt, out))
        return evt, out

    def run(self):
        while True:
            job = self.jobs.get()
            if job is _SHUTDOWN:
                break
            fn, evt, out = job
            try:
                out["result"] = fn()
            except Exception as e:        # surfaced at collection time
                out["error"] = e
            evt.set()

    def stop(self):
        self.jobs.put(_SHUTDOWN)


# --------------------------------------------------------------------------
# Default substrate: repro_torch.models.transformer
# --------------------------------------------------------------------------
def _transformer_fns(spec):
    from repro_torch.models import transformer as T
    cfg = spec.cfg

    # inference_mode is per thread: each call enters it on the executor
    # thread that runs it
    @torch.inference_mode()
    def prefill_fn(params, tokens=None, embeds=None, cache_len=0):
        return T.prefill(cfg, params, tokens=tokens, embeds=embeds,
                         cache_len=cache_len)

    @torch.inference_mode()
    def decode_fn(params, cache, pos, token=None, embed=None):
        return T.decode_step(cfg, params, cache, pos, token=token,
                             embed=embed)

    @torch.inference_mode()
    def embed_fn(params, tokens):
        return T.embed_tokens(cfg, params, tokens)

    def init_cache_fn(params, batch, cache_len):
        return T.init_cache(cfg, batch, cache_len, device=spec.device)

    return prefill_fn, decode_fn, embed_fn, init_cache_fn


def _resolve_fns(spec):
    if spec.prefill_fn is not None:
        return (spec.prefill_fn, spec.decode_fn, spec.embed_fn,
                spec.init_cache_fn)
    if spec.cfg is None or spec.params is None:
        raise ValueError(
            "GenerationSpec needs cfg= and params= (or a full "
            "prefill_fn/decode_fn/embed_fn/init_cache_fn substrate)")
    return _transformer_fns(spec)


def _write_slot(pool, one, s):
    """Copy a batch-1 cache ``one`` into slot column s of ``pool``, leaf by
    leaf, in place (axis 1 is the slot axis, as in the reference's
    ``pool.at[:, s:s+1].set(one)``)."""
    for dst, src in zip(tree_leaves(pool), tree_leaves(one)):
        dst[:, s:s + 1] = src


# --------------------------------------------------------------------------
# Threads engine
# --------------------------------------------------------------------------
class GenerationSession:
    """Token-level continuous batching with per-step coded redundancy.

    ``submit(prompt)`` -> ``GenerationFuture``; ``stats()`` ->
    ``ServingReport`` whose completions are decode steps (so ``median_ms``
    etc. ARE inter-token latencies) plus the per-token fields
    (``tokens_per_s``, ``inter_token_p50/p999_ms``, ``reconstructed_steps``).
    """

    engine = "threads"

    def __init__(self, spec: GenerationSpec):
        self.spec = spec
        self.dev = resolve_device(spec.device)
        self.scheme = get_scheme(spec.scheme, k=spec.k, r=spec.r,
                                 device=spec.device)
        self.coeffs = torch.as_tensor(self.scheme.coeffs, dtype=torch.float32,
                                      device=self.dev)            # [r, k]
        fns = _resolve_fns(spec)
        self._prefill, self._decode, self._embed, self._init_cache = fns
        self.k, self.r = spec.k, spec.r
        self.n_slots = spec.batching.max_size
        self.max_seq = spec.max_seq_len

        params = spec.params
        pparams = spec.parity_params if spec.parity_params is not None \
            else params
        self.params, self.parity_params = params, pparams

        # one fixed-shape cache pool per instance; slots never reshape
        self._caches = [self._init_cache(params, self.n_slots, self.max_seq)
                        for _ in range(self.k)]
        self._pcaches = [self._init_cache(pparams, self.n_slots,
                                          self.max_seq)
                         for _ in range(self.r)]
        self._ppos = np.zeros((self.r, self.n_slots), np.int64)

        # (member, slot) occupancy
        self._slots: List[List[Optional[_Stream]]] = [
            [None] * self.n_slots for _ in range(self.k)]
        self._dirty = set()              # slot columns needing parity rebuild

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
        self._member_iids = [instance_id("main", i) for i in range(self.k)]
        self._parity_iids = [instance_id(f"parity{j}", 0)
                             for j in range(self.r)]

        self._members = [_Executor(f"lm-member-{i}") for i in range(self.k)]
        self._parities = [_Executor(f"lm-parity-{j}") for j in range(self.r)]
        for ex in self._members + self._parities:
            ex.start()

        # warm the prefill and both decode paths before any deadline is
        # armed — the kernels' build and first launches would otherwise read
        # as a multi-second straggle on every instance at once, which no
        # code survives.  The decodes write a scratch pool of the same shape
        # that is then dropped, as the reference drops its warm-up caches:
        # a decode advances an SSM state, so no served pool may see one.
        tok0 = torch.zeros((self.n_slots, 1), dtype=torch.int32,
                           device=self.dev)
        pos0 = torch.zeros((self.n_slots,), dtype=torch.int32,
                           device=self.dev)
        self._prefill(self.params, tokens=tok0[:1], cache_len=self.max_seq)
        scratch = self._init_cache(params, self.n_slots, self.max_seq)
        self._decode(self.params, scratch, pos0, token=tok0)
        self._decode(self.parity_params, scratch, pos0,
                     embed=self._embed(self.params, tok0))
        del scratch

        self._waiting: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stopping = False
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

    # -- public surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens=None) -> GenerationFuture:
        """Queue one generation request (prompt: sequence of token ids)."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("session is shut down")
            rid = self._next_rid
            self._next_rid += 1
        fut = GenerationFuture(rid)
        self._idle.clear()
        self._waiting.put((rid, [int(t) for t in prompt],
                           max_new_tokens or self.spec.max_new_tokens, fut))
        return fut

    def wait_all(self, timeout: float = 120.0) -> bool:
        """Block until every submitted request has finished."""
        return self._idle.wait(timeout)

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
        self._scheduler.join(timeout=60.0)
        for ex in self._members + self._parities:
            ex.stop()
        for ex in self._members + self._parities:
            ex.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- scheduler ---------------------------------------------------------
    def _active(self):
        return [(i, s) for i in range(self.k) for s in range(self.n_slots)
                if self._slots[i][s] is not None]

    def _loop(self):
        while True:
            self._admit()
            active = self._active()
            if not active:
                with self._lock:
                    stop = self._stopping
                if self._waiting.empty():
                    self._idle.set()
                    if stop:
                        break
                    time.sleep(1e-3)
                    continue
            else:
                self._step(active)
        # flush: nothing active remains by construction

    def _sleep_for(self, iid):
        if self._delay_fn is None:
            return 0.0
        try:
            return float(self._delay_fn(iid) or 0.0)
        except TypeError:
            return 0.0

    def _admit(self):
        """Fill free (member, slot) pairs from the waiting queue; rebuild
        parity columns whose occupancy changed."""
        admitted = False
        while True:
            free = [(i, s) for i in range(self.k)
                    for s in range(self.n_slots)
                    if self._slots[i][s] is None]
            if not free:
                break
            try:
                rid, prompt, max_new, fut = self._waiting.get_nowait()
            except queue.Empty:
                break
            i, s = free[0]
            stream = _Stream(rid, prompt, max_new, fut)
            self._slots[i][s] = stream
            if self._t0 is None:
                with self._lock:
                    self._t0 = time.monotonic()

            toks = torch.tensor([prompt], dtype=torch.int32,
                                device=self.dev)              # [1, P]
            ex = self._members[i]

            def job(toks=toks, i=i, s=s, stream=stream):
                iid = self._member_iids[i]
                d = self._sleep_for(iid)
                if d:
                    time.sleep(d)
                logits, one = self._prefill(self.params, tokens=toks,
                                            cache_len=self.max_seq)
                _write_slot(self._caches[i], one, s)
                return to_host(logits[0, -1])

            evt, out = ex.submit(job)
            evt.wait()
            if "error" in out:
                raise out["error"]
            # first token comes from the prefill logits (admission path,
            # uncoded); decode steps from here on are coded
            tok = int(np.argmax(out["result"]))
            now = time.monotonic()
            stream.future._times.append(stream.t_admit)
            stream.future._emit(tok, now, reconstructed=False)
            stream.next_token = tok
            self._record(now - stream.t_admit, reconstructed=False)
            self._dirty.add(s)
            admitted = True
            if stream.max_new <= 1:
                self._finish(i, s)
        if admitted or self._dirty:
            for s in sorted(self._dirty):
                self._rebuild_parity(s)
            self._dirty.clear()

    def _rebuild_parity(self, s):
        """Re-prefill parity slot column s from the encoded histories of its
        current occupants (right-aligned; empty members contribute zeros).

        Occupants admitted at different times sit at different positions;
        right-alignment matches the newest suffix, which is exact for
        position-independent substrates and the trained-parity
        approximation otherwise (DESIGN.md §13)."""
        hists = []
        for i in range(self.k):
            st = self._slots[i][s]
            hists.append(st.history if st is not None else [])
        L = max((len(h) for h in hists), default=0)
        if L == 0:
            for j in range(self.r):
                self._ppos[j, s] = 0
            return
        # encoded prompt embeddings [1, L, D]
        embs = []
        for h in hists:
            if h:
                e = self._embed(self.params, torch.tensor(
                    [h], dtype=torch.int32, device=self.dev))
            else:
                e = None
            embs.append(e)
        D = next(e.shape[-1] for e in embs if e is not None)
        dt = next(e.dtype for e in embs if e is not None)
        for j in range(self.r):
            enc = torch.zeros((1, L, D), dtype=torch.float32,
                              device=self.dev)
            for i, e in enumerate(embs):
                if e is not None:
                    enc[:, L - e.shape[1]:] += self.coeffs[j, i] * e.float()
            enc = enc.to(dt)

            def job(enc=enc, j=j, s=s):
                _, one = self._prefill(self.parity_params, embeds=enc,
                                       cache_len=self.max_seq)
                _write_slot(self._pcaches[j], one, s)
                return None

            evt, out = self._parities[j].submit(job)
            evt.wait()
            if "error" in out:
                raise out["error"]
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

        # member jobs: full fixed-shape batch, per-slot positions
        member_out = []
        for i in range(k):
            ti = torch.as_tensor(tok[i], device=self.dev)
            pi = torch.as_tensor(pos[i], device=self.dev)

            def job(i=i, ti=ti, pi=pi):
                d = self._sleep_for(self._member_iids[i])
                if d:
                    time.sleep(d)
                logits, new = self._decode(self.params, self._caches[i],
                                           pi, token=ti)
                self._caches[i] = new
                return to_host(logits)             # [n_slots, 1, V]

            member_out.append(self._members[i].submit(job))

        # parity jobs: encoded input embedding, own cache column positions.
        # Unoccupied (member, slot) cells carry token 0 only for shape — mask
        # their embeddings to zero so they contribute nothing to the code.
        embs = self._embed(self.params, torch.as_tensor(
            tok.reshape(k * n_slots, 1), device=self.dev))
        embs = embs.reshape(k, n_slots, 1, -1)
        embs = embs * torch.as_tensor(occ, device=self.dev)[:, :, None, None]
        parity_out = []
        active_slots = {s for _, s in active}
        for j in range(self.r):
            enc_j = torch.einsum("i,ind->nd", self.coeffs[j],
                                 embs[:, :, 0].float()).to(embs.dtype)[:, None]
            ppos_j = torch.as_tensor(self._ppos[j].astype(np.int32),
                                     device=self.dev)

            def pjob(j=j, enc_j=enc_j, ppos_j=ppos_j):
                d = self._sleep_for(self._parity_iids[j])
                if d:
                    time.sleep(d)
                logits, new = self._decode(self.parity_params,
                                           self._pcaches[j], ppos_j,
                                           embed=enc_j)
                self._pcaches[j] = new
                return to_host(logits)
            parity_out.append(self._parities[j].submit(pjob))
            self._ppos[j][list(active_slots)] += 1

        # collect with the per-step straggle deadline
        deadline = time.monotonic() + self.spec.straggle_ms / 1e3
        logits = [None] * k
        missing = []
        for i, (evt, out) in enumerate(member_out):
            if evt.wait(max(0.0, deadline - time.monotonic())):
                if "error" in out:
                    raise out["error"]
                logits[i] = out["result"]
            else:
                missing.append(i)

        reconstructed = set()
        if missing:
            pavail = np.zeros((self.r,), bool)
            plogits = [None] * self.r
            for j, (evt, out) in enumerate(parity_out):
                if evt.wait(max(0.0, deadline - time.monotonic())):
                    if "error" in out:
                        raise out["error"]
                    plogits[j] = out["result"]
                    pavail[j] = True
            if len(missing) <= int(pavail.sum()):
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
                    evt, out = member_out[i]
                    evt.wait()
                    if "error" in out:
                        raise out["error"]
                    logits[i] = out["result"]

        # emit canonical tokens; feed them back regardless of which side
        # (member or parity decode) produced the logits
        now = time.monotonic()
        for i, s in active:
            st = self._slots[i][s]
            recon = i in reconstructed
            tok_out = int(np.argmax(logits[i][s, 0]))
            gap = now - st.future._times[-1]
            st.future._emit(tok_out, now, reconstructed=recon)
            self._record(gap, reconstructed=recon)
            st.next_token = tok_out
            st.pos += 1
            if len(st.future.tokens_so_far) >= st.max_new or \
                    st.pos >= self.max_seq - 1:
                self._finish(i, s)

    def _record(self, gap_s, *, reconstructed):
        with self._lock:
            self._gaps_ms.append(1e3 * gap_s)
            key = "parity" if reconstructed else "model"
            self._completed_by[key] = self._completed_by.get(key, 0) + 1
            if reconstructed:
                self._recon_steps += 1
            self._t1 = time.monotonic()

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
