"""Sharded LM serving in the port, on the CPU: ``GenerationSpec`` on a
(2, 2) ("data", "model") mesh over four gloo processes.

One world of four processes is spawned for the module (``world``); each
rank runs every case and writes its results, which the tests below read:

* (i) the kernel route on DTensors: B7 (prefill) and B8 (decode) reached
  through ``models.layers``' ``local_map`` over each rank's batch and KV
  heads, against the same route on plain tensors (both the kernels' plain
  versions here), with scalar and per-row ``pos``: logits and caches within
  ``TOL``, every decode step's key/value row found in the DTensor cache,
  and each op handed local shards of half the batch and half the heads.
  ``generation._write_slot`` into a DTensor pool is checked the same way:
  the slot changed, the others did not (a slice assignment would have run
  on a gathered copy and been lost).
* (ii) ``deploy_lm`` on the mesh serves the tokens of the unsharded port
  and of the JAX package's ``GenerationSession`` on the same numpy
  parameters (reduced qwen2-0.5b, deepseek-moe-16b, mamba2-780m and
  jamba-1.5-large-398b in fp32, perturbed so that no bias is zero and no
  norm scale is one), k=2, r=1, 2 slots, ``max_seq_len`` 16, 4 new tokens;
  the JAX tokens are computed unsharded in this process.
* (iii) member 0 late on every job (``delay_fn``): every rank reports the
  same completion mix, the same reconstructed-step count (> 0) and the same
  tokens, and member 1's streams equal the uncoded greedy loop's.
* (iv) one rank's failure: member 0's first decode job raises on one rank
  (the decider, rank 0, or rank 2), after the job's collectives; every
  rank's ``wait_all`` raises within FAIL_TIMEOUT_S, naming that rank.
* (v) the device thread: in (iii)'s serve each rank records the device
  jobs it ran (``GenerationSession.issued``: instance, kind, round, delay,
  thread); every rank ran the same jobs in the same order, from one
  thread, member 0's decodes held back by the delay and still rebuilt.
* (vi) the mesh's own uncoded greedy loop (``chip_smoke.mesh_greedy``:
  the placed parameters under the serving rules, one thread, each
  member's prompts prefilled into its pool at the serving layout and
  decoded together, as the serve does), which the bf16 serves on four
  cards are held to, gives the unsharded port's loop tokens for every
  plan.
* (vii) a substrate override, the linear stub of
  ``tests/test_torch_lm_serving.py``, served on the mesh, clean and with
  member 0 late: its parameters and pools replicated DTensors, every rank
  the same tokens, those of the unsharded port and of the JAX package's
  ``GenerationSession`` with the reference's stub
  (``tests/test_generation.py``).

Each process group meets at a ``FileStore`` under a temporary directory
(no port: several test workers run at once).  This module imports JAX only
inside the tests that need it: the spawned workers import the module.
"""
import json
import multiprocessing as mp
import os
import sys
import traceback
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 4
TOL = 1e-5
ARCH = "qwen2-0.5b"
# the other plans served on a mesh: MoE, SSM and hybrid (a cross-attending
# plan is refused: tests/test_torch_distributed.py)
PLANS = (ARCH, "deepseek-moe-16b", "mamba2-780m", "jamba-1.5-large-398b")
K, R, SLOTS, SEQ, NEW = 2, 1, 2, 16, 4
# at least 3 tokens each: a mamba layer's conv tail holds the last 3 inputs,
# and a shorter prompt's does not fit the pool (in the reference too)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12], [13, 14, 15]]
# the straggler serve: a deadline well above a clean step on four busy
# CPU processes (0.15 s alone), and member 0 late by more than it on every
# decode step (its admissions' prefills on time)
STRAGGLE_MS, DELAY_S = 2000.0, 2.5
# case (i): a batch of 4 prompts of 8 tokens, then 3 decode steps
BATCH, PROMPT, STEPS = 4, 8, 3
# case (iv): the ranks that fail, and how long every rank may take to stop
FAIL_RANKS, FAIL_TIMEOUT_S = (0, 2), 60.0
# case (vii): the linear stub's vocabulary and width
V, D = 29, 8
ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# the parameters, shared by the reference, the port and the four ranks
# --------------------------------------------------------------------------
def _numpy_params(arch):
    """Reduced ``arch``'s parameters (seed 0) as numpy, each leaf perturbed
    by N(0, 0.05^2) noise (seeded): ARCH's drawn by the JAX package, which
    serves them too, the other plans' by the port."""
    from repro_torch.convert import params_to_numpy, tree_map
    if arch == ARCH:
        import jax
        from repro.configs.base import get_config as jget_config
        from repro.models import transformer as JT
        tree = jax.tree.map(np.asarray, JT.init_params(
            jget_config(arch, reduced=True), jax.random.PRNGKey(0)))
    else:
        from repro_torch.configs.base import get_config
        from repro_torch.models import transformer as T
        tree = params_to_numpy(T.init_params(get_config(arch, reduced=True),
                                             0, device="cpu"))
    rng = np.random.default_rng(11)
    return tree_map(lambda a: (a + 0.05 * rng.standard_normal(
        a.shape)).astype(a.dtype), tree)


# --------------------------------------------------------------------------
# the cases, on every rank
# --------------------------------------------------------------------------
def _full(x):
    from torch.distributed.tensor import DTensor
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().float()


def _dims(t):
    """The tensor dim each mesh dim shards ``t`` along (None: replicated)."""
    return [p.dim if p.is_shard() else None for p in t.placements]


def _positions(step, vector):
    """Step ``step``'s position: one int, or per-row positions that differ
    between rows (odd rows one ahead, so their slots differ too)."""
    if not vector:
        return PROMPT + step
    return torch.tensor([PROMPT + step + b % 2 for b in range(BATCH)])


@contextmanager
def _recording_ops():
    """B7's and B8's ops wrapped to record the query shapes they are
    handed (a dict of sets, by op)."""
    from repro_torch.kernels import ops
    seen = {"flash_attention_op": set(), "decode_attention_op": set()}
    originals = {name: getattr(ops, name) for name in seen}
    for name, op in originals.items():
        def wrapped(q, *args, op=op, name=name, **kw):
            seen[name].add(tuple(q.shape))
            return op(q, *args, **kw)
        setattr(ops, name, wrapped)
    try:
        yield seen
    finally:
        for name, op in originals.items():
            setattr(ops, name, op)


def _kernel_route(mesh, tree):
    """Case (i): prefill and STEPS decode steps on the kernel route,
    unsharded and on ``mesh`` (parameters at the inference layout, tokens
    by batch, the cache redistributed to the serving pool's layout), fed
    the same tokens; then ``generation._write_slot`` into a DTensor pool."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy, tree_leaves
    from repro_torch.distributed import logical
    from repro_torch.distributed.sharding import ShardingRules, _zip_map
    from repro_torch.models import transformer as T
    from repro_torch.serving import generation as G

    cfg = get_config(ARCH, reduced=True)
    assert cfg.attn_backend == "kernels"
    params = params_from_numpy(tree, "cpu")
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (BATCH, PROMPT)), dtype=torch.int32)
    rules = ShardingRules(mesh, fsdp_params=False)
    sparams = G.place_inference_params(params, mesh)
    stoks = rules.distribute(toks, rules.batch_specs({"t": toks})["t"])
    out = {}
    for vector in (False, True):
        tag = "vector" if vector else "scalar"
        with torch.no_grad():
            logits, cache = T.prefill(cfg, params, tokens=toks,
                                      cache_len=SEQ)
            want, feed = [logits], []
            for i in range(STEPS):
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                feed.append(tok)
                logits, cache = T.decode_step(cfg, params, cache,
                                              _positions(i, vector),
                                              token=tok)
                want.append(logits)
        with _recording_ops() as seen, \
                logical.logical_rules(*G.serving_rules(mesh)), \
                logical.implicit_replication(), torch.no_grad():
            logits, scache = T.prefill(cfg, sparams, tokens=stoks,
                                       cache_len=SEQ)
            got = [logits]
            scache = _zip_map(logical.constrain_spec, scache,
                              rules.cache_specs(scache, whole_seq=True))
            for i, tok in enumerate(feed):
                logits, scache = T.decode_step(
                    cfg, sparams, scache, _positions(i, vector),
                    token=rules.distribute(tok, rules.batch_specs(
                        {"t": tok})["t"]))
                got.append(logits)
        out[f"{tag}_logits_err"] = max(
            float((_full(a) - b).abs().max()) for a, b in zip(got, want))
        caches = list(zip(tree_leaves(scache), tree_leaves(cache)))
        out[f"{tag}_cache_err"] = max(
            float((_full(a) - b).abs().max()) for a, b in caches)
        out[f"{tag}_cache_zeros_agree"] = all(
            torch.equal(_full(a) == 0, b == 0) for a, b in caches)
        # every decode step's row, at its slot, in every layer's K and V
        rows = [(b, int(_positions(i, vector)[b]) if vector
                 else _positions(i, vector))
                for i in range(STEPS) for b in range(BATCH)]
        out[f"{tag}_rows_written"] = all(
            bool((_full(a)[:, b, slot] != 0).any())
            for a, _ in caches for b, slot in rows)
        out[f"{tag}_placements"] = _dims(tree_leaves(scache)[0])
        out[f"{tag}_seen"] = {k: sorted(v) for k, v in seen.items()}

    # the session's slot write of a sharded prefill into a DTensor pool
    with torch.no_grad():
        _, one = T.prefill(cfg, params, tokens=toks[:1], cache_len=SEQ)
        with logical.logical_rules(*G.serving_rules(mesh)), \
                logical.implicit_replication():
            _, sone = T.prefill(cfg, sparams, tokens=toks[:1], cache_len=SEQ)
    pool = G.place_cache_pool(T.init_cache(cfg, SLOTS, SEQ, device="cpu"),
                              mesh)
    before = [_full(x).clone() for x in tree_leaves(pool)]
    G._write_slot(pool, sone, 1)
    after = [_full(x) for x in tree_leaves(pool)]
    out["pool_placements"] = _dims(tree_leaves(pool)[0])
    out["pool_slot_err"] = max(float((a[:, 1:2] - b).abs().max()) for a, b
                               in zip(after, tree_leaves(one)))
    out["pool_slot_changed"] = all(bool((a[:, 1] != b[:, 1]).any())
                                   for a, b in zip(after, before))
    out["pool_others_kept"] = all(torch.equal(a[:, 0], b[:, 0])
                                  for a, b in zip(after, before))
    return out


def _spec(mesh, arch, tree, straggle_ms=60_000.0, delay_fn=None):
    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.api import BatchingPolicy
    from repro_torch.serving.generation import GenerationSpec
    return GenerationSpec(
        cfg=get_config(arch, reduced=True),
        params=params_from_numpy(tree, "cpu"), k=K, r=R,
        batching=BatchingPolicy(max_size=SLOTS), max_seq_len=SEQ,
        max_new_tokens=NEW, mesh=mesh, device="cpu",
        straggle_ms=straggle_ms, delay_fn=delay_fn)


def _serve(mesh, arch, tree, delay_s=0.0, issued=None):
    """Cases (ii) and (iii): ``deploy_lm`` of reduced ``arch`` on ``mesh``,
    every rank submitting PROMPTS in order; member 0 ``delay_s`` late on
    every job.  ``issued``, a list, receives the session's record of the
    device jobs it ran (case (v))."""
    from repro_torch.serving.api import deploy_lm
    from repro_torch.serving.scenarios import instance_id
    slow, calls = instance_id("main", 0), []

    def delay(iid):
        # every rank's member 0 runs the same jobs in the same order: the
        # first SLOTS are its admissions' prefills
        if iid != slow:
            return 0.0
        calls.append(iid)
        return delay_s if len(calls) > SLOTS else 0.0
    spec = _spec(mesh, arch, tree,
                 STRAGGLE_MS if delay_s else 60_000.0, delay)
    with deploy_lm(spec) as sess:
        futs = [sess.submit(p) for p in PROMPTS]
        assert sess.wait_all(timeout=120.0)
        stats = sess.stats()
    if issued is not None:
        issued.extend(sess.issued)
    return {"tokens": [f.result() for f in futs],
            "rebuilt_by_rid": [f.reconstructed_steps for f in futs],
            "completed_by": stats.completed_by, "n": stats.n,
            "reconstructed_steps": stats.reconstructed_steps,
            "inter_token_ms": [f.inter_token_ms for f in futs]}


def _failing_serve(mesh, tree, fail_rank):
    """Case (iv): ``_serve``'s clean serve of ARCH, where rank
    ``fail_rank``'s member 0 raises in its first decode job once the job
    has gathered its logits (so the other ranks' jobs end): whether and
    how every rank's ``wait_all`` raises, and how soon."""
    import time
    import torch.distributed as dist
    from repro_torch.serving import generation as G
    from repro_torch.serving.api import deploy_lm
    real, served = G.to_host, []

    def planted(x):
        # the running job is the session's last record (made before it runs)
        y = real(x)
        if dist.get_rank() == fail_rank and y.ndim == 3 and served and \
                served[0].issued[-1][0] == "lm-member-0":
            raise RuntimeError("planted decode failure")
        return y
    G.to_host = planted
    try:
        with deploy_lm(_spec(mesh, ARCH, tree)) as sess:
            served.append(sess)
            for p in PROMPTS:
                sess.submit(p)
            t0, error = time.monotonic(), None
            try:
                sess.wait_all(timeout=FAIL_TIMEOUT_S)
            except RuntimeError as e:
                error = str(e)
            seconds = time.monotonic() - t0
    finally:
        G.to_host = real
    return {"error": error, "seconds": seconds}


def _chip_smoke():
    """``chip_smoke.py`` (its helpers) on the CPU."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.DEV = "cpu"
    return chip_smoke


def _loops(arch, tree, mesh=None):
    """Case (vi): the uncoded greedy loop's tokens for PROMPTS over reduced
    ``arch``, on ``mesh`` (its own loop) or unsharded."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.generation import place_inference_params
    cs = _chip_smoke()
    cfg = get_config(arch, reduced=True)
    params = params_from_numpy(tree, "cpu")
    if mesh is None:
        return [cs.lm_greedy(cfg, params, p, seq=SEQ, new=NEW)[0]
                for p in PROMPTS]
    return [loop[0] for loop in cs.mesh_greedy(
        cfg, place_inference_params(params, mesh), mesh, PROMPTS,
        slots=SLOTS, seq=SEQ, new=NEW)]


def _linear_substrate(seed=0):
    """``tests/test_torch_lm_serving.py``'s exactness stub (a running sum
    of token embeddings, logits linear in it), written here so that the
    spawned ranks import no JAX."""
    rng = np.random.default_rng(seed)
    emb = torch.tensor(rng.normal(size=(V, D)).astype(np.float32))
    W = torch.tensor(rng.normal(size=(D, V)).astype(np.float32))

    def embed_fn(p, tokens):
        return p["embed"][torch.as_tensor(tokens).long()]

    def prefill_fn(p, tokens=None, embeds=None, cache_len=0):
        e = embeds if embeds is not None else embed_fn(p, tokens)
        state = e.sum(dim=1)                             # [B, D]
        return (state @ p["W"])[:, None], {"state": state[None]}

    def decode_fn(p, cache, pos, token=None, embed=None):
        e = embed if embed is not None else embed_fn(p, token)   # [B, 1, D]
        state = cache["state"] + e[None, :, 0]           # [1, B, D]
        return (state[0] @ p["W"])[:, None], {"state": state}

    def init_cache_fn(p, batch, cache_len):
        return {"state": torch.zeros((1, batch, D))}

    return {"embed": emb, "W": W}, dict(
        prefill_fn=prefill_fn, decode_fn=decode_fn, embed_fn=embed_fn,
        init_cache_fn=init_cache_fn)


def _stub_serve(mesh=None, delay_s=0.0):
    """Case (vii): the linear stub served on ``mesh`` (None: unsharded),
    every rank submitting PROMPTS; member 0 ``delay_s`` late on every
    decode job."""
    from repro_torch.serving.api import BatchingPolicy, deploy_lm
    from repro_torch.serving.generation import GenerationSpec
    from repro_torch.serving.scenarios import instance_id
    slow, calls = instance_id("main", 0), []

    def delay(iid):
        if iid != slow:
            return 0.0
        calls.append(iid)
        return delay_s if len(calls) > SLOTS else 0.0
    params, fns = _linear_substrate()
    spec = GenerationSpec(
        params=params, k=K, r=R, batching=BatchingPolicy(max_size=SLOTS),
        max_seq_len=SEQ, max_new_tokens=NEW, mesh=mesh, device="cpu",
        straggle_ms=STRAGGLE_MS if delay_s else 60_000.0, delay_fn=delay,
        **fns)
    with deploy_lm(spec) as sess:
        futs = [sess.submit(p) for p in PROMPTS]
        assert sess.wait_all(timeout=120.0)
        stats = sess.stats()
        replicated = {name: [p.is_replicate() for p in
                             getattr(x, "placements", ())]
                      for name, x in [*sess.params.items(),
                                      *sess._members[0].pool.items()]}
    return {"tokens": [f.result() for f in futs],
            "completed_by": stats.completed_by,
            "reconstructed_steps": stats.reconstructed_steps,
            "replicated": replicated,
            "threads": len({job[4] for job in sess.issued})}


def _worker(rank, root, trees):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(root, "store"), WORLD), rank=rank,
            world_size=WORLD)
        try:
            mesh = make_test_mesh((2, 2))
            issued = []
            out = {"kernel_route": _kernel_route(mesh, trees[ARCH]),
                   "straggler": _serve(mesh, ARCH, trees[ARCH], DELAY_S,
                                       issued),
                   "issued": issued,
                   **{arch: _serve(mesh, arch, trees[arch])
                      for arch in PLANS},
                   "mesh_loops": {arch: _loops(arch, trees[arch], mesh)
                                  for arch in PLANS},
                   "stub": {"clean": _stub_serve(mesh),
                            "late": _stub_serve(mesh, DELAY_S)},
                   "failures": {str(r): _failing_serve(mesh, trees[ARCH], r)
                                for r in FAIL_RANKS}}
        finally:
            dist.destroy_process_group()
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(root, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def numpy_params():
    return {arch: _numpy_params(arch) for arch in PLANS}


@pytest.fixture(scope="module")
def spawned(numpy_params, tmp_path_factory):
    """The world of the cases above, started: (its processes, its
    directory)."""
    root = tmp_path_factory.mktemp("sharded_serving")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(root), numpy_params))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    yield procs, root
    for p in procs:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def reference(spawned, numpy_params):
    """The JAX package's ``GenerationSession`` tokens for PROMPTS, by plan,
    unsharded, and with the reference's linear stub (``"stub"``); served
    while the world runs."""
    import jax.numpy as jnp
    import jax
    from repro.configs.base import get_config as jget_config
    from repro.serving import api as japi
    from repro.serving import generation as jgen
    from test_generation import _linear_substrate as jax_stub
    specs = {arch: dict(cfg=jget_config(arch, reduced=True),
                        params=jax.tree.map(jnp.asarray, numpy_params[arch]))
             for arch in PLANS}
    params, fns = jax_stub()
    specs["stub"] = dict(params=params, **fns)
    tokens = {}
    for name, kw in specs.items():
        spec = jgen.GenerationSpec(
            k=K, r=R, scheme="sum",
            batching=japi.BatchingPolicy(max_size=SLOTS), max_seq_len=SEQ,
            max_new_tokens=NEW, straggle_ms=60_000.0, **kw)
        with japi.deploy_lm(spec, engine="threads") as sess:
            futs = [sess.submit(p) for p in PROMPTS]
            assert sess.wait_all(120.0)
            tokens[name] = [f.result(1.0) for f in futs]
    return tokens


@pytest.fixture(scope="module")
def world(spawned, reference):
    """Every rank's results of the cases above (after ``reference``, so
    that the JAX serves overlap the world's)."""
    procs, root = spawned
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    msgs = [(root / f"error{r}.txt").read_text() for r in range(WORLD)
            if (root / f"error{r}.txt").exists()]
    assert not msgs and all(p.exitcode == 0 for p in procs), \
        "\n".join(msgs) or [p.exitcode for p in procs]
    return [json.loads((root / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _unsharded_serve(arch, tree):
    """The port's tokens for PROMPTS without a mesh."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.api import BatchingPolicy, deploy_lm
    from repro_torch.serving.generation import GenerationSpec
    spec = GenerationSpec(cfg=get_config(arch, reduced=True),
                          params=params_from_numpy(tree, "cpu"), k=K, r=R,
                          batching=BatchingPolicy(max_size=SLOTS),
                          max_seq_len=SEQ, max_new_tokens=NEW,
                          straggle_ms=60_000.0, device="cpu")
    with deploy_lm(spec) as sess:
        futs = [sess.submit(p) for p in PROMPTS]
        assert sess.wait_all(timeout=120.0)
        return [f.result() for f in futs]


@pytest.fixture(scope="module")
def loops(numpy_params):
    """The port's uncoded greedy loop over reduced ARCH, per prompt."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import transformer as T
    cfg = get_config(ARCH, reduced=True)
    params = params_from_numpy(numpy_params[ARCH], "cpu")
    loops = []
    with torch.inference_mode():
        for p in PROMPTS:
            logits, cache = T.prefill(cfg, params, tokens=torch.tensor([p]),
                                      cache_len=SEQ)
            loop = [int(torch.argmax(logits[0, -1]))]
            for pos in range(len(p), len(p) + NEW - 1):
                logits, cache = T.decode_step(
                    cfg, params, cache, pos, token=torch.tensor([[loop[-1]]]))
                loop.append(int(torch.argmax(logits[0, 0])))
            loops.append(loop)
    return loops


# --------------------------------------------------------------------------
# (i) the kernel route on DTensors
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pos", ["scalar", "vector"])
def test_kernel_route_on_dtensors_equals_the_plain_route(world, pos):
    for rank in world:
        out = rank["kernel_route"]
        assert out[f"{pos}_logits_err"] <= TOL
        assert out[f"{pos}_cache_err"] <= TOL
        assert out[f"{pos}_cache_zeros_agree"]
        assert out[f"{pos}_rows_written"]
        # K/V [G, B, S, KV, hd]: batch over data, KV heads over model
        assert out[f"{pos}_placements"] == [1, 3]


@pytest.mark.parametrize("pos", ["scalar", "vector"])
def test_kernels_see_each_ranks_local_shard(world, pos):
    """B7 and B8 get plain local shards: half of the batch of 4 (data 2)
    and half of the 4 query heads over 2 KV heads (model 2)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(ARCH, reduced=True)
    hd = cfg.resolved_head_dim
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)
    for rank in world:
        seen = rank["kernel_route"][f"{pos}_seen"]
        assert seen["flash_attention_op"] == [[2, PROMPT, 2, hd]]
        assert seen["decode_attention_op"] == [[2, 2, hd]]


def test_slot_write_into_a_dtensor_pool_lands(world):
    for rank in world:
        out = rank["kernel_route"]
        assert out["pool_placements"] == [1, 3]
        assert out["pool_slot_err"] <= TOL
        assert out["pool_slot_changed"] and out["pool_others_kept"]


# --------------------------------------------------------------------------
# (ii) the sharded deploy_lm against the unsharded port and the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PLANS)
def test_sharded_deploy_lm_serves_the_unsharded_ports_tokens(
        world, numpy_params, arch):
    want = _unsharded_serve(arch, numpy_params[arch])
    for rank in world:
        clean = rank[arch]
        assert clean["tokens"] == want
        assert clean["n"] == len(PROMPTS) * NEW
        assert clean["reconstructed_steps"] == 0
        assert clean["completed_by"] == {"model": len(PROMPTS) * NEW}


@pytest.mark.parametrize("arch", PLANS)
def test_sharded_deploy_lm_serves_the_reference_tokens(
        world, reference, arch):
    for rank in world:
        assert rank[arch]["tokens"] == reference[arch]


# --------------------------------------------------------------------------
# (iii) member 0 late
# --------------------------------------------------------------------------
def test_straggler_serve_agrees_on_every_rank(world, loops):
    first = world[0]["straggler"]
    assert first["reconstructed_steps"] > 0
    assert first["completed_by"]["parity"] == first["reconstructed_steps"]
    for rank in world[1:]:
        # the same completion mix, steps, tokens and inter-token gaps
        assert rank["straggler"] == first
    # slots fill member 0 first: rids 0-1 on member 0, 2-3 on member 1
    assert all(n > 0 for n in first["rebuilt_by_rid"][:SLOTS])
    assert not any(first["rebuilt_by_rid"][SLOTS:])
    for rid in range(SLOTS, len(PROMPTS)):
        assert first["tokens"][rid] == loops[rid]


# --------------------------------------------------------------------------
# (iv) one rank's failure
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fail_rank", FAIL_RANKS)
def test_one_ranks_failure_stops_every_rank(world, fail_rank):
    for rank in world:
        out = rank["failures"][str(fail_rank)]
        assert out["error"] is not None, out
        assert f"rank {fail_rank}: RuntimeError: planted decode failure" \
            in out["error"]
        assert out["seconds"] < FAIL_TIMEOUT_S


# --------------------------------------------------------------------------
# (v) one device thread per rank, one order on every rank
# --------------------------------------------------------------------------
def test_every_rank_runs_the_same_jobs_in_order_on_one_thread(world):
    """With member 0 late: each rank's device jobs (instance, kind, round,
    delay) are the same sequence, all from one thread; within a round,
    admissions' prefills, then parity rebuilds, then members 0..K-1, then
    the parities; member 0's decodes ran in every decode round, held back
    by DELAY_S, and were rebuilt."""
    seqs = [[tuple(job[:4]) for job in rank["issued"]] for rank in world]
    for rank in world:
        assert len({job[4] for job in rank["issued"]}) == 1
    assert all(seq == seqs[0] for seq in seqs[1:])
    seq = seqs[0]
    names = [f"lm-member-{i}" for i in range(K)] + \
        [f"lm-parity-{j}" for j in range(R)]
    assert seq[:K + R] == [(n, "warm", 0, 0.0) for n in names]
    order = {"prefill": 0, "rebuild": 1, "decode": 2}
    rounds = sorted({job[2] for job in seq[K + R:]})
    decodes = 0
    for rnd in rounds:
        jobs = [job for job in seq if job[2] == rnd]
        assert jobs == sorted(jobs, key=lambda j: order[j[1]])
        dec = [j for j in jobs if j[1] == "decode"]
        if dec:
            decodes += 1
            assert [j[0] for j in dec] == names
            assert dec[0][3] == DELAY_S
            assert all(j[3] == 0.0 for j in dec[1:])
    # every decode round of member 0's streams ran its late job
    assert decodes >= NEW - 1
    assert world[0]["straggler"]["reconstructed_steps"] >= decodes


# --------------------------------------------------------------------------
# (vi) the mesh's own loop
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PLANS)
def test_mesh_loop_equals_the_unsharded_loop(world, numpy_params, arch):
    want = _loops(arch, numpy_params[arch])
    assert all(len(t) == NEW for t in want)
    for rank in world:
        assert rank["mesh_loops"][arch] == want


# --------------------------------------------------------------------------
# (vii) a substrate override on the mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("run", ["clean", "late"])
def test_substrate_override_on_a_mesh_serves_the_unsharded_tokens(world,
                                                                  run):
    """Every rank the same tokens, completion mix and rebuilt steps, the
    unsharded port's tokens; with member 0 late its steps are rebuilt, and
    exactly (logits linear in the embeddings)."""
    want = _stub_serve()["tokens"]
    first = world[0]["stub"][run]
    assert first["tokens"] == want
    assert sum(first["completed_by"].values()) == len(PROMPTS) * NEW
    assert (first["reconstructed_steps"] > 0) == (run == "late")
    assert first["completed_by"].get("parity", 0) == \
        first["reconstructed_steps"]
    for rank in world[1:]:
        assert rank["stub"][run] == first


@pytest.mark.parametrize("run", ["clean", "late"])
def test_substrate_override_on_a_mesh_serves_the_reference_tokens(
        world, reference, run):
    for rank in world:
        assert rank["stub"][run]["tokens"] == reference["stub"]


def test_substrate_override_on_a_mesh_is_replicated(world):
    """The stub's parameters (its ``embed`` of 29 rows divides no axis, and
    ``W`` is a name the rules do not know) and its pool are DTensors
    replicated on both mesh axes; one device thread ran its jobs."""
    for rank in world:
        for run in ("clean", "late"):
            out = rank["stub"][run]
            assert out["replicated"] == {
                name: [True, True] for name in ("embed", "W", "state")}
            assert out["threads"] == 1
