"""Multi-pod dry run: run every (architecture x input-shape x mesh) step
once, shard by shard on the host, and extract memory / cost / collective
evidence — the JAX package's ``launch/dryrun.py`` on DTensor.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k [--multi-pod] [--mesh test]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The dry run is host-only by design, as the reference's placeholder devices
are, and the one entry point of the port that does not run on the card:
its point is to allocate nothing.  Parameters, optimizer state, inputs and
caches are ``meta`` tensors placed as DTensors by ``ShardingRules`` on a
mesh of the reference's shape over a fake process group
(``launch.mesh.fake_world``: collectives move nothing).  One step runs
under the launcher's logical rules inside a ``roofline.Trace`` (the local
ops' FLOPs and bytes and the collectives' bytes, per device) and PyTorch's
``MemTracker``.  Attention takes the block-scan path (``attn_backend=
"torch"``): the kernels take no DTensor.

Memory, per device: ``argument_bytes`` and ``output_bytes`` are summed over
the local shards of the step's inputs and outputs; ``alias_bytes`` are the
outputs written over donated inputs (the parameters and optimizer state of
a train step, the cache of a decode step), as the reference donates them;
``temp_bytes`` is ``MemTracker``'s peak of what the step allocated, an eager
upper bound (no fusion, no buffer reuse beyond the caching allocator's).
The roofline counts every layer and key block of the step (no loop is
traced once), so ``roofline_scan_corrected`` equals ``roofline``'s terms and
``useful_flops_ratio`` divides the model FLOPs by the traced FLOPs of all
devices; ``scan_trips`` keeps the reference's count of layer-stack trips.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.convert import tree_leaves
from repro_torch.distributed.logical import logical_rules, rules_for_mesh
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     make_test_mesh)
from repro_torch.launch.roofline import (Trace, active_param_count, analyze,
                                         model_flops)
from repro_torch.training.optim import adam_init

MESHES = {"pod": (16, 16), "multipod": (2, 16, 16), "pod_serve8": (32, 8),
          "test": (2, 2)}


def _mesh_for(name):
    if name == "pod":
        return make_production_mesh(multi_pod=False)
    if name == "multipod":
        return make_production_mesh(multi_pod=True)
    if name == "pod_serve8":
        # serving mesh with tp aligned to GQA kv-head counts: the same 256
        # devices, (data=32, model=8)
        return make_test_mesh((32, 8), ("data", "model"))
    if name == "test":
        return make_test_mesh((2, 2), ("data", "model"))
    raise ValueError(name)


def adapt_config(arch, shape_name):
    """Per-shape config adjustments, recorded in the output notes."""
    cfg = get_config(arch).replace(attn_backend="torch")
    notes = ["attn_backend=torch (the kernels take no DTensor)"]
    if shape_name == "long_500k" and not cfg.subquadratic:
        # pure full-attention archs run long-context decode with the
        # sliding-window variant
        cfg = cfg.replace(sliding_window=8192)
        notes.append("sliding_window=8192 for long_500k")
    return cfg, notes


def local_bytes(tree):
    """Bytes of the local shards of a tree's tensor leaves."""
    from torch.distributed.tensor import DTensor
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.dtype.itemsize
    return total


def run_pair(arch, shape_name, mesh_name="pod", verbose=True, microbatch=0):
    t0 = time.time()
    cfg, notes = adapt_config(arch, shape_name)
    sh = SHAPES[shape_name]
    chips = math.prod(MESHES[mesh_name])
    with fake_world(chips):
        mesh = _mesh_for(mesh_name)
        pshapes = ST.param_shapes(cfg)
        n_params = ST.n_params_of(pshapes)
        # inference layout: replicate weights over 'data' (no per-layer
        # FSDP gathers) whenever tp-sharded bf16 params fit comfortably
        tp_size = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
        fsdp_params = not (sh.kind != "train"
                           and n_params * 2 / tp_size < 8e9)
        if not fsdp_params:
            notes.append("inference layout: params replicated over data "
                         "axis")
        rules = ShardingRules(mesh, fsdp_params=fsdp_params)
        pspecs = rules.params(pshapes)
        params = rules.distribute(pshapes, pspecs)
        batch = ST.input_specs(cfg, shape_name)
        batch = rules.distribute(batch, rules.batch_specs(batch))

        lrules, lsizes = rules_for_mesh(mesh)
        lrules["fsdp_params"] = fsdp_params
        args, alias = [params, batch], 0
        if sh.kind == "train":
            opt_cfg = ST.pick_opt_config(cfg, n_params)
            opt = rules.distribute(adam_init(pshapes, opt_cfg),
                                   rules.opt_state(None, pspecs))
            args.insert(1, opt)
            fn = ST.make_train_step(cfg, opt_cfg,
                                    batch_axes=rules.batch_axes,
                                    microbatch=microbatch)
            alias = local_bytes((params, opt))
        elif sh.kind == "prefill":
            fn = ST.make_prefill_step(cfg)
        else:  # decode
            cshapes = ST.cache_shapes(cfg, shape_name)
            cache = rules.distribute(cshapes, rules.cache_specs(cshapes))
            args.insert(1, cache)
            fn = ST.make_decode_step(cfg, sh.seq_len - 1)
            alias = local_bytes(cache)
        arg_bytes = local_bytes(args)

        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.distributed.tensor.experimental import implicit_replication
        tracker = MemTracker()
        grad = torch.enable_grad() if sh.kind == "train" else torch.no_grad()
        with logical_rules(lrules, lsizes, mesh), implicit_replication(), \
                grad, tracker, Trace() as trace:
            out = fn(*args)
        out_bytes = local_bytes(out)
        temp = int(tracker.get_tracker_snapshot("peak").get(
            torch.device("meta"), {}).get("Total", 0))

    roof = analyze(trace, chips)
    scan_trips = cfg.n_groups
    if cfg.enc_dec:
        scan_trips += cfg.n_enc_layers // cfg.period
    scan_trips *= max(1, microbatch)
    n_active = active_param_count(cfg, n_params)
    n_tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    mf = model_flops(cfg, n_tokens, active_params=n_active)
    if sh.kind == "train":
        mf *= 3.0                      # fwd + bwd
    flops_total = roof.flops_per_device * chips

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "kind": sh.kind, "n_params": n_params, "n_active_params": n_active,
        "notes": notes,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_live_bytes": arg_bytes + out_bytes + temp - alias,
        },
        "roofline": roof.as_dict(),
        "scan_trips": scan_trips,
        "roofline_scan_corrected": {
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
        },
        "microbatch": microbatch,
        "model_flops": mf,
        "useful_flops_ratio": mf / flops_total if flops_total else None,
        "traced_ops_per_device": trace.ops,
        "torch": torch.__version__,
        "compile_s": time.time() - t0,
    }
    if verbose:
        r = roof
        print(f"{arch:24s} {shape_name:12s} {mesh_name:8s} "
              f"compute={r.compute_s*1e3:9.3f}ms "
              f"memory={r.memory_s*1e3:9.3f}ms "
              f"coll={r.collective_s*1e3:9.3f}ms dom={r.dominant:10s} "
              f"temp/chip={temp/2**30:6.2f}GiB "
              f"({result['compile_s']:.0f}s)", flush=True)
    return result


def save(result, out_dir="experiments/dryrun_torch"):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "{arch}__{shape}__{mesh}.json".format(
        **result))
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=list(MESHES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatch", type=int, default=0)
    args = ap.parse_args(argv)
    mesh_name = "multipod" if args.multi_pod else args.mesh

    pairs = ([(a, s) for a in ARCH_IDS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    failures = []
    for arch, shape in pairs:
        try:
            res = run_pair(arch, shape, mesh_name,
                           microbatch=args.microbatch)
            save(res, args.out)
        except Exception as e:    # one pair's failure must not stop --all
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("dry-run OK")


if __name__ == "__main__":
    main()
