"""One run of one cell: set-up (weights, session, the traffic's warm-up),
the measured window, with ``trace`` a traced span after it, the close, the
peak memory, then the comparison with the reference once the program's
state is freed.  Returns what ``run.py`` prints."""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from portbench.harness import check, spec as S, window as W
from portbench.harness.drive import Load
from portbench.harness.traffic import Generator
from portbench.harness.weights import draw


def arch_config(config):
    """The port's ``ArchConfig`` of a configuration file (its fields; the
    file's other keys describe the source)."""
    from repro_torch.configs.base import ArchConfig
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in config.items() if k in names})


def deploy(cfg, params, traffic, device):
    from repro_torch.serving.api import BatchingPolicy
    from repro_torch.serving.generation import GenerationSpec, deploy_lm
    spec = GenerationSpec(
        cfg=cfg, params=params, k=traffic["k"], r=traffic["r"],
        scheme=traffic["scheme"],
        batching=BatchingPolicy(max_size=traffic["slots_per_member"]),
        max_seq_len=traffic["max_seq_len"],
        max_new_tokens=traffic.get("max_new", 1),
        straggle_ms=traffic["straggle_ms"], device=device)
    return deploy_lm(spec, engine="threads")


@dataclasses.dataclass
class RunResult:
    metrics: dict                 # name -> value, this run's kind
    compared: dict                # name -> (value, limit)
    control: dict
    info: dict                    # counts printed on an earlier line
    device: dict
    breakdown: dict = None


def run(cell, seed, seconds, trace, device, t_start, control=False,
        warm_timeout=600.0):
    cfg_file, traffic = cell.config, cell.traffic
    if traffic["r"] != 1 or traffic["scheme"] != "sum":
        raise ValueError("the comparison knows the sum code with r = 1")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    params = draw(cfg_file, seed, dev)
    session = deploy(arch_config(cfg_file), params, traffic, device)
    load = Load(session, Generator(traffic, seed, cfg_file["vocab"]),
                    traffic, check.columns(traffic, seed))
    load.start()
    load.warm(warm_timeout)
    if cuda:
        torch.cuda.synchronize()
    w0 = time.monotonic()
    setup_s = w0 - t_start
    load.until(lambda: time.monotonic() >= w0 + seconds, seconds + 600)
    w1 = time.monotonic()
    tracer = None
    readers = {m["name"]: S.metric_reader(m["name"]) for m in cell.per_layer}
    if trace:
        from portbench.harness.trace import Tracer
        spans = {}
        for mod in readers.values():
            spans.update(getattr(mod, "SPANS", {}))
        tracer = Tracer(spans)
        with tracer:
            t_end = time.monotonic() + traffic.get("trace_seconds", 5)
            load.until(lambda: time.monotonic() >= t_end, 600)
    load.finish(w1 + (tracer.t_off - w1 if tracer else 0.0))
    reqs = load.requests
    rebuilt = sum(r.future.reconstructed_steps for r in reqs)
    adm, fin = W.events(reqs, w0, w1)
    info = {"window_s": w1 - w0, "window_admissions": adm,
            "window_finishes": fin, "rebuilt_steps": rebuilt,
            "requests": len(reqs)}
    in_window = [r for r in reqs if w0 <= r.t_submit < w1] \
        if traffic["kind"] == "closed_loop" else reqs
    failed = sum(1 for r in in_window if len(r.future._times) < 2)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    metrics, breakdown, data = {}, None, None
    if trace:
        data = tracer.reduce()
        dev_info["busy_s"] = data.busy_s
        dev_info["window_s"] = data.window_s
        breakdown = data.breakdown()
    view = RunView(cell, cfg_file, traffic, reqs, w0, w1, data, setup_s)
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = readers.get(m["name"]) or S.metric_reader(m["name"])
        value = mod.read(view)
        if value is not None:
            metrics[m["name"]] = value
    scheme = session.scheme
    n_slots = traffic["slots_per_member"]
    del session, tracer
    load.session_k = traffic["k"]
    load.session = load.capture.session = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    compared, ctl = check.compare(load, scheme, cfg_file, params, traffic,
                                  seed, n_slots, control=control)
    compared["failed_requests"] = (failed, 0)
    info["setup_s"], info["check_s"] = setup_s, time.monotonic() - t_check
    info["attempted"], info["failed"] = len(in_window), failed
    return RunResult(metrics, compared, ctl, info, dev_info, breakdown)


@dataclasses.dataclass
class RunView:
    """What a per-layer metric reader reads: the cell, the requests and
    the window, and the traced span's ``TraceData``."""
    cell: object
    cfg: dict
    traffic: dict
    requests: list
    w0: float
    w1: float
    trace: object
    setup_s: float = None
