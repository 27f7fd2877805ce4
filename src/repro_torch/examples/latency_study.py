"""Tail-latency study (paper Fig 11) via the sim engine of the port's
declarative serving API (twin of ``examples/latency_study.py``).

    PYTHONPATH=src python -m repro_torch.examples.latency_study [--qps 270] \
        [--m 12] [--r 2] [--scheme learned] [--scenario crash] \
        [--batch-size 4] [--device cpu]

One ``DeploymentSpec`` per strategy, one shared workload ``Trace``:
``deploy(spec, engine="sim").replay(trace)`` — the exact spec a threaded
deployment would consume.  ``--scenario`` picks a registered fault scenario
(``crash``, ``bursty``, ``storm``, ...); omitted, the paper's background
network-shuffle load runs.  ``--scheme`` / ``--r`` select the code served by
the coded strategies — any registered name, including ``learned`` and
``approx_backup``.  ``--batch-size`` sweeps the adaptive ``BatchingPolicy``
through the DES's per-batch service-time curve.  ``--controller`` closes the
loop: a registered adaptive-redundancy controller retunes scheme, r, and
batching from live ``ReportWindow`` signals — pair it with an episodic
``--scenario`` such as ``bursty`` to watch the escalation/settle cycle in
the adjustment log.  The DES is seeded and runs on the host: its table is
the reference's, number for number.  ``--device`` is where the specs
resolve their schemes.
"""
from __future__ import annotations

import argparse

from repro_torch.convert import resolve_device
from repro_torch.core.scheme import available_schemes
from repro_torch.serving.api import BatchingPolicy, DeploymentSpec, Trace, \
    deploy
from repro_torch.serving.controller import available_controllers
from repro_torch.serving.scenarios import available_scenarios

STRATEGIES = ("none", "equal_resources", "parm", "approx_backup",
              "replication")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qps", type=float, default=270)
    ap.add_argument("--m", type=int, default=12)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--r", type=int, default=1,
                    help="parity models per coding group (paper §3.5)")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--scheme", default=None, choices=available_schemes(),
                    help="coding scheme for coded strategies (e.g. sum | "
                         "learned | replication; default: strategy's own)")
    ap.add_argument("--scenario", default=None,
                    choices=available_scenarios(),
                    help="fault scenario (default: legacy shuffle load)")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="adaptive-batching max batch size (main pool)")
    ap.add_argument("--controller", default=None,
                    choices=available_controllers(),
                    help="closed-loop adaptive-redundancy controller "
                         "(coded strategies retune scheme/r/batching from "
                         "live ReportWindow signals)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny workload for CI subprocess dryruns: exercise "
                         "the full strategy sweep in seconds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        args.n = min(args.n, 4000)

    trace = Trace(n_queries=args.n, qps=args.qps)
    load = args.scenario or "background network shuffles"
    ctl = f", controller: {args.controller}" if args.controller else ""
    print(f"m={args.m} deployed instances, k={args.k} "
          f"({1/args.k:.0%} redundancy), r={args.r}, {args.qps} qps, "
          f"{args.n} queries, load: {load}, "
          f"batching max_size={args.batch_size}{ctl}\n")
    print(f"{'strategy':18s} {'scheme':12s} {'median':>8s} {'p99':>8s} "
          f"{'p99.9':>8s} {'gap':>8s} {'recon':>7s} {'cancel':>7s}")
    rows = {}
    for strat in STRATEGIES:
        spec = DeploymentSpec(
            strategy=strat, scheme=args.scheme, k=args.k, r=args.r,
            m=args.m, scenario=args.scenario, device=str(dev),
            batching=BatchingPolicy(max_size=args.batch_size),
            controller=args.controller)
        r = deploy(spec, engine="sim").replay(trace)
        gap = r["p999_ms"] - r["median_ms"]
        rows[strat] = {"scheme": str(r["scheme"]),
                       "median_ms": r["median_ms"], "p99_ms": r["p99_ms"],
                       "p999_ms": r["p999_ms"], "gap_ms": gap,
                       "reconstructions": r["reconstructions"],
                       "cancellations": r.cancellations,
                       "adjustments": list(r.adjustments or ())}
        print(f"{strat:18s} {str(r['scheme']):12s} "
              f"{r['median_ms']:7.1f}ms {r['p99_ms']:7.1f}ms "
              f"{r['p999_ms']:7.1f}ms {gap:7.1f}ms "
              f"{r['reconstructions']:7d} {r.cancellations:7d}")
        if args.controller and r.adjustments:
            log = " ".join(
                f"w{w}->({s},r={rr},b={b})" for w, s, rr, b in r.adjustments)
            print(f"{'':18s} adjustments: {log} "
                  f"(parity_served={r.parity_served})")
    return rows


if __name__ == "__main__":
    main()
