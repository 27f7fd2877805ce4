"""``BENCHMARK.json`` and the files it names: a cell (workload) is found by
name, its configuration and traffic mix by theirs, and each per-layer
metric by its name under ``metrics/``.  Nothing here imports the program."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]       # the checkout
BENCH = Path(__file__).resolve().parents[1]      # portbench/
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def valid_name(s):
    return isinstance(s, str) and bool(NAME_RE.match(s))


def valid_unit(s):
    return isinstance(s, str) and bool(UNIT_RE.match(s))


def valid_line(s, limit=200):
    """A ``why``, ``layer`` or ``source``: 1 to ``limit`` characters on one
    line, without a tab."""
    return isinstance(s, str) and 1 <= len(s) <= limit and not any(
        c in s for c in "\n\r\t")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names, loaded."""
    name: str
    chips: int
    config: dict                  # the configuration file, as run
    traffic: dict                 # the traffic mix's parameters
    end_to_end: list              # the metric entries this cell reports
    per_layer: list
    run_seconds: int


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name``, its configuration and traffic files and the
    metrics it reports; raises ``KeyError`` for a name the file lacks."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(Path(root) / conf["file"]) as f:
        config = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_traffic(w["traffic"], root),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        run_seconds=int(bench["run_seconds"]))


def load_traffic(name, root=ROOT):
    """A traffic mix: ``traffic/<name>.json``, the parameters that the one
    generator (``harness/traffic.py``) reads."""
    path = Path(root) / "portbench" / "traffic" / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def metric_reader(name, root=ROOT):
    """The module ``metrics/<name>.py`` of an end-to-end or per-layer
    metric: its ``read(run)`` returns the metric's value, or None where the
    run holds nothing to read; its optional ``SPANS`` name program
    functions to annotate in a traced run."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(bench, root=ROOT):
    """What in ``bench`` breaks the name, unit and file rules (an empty
    list where nothing does)."""
    out = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e.get("name") for e in bench.get(key, [])]
        for n in names:
            if not valid_name(n):
                out.append(f"{key}: bad name {n!r}")
        if len(set(names)) != len(names):
            out.append(f"{key}: a name repeats")
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    if len(set(metric_names)) != len(metric_names):
        out.append("a metric name repeats across end_to_end and per_layer")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not valid_unit(m.get("unit")):
            out.append(f"{m['name']}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"{m['name']}: better must be lower or higher")
    for m in bench["per_layer"]:
        if not valid_line(m.get("layer", "")):
            out.append(f"{m['name']}: bad layer")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not (Path(root) / "portbench" / "metrics"
                / f"{m['name']}.py").exists():
            out.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            if not valid_name(w.get(key)):
                out.append(f"{w['name']}: bad {key}")
        if not valid_line(w.get("why", "")):
            out.append(f"{w['name']}: bad why")
        if not (Path(root) / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists():
            out.append(f"{w['name']}: no traffic/{w['traffic']}.json")
    for c in bench["configs"]:
        if not PATH_RE.match(c.get("file", "")) or \
                not (Path(root) / c["file"]).exists():
            out.append(f"{c['name']}: missing file {c.get('file')!r}")
        for k in c.get("reduced", []):
            if not valid_name(k):
                out.append(f"{c['name']}: bad reduced key {k!r}")
        if not valid_line(c.get("source", "")):
            out.append(f"{c['name']}: bad source")
    return out
