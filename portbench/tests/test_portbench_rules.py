"""BENCHMARK.json against the name, unit and file rules, and the
whole-name import check."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.harness import guard, spec

ROOT = Path(__file__).resolve().parents[2]


def test_benchmark_json_keeps_the_rules():
    bench = spec.load_benchmark(ROOT)
    assert spec.problems(bench, ROOT) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        moved = {m["moves"] for m in cell.per_layer}
        reported = {m["name"] for m in cell.end_to_end}
        assert moved <= reported, w["name"]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_name_and_unit_rules():
    assert spec.valid_name("qwen3-4b.prefill-long")
    assert spec.valid_name("_x") and spec.valid_name("9a")
    for bad in ("", "-a", ".a", "a b", "a,b", "a/b", "a" * 65, "µs"):
        assert not spec.valid_name(bad), bad
    assert spec.valid_unit("tokens/s") and spec.valid_unit("%")
    for bad in ("tokens per second", "", "µs", "a" * 17):
        assert not spec.valid_unit(bad), bad
    assert spec.valid_line("x" * 200) and not spec.valid_line("x" * 201)
    assert not spec.valid_line("a\tb") and not spec.valid_line("a\nb")


def test_problems_finds_a_bad_entry():
    bench = json.loads(json.dumps(spec.load_benchmark(ROOT)))
    bench["per_layer"][0]["unit"] = "per cent"
    bench["workloads"][0]["traffic"] = "no-such-mix"
    found = spec.problems(bench, ROOT)
    assert any("bad unit" in p for p in found)
    assert any("no traffic/no-such-mix.json" in p for p in found)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.models", "reproduce", "repro",
            "repro.core", "jax", "jax.numpy", "jaxlib", "jaxtyping",
            "flax.linen", "torch"]
    assert guard.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_the_benchmark_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from portbench.harness import spec, runner, check, trace, guard\n"
        "import repro_torch.serving.generation, repro_torch.models.moe\n"
        "import repro_torch.kernels.ops\n"
        "b = spec.load_benchmark()\n"
        "[spec.metric_reader(m['name']) for m in b['per_layer']]\n"
        "print(guard.forbidden_modules())\n").format(
            root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "work.py", "window.py",
                 "traffic.py", "weights.py"):
        tree = ast.parse((ROOT / "portbench" / "harness" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("repro", "repro_torch", "jax"), (name, m)


def test_the_command_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "qwen3-4b.prefill-long", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
