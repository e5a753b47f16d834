"""The shape of a run's last line, the command's refusals without a card or
without the program, and the import rules: nothing the benchmark runs
loads JAX, flax, optax or the JAX package (whole top-level names: the
port's begins with the JAX package's), and the reference loads nothing of
the port."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import tiny
from portbench import harness

BENCH = harness.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "legommenders_tpu"}


def _check_line(out: dict, trace: bool):
    text = json.dumps(out)
    assert json.loads(text) == out
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert out["attempted"] >= 1 and 0 <= out["failed"] <= out["attempted"]
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
    if trace:
        for part in ("device_ops", "idle_gaps"):
            rows = out["breakdown"][part]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and isinstance(s, float)
                       for n, s in rows)


@pytest.mark.parametrize("workload", ["naml.train", "bert-naml.eval"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(workload, trace):
    files = tiny.files(workload)
    out = harness.run_cell(files, 2 ** 31 + 3, 0.3, trace, "cpu",
                           log=lambda m: None)
    _check_line(out, trace)
    want = files["per_layer"] if trace else files["end_to_end"]
    names = {m["name"] for m in want}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    p = _run(harness.ROOT, "--workload", "naml.train", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "bert-naml.eval", "--seed", "1",
             "--seconds", "1", "--trace", "1")
    assert p.returncode != 0 and p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def _sources(sub=""):
    for dirpath, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"torch", "numpy", "math", "importlib", "os", "sys",
                        "portbench"}, (path, tops)
        assert not any(m.startswith("portbench.") and not m.startswith(
            "portbench.reference") for m in _imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference,"
            " portbench.control, portbench.work, portbench.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % harness.ROOT)
    tops = set(json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, check=True).stdout.replace("'", '"')))
    assert not tops & (FORBIDDEN | {harness.PORT})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "legommenders_tpu_torch_x", sys)
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "legommenders_tpu.utils", sys)
    assert harness.forbidden_modules() == ["legommenders_tpu"]
