"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""
import json
import os
import re

import pytest

from tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)
from portbench import harness
from portbench.reference import model
from portbench.reference.precision import CASTS

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert all(_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_run_seconds_fit_a_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(("cell", w["name"]))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_entries():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", sorted(cells)):
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reports = [m for m in MAN["end_to_end"]
                   if "workloads" not in m or w in m["workloads"]]
        assert len(reports) >= 2
        assert any(w in m.get("workloads", [w]) for m in MAN["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(workload):
    f = harness.cell_files(MAN, workload)
    conf = next(c for c in MAN["configs"] if c["name"] == f["cell"]["config"])
    assert conf["file"].startswith("portbench/")
    kind = harness.kind(f)
    for name in ("drive", "judge", "controls", "pool_calls", "model_flops"):
        assert callable(getattr(kind, name)), name
    assert set(kind.PHASES) <= {"train", "test"}
    fam = model.family(f["config"]["reference"])
    for name in ("parameter_shapes", "items", "users", "item_pool_calls",
                 "user_pool_calls", "item_flops", "user_flops",
                 "page_attention", "gemm_flops"):
        assert callable(getattr(fam, name)), name
    assert f["config"]["control"] in CASTS
    assert f["limits"] and all(isinstance(v, float) for v in
                               f["limits"].values())
    for m in f["end_to_end"] + f["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_traffic_holds_traffic_only():
    """A mix's file holds its kind and the traffic's own parameters; how
    many units a run warms up, times or profiles is its kind's."""
    allowed = {"kind", "batch_size", "neg_count", "lr", "metrics",
               "weight_sets"}
    for w in MAN["workloads"]:
        tr = harness.cell_files(MAN, w["name"])["traffic"]
        assert set(tr) <= allowed, set(tr) - allowed


def test_every_config_used_and_every_file_named():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    metrics = {m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]}
    on_disk = {f[:-3] for f in os.listdir(os.path.join(harness.BENCH,
                                                       "metrics"))
               if f.endswith(".py")}
    assert on_disk == metrics
    limits = {f[:-5] for f in os.listdir(os.path.join(harness.BENCH,
                                                      "limits"))}
    assert limits == {w["name"] for w in MAN["workloads"]}


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_model_is_the_yaml_as_written(config):
    """The configuration runs the repo's YAML unchanged."""
    from legommenders_tpu_torch.config import parser

    cfg = harness.load_json(harness.ROOT, next(
        c["file"] for c in MAN["configs"] if c["name"] == config))
    raw = parser.parse_four_way({"model": config},
                                config_root=os.path.join(harness.ROOT,
                                                         "config")).raw()
    assert json.loads(json.dumps(raw["model"])) == cfg["model"]
