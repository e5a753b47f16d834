"""The port's config parser and CLI drivers vs the JAX package's.

  * `parse_four_way` gives JAX's dicts for config/exp/default,
    config/data/synthetic and config/model/{naml, bert-naml} with CLI
    overrides (plain keys as interpolation context, dotted keys as
    overrides), and the experiment signature is JAX's;
  * in-process at `make smoke`'s geometry with `--device cpu`:
    `process.main` into a temporary directory, then `trainer.main` (2
    epochs of 4 batches of 16, hidden 16) writes the result CSV with JAX's
    metric keys, and `tester.main` reloads its checkpoint (`--load_sign`),
    times 2 batches (`--latency`) and writes a torch.profiler trace and
    the program's spans of it;
  * without `--device cpu` the CLI raises where there is no card, and the
    multi-host options raise.
"""
import json
import os

import pytest
import torch

from legommenders_tpu.config import parser as jparser
from legommenders_tpu.utils.function import get_signature as jsignature
from legommenders_tpu.utils.function import parse_cli as jparse_cli
from legommenders_tpu_torch import process, tester, trainer
from legommenders_tpu_torch.cli.base import CONFIG_ROOT
from legommenders_tpu_torch.config import parser
from legommenders_tpu_torch.utils.function import get_signature, parse_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--data", "synthetic", "--model", "naml", "--epoch", "2",
         "--epoch_batch", "4", "--batch_size", "16", "--hidden_size", "16"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded torch while this module runs (the suite runs in
    parallel workers); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_root_is_the_checkouts():
    assert CONFIG_ROOT == os.path.join(ROOT, "config")


@pytest.mark.parametrize("argv", [
    SMOKE,
    ["--data", "synthetic", "--model", "bert-naml", "--exp", "default",
     "--hidden_size", "16", "--tune_from", "1", "--item_lr", "1e-4",
     "--model.config.item_config.num_hidden_layers", "2",
     "--exp.policy.lr", "0.01", "--metric", "MRR"],
], ids=["naml", "bert-naml"])
def test_parse_four_way_matches_jax(argv):
    cli = parse_cli(argv)
    assert cli == jparse_cli(argv)
    cli.setdefault("exp", "default")
    got = parser.parse_four_way(dict(cli), config_root=CONFIG_ROOT).raw()
    want = jparser.parse_four_way(dict(cli),
                                  config_root=CONFIG_ROOT).raw()
    assert got == want
    assert got["exp"]["policy"]["epoch"] == (2 if "--epoch" in argv else 50)
    if "--tune_from" in argv:
        assert got["model"]["config"]["item_config"]["tune_from"] == 1
        assert got["model"]["config"]["item_config"][
            "num_hidden_layers"] == 2
        assert got["exp"]["policy"]["lr"] == 0.01
        assert got["exp"]["store"]["metric"] == "MRR"
    axes = [got[a] for a in ("data", "model", "embed", "exp")]
    assert get_signature(*axes, {"seed": 2023}) == jsignature(
        *axes, {"seed": 2023})


def test_cli_smoke_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data_dir = str(tmp_path / "data" / "synthetic")
    stores = process.main(["--data", "synthetic", "--save_dir", data_dir])
    assert sorted(stores) == ["items", "test", "train", "users", "valid"]
    results = trainer.main(SMOKE + ["--data_dir", data_dir,
                                    "--device", "cpu"])
    (model_dir,) = list((tmp_path / "checkpoints" / "synthetic").iterdir())
    csvs = list(model_dir.glob("*.csv"))
    assert len(csvs) == 1
    sig = csvs[0].stem
    header, values = csvs[0].read_text().splitlines()
    want_keys = jparser.parse_four_way(
        {"exp": "default"}, config_root=CONFIG_ROOT).raw()["exp"]["metrics"]
    assert header.split(",") == want_keys == list(results)
    assert all(0.0 <= float(v) <= 1.0 for v in values.split(","))
    for ext in ("ckpt", "ckpt.meta.json", "json", "log"):
        assert (model_dir / f"{sig}.{ext}").is_file(), ext
    assert json.loads((model_dir / f"{sig}.json").read_text())["seed"] == 2023

    trace = tmp_path / "trace"
    again = tester.main(SMOKE + ["--data_dir", data_dir, "--device", "cpu",
                                 "--load_sign", sig, "--latency",
                                 "--num_batches", "2", "--trace",
                                 str(trace)])
    # the reloaded best checkpoint scores as the trainer's test did
    for k in results:
        assert abs(again[k] - results[k]) <= 1e-6, (k, again, results)
    assert (trace / "trace.json").stat().st_size > 0
    names = {r["name"] for r in json.loads((trace / "spans.json").read_text())}
    assert {"lego.cache.items", "lego.cache.item_page", "lego.cache.users",
            "lego.eval.metrics"} <= names


def test_cli_requires_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.main(SMOKE)
    # a manual multi-process launch names its size and rank (the launch
    # itself: tests/test_torch_dp.py)
    with pytest.raises(SystemExit, match="--num_processes and --process_id"):
        trainer.main(SMOKE + ["--device", "cpu", "--coordinator",
                              "localhost:1234"])
    with pytest.raises(SystemExit, match="--model is required"):
        trainer.main(["--data", "synthetic", "--device", "cpu"])


def test_cli_process_group_opens_and_closes(tmp_path, monkeypatch):
    """A manual launch of one process (`--coordinator` with its size and
    rank) under `exp.policy.mesh: true`: the run trains at dp 1 in a gloo
    group, rank 0 writes the result CSV, and the group is destroyed at the
    run's end."""
    import torch.distributed as dist

    monkeypatch.chdir(tmp_path)
    data_dir = str(tmp_path / "data" / "synthetic")
    process.main(["--data", "synthetic", "--save_dir", data_dir])
    results = trainer.main(SMOKE + [
        "--data_dir", data_dir, "--device", "cpu", "--coordinator",
        f"file://{tmp_path}/group", "--num_processes", "1",
        "--process_id", "0", "--exp.policy.mesh", "true"])
    assert not dist.is_initialized()
    assert set(results) >= {"GAUC", "MRR"}
    csvs = [f for _, _, fs in os.walk(tmp_path / "checkpoints") for f in fs
            if f.endswith(".csv")]
    assert len(csvs) == 1
