"""The port's CLI runs the news zoo's YAMLs on the CPU.

`python -m legommenders_tpu_torch.trainer --model {nrms,lstur,fastformer,
miner}` at `make smoke`'s geometry (2 epochs of 4 batches of 16, hidden
16, the YAMLs' other defaults) with `--device cpu`, in process, over one
synthetic dataset made by `process.main`: each run writes its result CSV
with JAX's metric keys and values in [0, 1], and trains with its catalog
gradient plans live.
"""
import pytest
import torch

from legommenders_tpu.config import parser as jparser
from legommenders_tpu_torch import process, trainer
from legommenders_tpu_torch.cli.base import CONFIG_ROOT
from legommenders_tpu_torch.ops import catalog_grad

SMOKE = ["--data", "synthetic", "--epoch", "2", "--epoch_batch", "4",
         "--batch_size", "16", "--hidden_size", "16", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    path = str(root / "data" / "synthetic")
    process.main(["--data", "synthetic", "--save_dir", path])
    return root, path


@pytest.mark.parametrize("model,name", [
    ("nrms", "NRMS"), ("lstur", "LSTUR"), ("fastformer", "Fastformer"),
    ("miner", "MINER")])
def test_cli_trains_the_zoo_on_the_cpu(model, name, data_dir, monkeypatch):
    root, path = data_dir
    monkeypatch.chdir(root)
    catalog_grad.record_trace((), ())
    # MINER evaluates by full forwards, each eval batch encoding the
    # catalog: larger eval batches, fewer encodes
    results = trainer.main(SMOKE + ["--model", model, "--data_dir", path,
                                    "--exp.policy.eval_batch_size", "4096"])
    assert set(catalog_grad.last_trace["live"]) == {"title", "category"}
    (csv,) = (root / "checkpoints" / "synthetic" / name).glob("*.csv")
    want_keys = jparser.parse_four_way(
        {"exp": "default"}, config_root=CONFIG_ROOT).raw()["exp"]["metrics"]
    assert list(results) == want_keys
    assert all(0.0 <= v <= 1.0 for v in results.values())
    assert csv.read_text().splitlines()[0].split(",") == want_keys
