"""The port's CLI runs the CTR zoo's YAMLs on the CPU.

`python -m legommenders_tpu_torch.trainer --model {dcn_id,din_text}` at
`make smoke`'s geometry (2 epochs of 4 batches of 16, hidden 16, the
YAMLs' other defaults: MLPs of [1000, 1000, 1000], ranking mode) with
`--device cpu`, in process, over one synthetic dataset made by
`process.main`: each run trains with a finite loss and writes its result
CSV with JAX's metric keys and values in [0, 1]. dcn_id is an id-only
model (Ada over the item-id table, full-forward evaluation), din_text
pools the item content and evaluates by full forwards (its null user
operator refuses caching).
"""
import numpy as np
import pytest
import torch

from legommenders_tpu.config import parser as jparser
from legommenders_tpu_torch import process, trainer
from legommenders_tpu_torch.cli.base import CONFIG_ROOT
from legommenders_tpu_torch.runtime.trainer import Trainer

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


@pytest.mark.parametrize("model,name,item_op", [
    ("dcn_id", "dcn_id", None), ("din_text", "DIN_text", "Pooling")])
def test_cli_trains_the_ctr_zoo_on_the_cpu(model, name, item_op, data_dir,
                                           monkeypatch):
    root, path = data_dir
    monkeypatch.chdir(root)
    trainers = []
    train = Trainer.train

    def spy(self):
        trainers.append(self)
        return train(self)

    monkeypatch.setattr(Trainer, "train", spy)
    results = trainer.main(SMOKE + ["--model", model, "--data_dir", path])
    (tr,) = trainers
    assert tr.global_step == 8
    assert np.isfinite([e["loss"] for e in tr.epochs]).all()
    assert tr.m.lego_cfg.use_neg_sampling is False
    op = tr.m.model.item_op
    assert (op and type(op).__name__.replace("Operator", "")) == item_op
    assert tr.m.cache is None
    (csv,) = (root / "checkpoints" / "synthetic" / name).glob("*.csv")
    want_keys = jparser.parse_four_way(
        {"exp": "default"}, config_root=CONFIG_ROOT).raw()["exp"]["metrics"]
    assert list(results) == want_keys
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in results.values())
    assert csv.read_text().splitlines()[0].split(",") == want_keys
