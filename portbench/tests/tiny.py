"""Tiny copies of the benchmark's cells for the CPU tests: the cells'
files with the fixture, the widths and the batch cut down."""
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

DATA = dict(items=120, users=60, vocab=300, topics=6, title_tokens=[4, 9],
            history=[3, 8], train_clicks=96, negatives=[0, 7],
            test_impressions=30, candidates=[2, 12])


def files(workload: str, dtype: str = "f32") -> dict:
    """The cell's files, cut to run in seconds on the CPU, at `dtype` (an
    LM's too, where f32)."""
    f = copy.deepcopy(harness.cell_files(harness.manifest(), workload))
    cfg, tr = f["config"], f["traffic"]
    cfg["data"] = dict(DATA)
    cfg["policy"] = {"dtype": dtype}
    item = cfg["model"]["config"]["item_config"]
    if dtype == "f32" and "lm_dtype" in item:
        item["lm_dtype"] = "f32"
    ref = cfg["reference"]
    if ref["family"] == "bert":
        ref.update(layers=2, dim=64, heads=4, ffn=256, max_position=64)
        mc = cfg["model"]["config"]
        mc["embedding_dim"] = 64
        mc["item_config"] = dict(mc["item_config"], num_hidden_layers=2,
                                 num_attention_heads=4, max_position=64)
        mc["cache_page_size"] = 32
    else:
        cfg["model"]["config"]["cache_page_size"] = 32
    if tr["kind"] == "train":
        tr["batch_size"] = 16
    return f
