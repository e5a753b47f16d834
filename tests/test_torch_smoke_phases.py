"""chip_smoke.py's phase selector and phase 10's shapes, on the CPU.

`--phases` takes phase numbers (the device, the build and the data always
run; unknown numbers are refused); phase 10's flatten histories are the
most clicks each user operator's positions take (33 slots a click: title
30, category, [ATTR_SEP], [SEP]), its pool shapes are those sequences,
its IISAN and BERT-zoo models are the YAMLs it names, its CLI models
exist; a history cut as a data config cuts it keeps every other store.
Phase 9.1's f32-backward pages are T 116 and 117 at head width 128.
The remat and knob A/Bs compare the losses both runs took
(`shared_loss_err`).
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from legommenders_tpu_torch.config import parser  # noqa: E402
from legommenders_tpu_torch.data.processors.synthetic import (  # noqa: E402
    SyntheticProcessor,
)
from legommenders_tpu_torch.runtime.manager import Manager  # noqa: E402


@pytest.mark.parametrize("argv,want", [
    ([], set(chip_smoke.PHASES)), (["--phases", "10"], {10}),
    (["--phases", "2,9"], {9}), (["--phases", "3, 4,10"], {3, 4, 10})])
def test_phases_select(argv, want):
    assert chip_smoke.parse_phases(argv) == want


def test_unknown_phase_is_refused():
    # phase 12 exists since the drivers and data parallel
    assert chip_smoke.parse_phases(["--phases", "12"]) == {12}
    with pytest.raises(SystemExit):
        chip_smoke.parse_phases(["--phases", "13"])


@pytest.mark.parametrize("name", list(chip_smoke.FLATTEN_MODELS))
def test_flatten_histories_fill_the_positions(name):
    kw = dict(chip_smoke.DATA_KW, num_items=200, num_users=12,
              vocab_size=300, inters_per_user=4)
    data = SyntheticProcessor(**kw).as_lego_data()
    clicks = chip_smoke.FLATTEN_MODELS[name][0]
    cut = chip_smoke.cut_history(data, clicks)
    assert cut.history_matrix().shape == (12, clicks)
    assert data.history_matrix().shape == (12, kw["history_len"])
    assert cut.items is data.items and cut.inters is data.inters
    tm = Manager(model_cfg=chip_smoke.zoo_cfg(name), data=cut,
                 device="cpu")
    inp, op = tm.model.user_inputer, tm.model.user_op
    positions = op.position_embeddings.shape[0]
    L = inp.seq_len(clicks)
    assert inp.per_click_len == 33
    assert L <= positions < inp.seq_len(clicks + 1)
    assert chip_smoke.FLATTEN_POOLS[f"{name} user"] == (L, 64)
    assert tm.cache is None and tm.model.flatten_mode


def test_phase10_models_are_the_yamls():
    root = os.path.join(ROOT, "config", "model")
    names = (list(chip_smoke.IISAN_MODELS) + list(chip_smoke.BERT_ZOO_MODELS)
             + list(chip_smoke.FLATTEN_MODELS)
             + list(chip_smoke.PHASE10_CLI_MODELS))
    for name in names:
        assert os.path.isfile(os.path.join(root, f"{name}.yaml")), name
    cfg = parser.parse_four_way({"model": "bert-iisan-naml"},
                                config_root=os.path.join(ROOT, "config"))
    ic = cfg.raw()["model"]["config"]["item_config"]
    assert ic["layer_selection_step"] == 2
    assert chip_smoke.IISAN_MODELS["llama-iisan-naml"] == {
        "num_hidden_layers": 4}


def test_f32_backward_edge_pages_are_t116_and_t117_at_dh128():
    """Phase 9.1 holds the f32 backward at dh 128 at T 116 (the last T its
    old shared memory took) and T 117 (the first it refused)."""
    import torch

    for name, page in chip_smoke.F32_BWD_PAGES.items():
        q, k, v, bias, g = chip_smoke.decoder_attention_inputs(
            page, torch.float32, "cpu", 17)
        T = q.shape[1]
        assert name == f"T {T}" and q.shape[-1] // page["heads"] == 128
        assert bias.shape == (q.shape[0], T, T)
    assert sorted(chip_smoke.F32_BWD_PAGES) == ["T 116", "T 117"]


def test_phase11_semantic_compositions_build():
    """Phase 11.2's compositions over the fixture with its code columns:
    flatten users (never cached), the pools a forward launches (the item
    Ada over the codes, a level each, the stack's pool), SemanticMix's
    pairs (4 item codes x 4 user codes)."""
    kw = dict(chip_smoke.DATA_KW, num_items=120, num_users=12,
              vocab_size=300, inters_per_user=4)
    data = chip_smoke.semantic_data(
        SyntheticProcessor(**kw).as_lego_data())
    assert data.items["semantic"].shape == (120, chip_smoke.SEMANTIC_CODES)
    assert data.users["semantic"].shape == (12, chip_smoke.SEMANTIC_CODES)
    assert data.items["semantic"].max() < chip_smoke.SEMANTIC_BOOK
    pools = {}
    for name, cfg in chip_smoke.SEMANTIC_MODELS.items():
        tm = Manager(model_cfg=cfg, data=data, device="cpu")
        assert tm.cache is None and tm.model.flatten_mode
        pools[name] = (chip_smoke._pools_of(tm.model.item_op)
                       + chip_smoke._pools_of(tm.model.user_op))
        if name.endswith("semanticmix"):
            assert tm.model.predictor.mix_linear.in_features == 16
    assert pools == {"ada-semantic-poly": 5, "ada-semantic-dot": 6,
                     "scsimple-scmix-semanticmix": 0}


def test_phase11_processed_mind_on_cpu(tmp_path, monkeypatch):
    """Phase 11.3 on the CPU: the fake MIND layout, `process --tokenizers
    glove:<file>`, NAML trained and tested through the CLI (the wrappers
    count no launch on the CPU: the count is stubbed)."""
    monkeypatch.setattr(chip_smoke, "_counts", lambda: {
        "additive_pool": 1, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0})
    rec = chip_smoke.run_processed_mind(str(tmp_path), "cpu")
    assert rec["outcome"] == "ran"
    items = rec["stores"]["items"]
    assert items[0] == chip_smoke.MIND_RAW["news"]
    assert "title@glove" in items[1]
    assert 0.0 <= rec["results"]["GAUC"] <= 1.0


def test_shared_loss_err_compares_the_steps_both_runs_took():
    """A remat or knob A/B holds the warm loss and the timed losses the two
    runs share, as a relative difference; a longer run's extra steps are
    not compared."""
    a = {"warm_loss": 2.0, "losses": [1.0, 0.5, 9.0, 9.0]}
    b = {"warm_loss": 2.0, "losses": [1.01, 0.5]}
    assert chip_smoke.shared_loss_err(a, b) == pytest.approx(0.01 / 1.01)
    assert chip_smoke.shared_loss_err(a, dict(a)) == 0.0
    c = {"warm_loss": 3.0, "losses": [1.0, 0.5]}
    assert chip_smoke.shared_loss_err(c, b) == pytest.approx(0.5)
