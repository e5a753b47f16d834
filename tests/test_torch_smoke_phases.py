"""chip_smoke.py's phase selector and phase 10's shapes, on the CPU.

`--phases` takes phase numbers (the device, the build and the data always
run; unknown numbers are refused); phase 10's flatten histories are the
most clicks each user operator's positions take (33 slots a click: title
30, category, [ATTR_SEP], [SEP]), its pool shapes are those sequences,
its IISAN and BERT-zoo models are the YAMLs it names, its CLI models
exist; a history cut as a data config cuts it keeps every other store.
Phase 9.1's f32-backward pages are T 116 and 117 at head width 128.
Phase 14's and 15's cases run what they name, a rank's launch counts
are the code's, and the fixture keeps the first users' dev and test rows.
Phase 16's launch counts by point and by Trainer pass are the code's, and
its pool checks take every shape its models pool.
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
    # phase 16 exists since the scaling sweep and the dry run
    assert chip_smoke.parse_phases(["--phases", "16"]) == {16}
    with pytest.raises(SystemExit):
        chip_smoke.parse_phases(["--phases", "17"])


def test_phase14_cases_run_what_they_name():
    """Phase 14's cases: flatten_transformer at sp 2 under Ulysses and
    ring (bf16, phase 10.4's batches) and under Ulysses at f32 (a quarter
    of the batches), flatten_fastformer at sp 2, each with its user
    operator's sequence_parallel; bert-naml at pp 2 is phase 5's
    layer-split training at dropout 0; the histories give L 990 and 462,
    both divisible by sp 2, within the operators' positions."""
    cases = chip_smoke.p14_cases()
    assert list(cases) == ["flatten_transformer sp 2 ulysses",
                           "flatten_transformer sp 2 ring",
                           "flatten_transformer sp 2 ulysses f32",
                           "flatten_fastformer sp 2", "bert-naml pp 2"]
    for name, spec in cases.items():
        cfg = spec.case.cfg["config"]
        if "sp" in spec.case.mesh:
            assert spec.case.mesh == {"sp": 2}
            assert cfg["user_config"]["sequence_parallel"]
            L = 33 * chip_smoke.P14_CLICKS[spec.case.data]
            assert L % 2 == 0 and L <= (1024 if "transformer" in name
                                        else 512)
    assert cases["flatten_transformer sp 2 ring"].case.cfg["config"][
        "user_config"]["sp_impl"] == "ring"
    assert (cases["flatten_transformer sp 2 ulysses"].batch,
            cases["flatten_fastformer sp 2"].batch) == (
        chip_smoke.FLATTEN_MODELS["flatten_transformer"][1],
        chip_smoke.FLATTEN_MODELS["flatten_fastformer"][1])
    f32 = cases["flatten_transformer sp 2 ulysses f32"]
    assert (f32.case.dtype, f32.batch) == ("f32", chip_smoke.P14_F32_BATCH)
    pp = cases["bert-naml pp 2"]
    item = pp.case.cfg["config"]["item_config"]
    assert pp.case.mesh == {"pp": 2} and pp.case.data == "small"
    assert (item["tune_from"], item["dropout"]) == (10, 0.0)
    assert pp.case.cfg["config"]["item_page_remat"] == "ffn"


def test_p14_expected_launches_are_the_codes():
    """A sp rank launches the item pools only (the user pool is the
    two-psum pool); a pp 2 rank runs its one layer in 4 microbatches a
    page of 512, twice (`ffn` recomputes) forward and once backward, and
    the serial dev pass."""
    cases = chip_smoke.p14_cases()
    one = {"additive_pool": 26, "packed_attention": 192,
           "packed_attention_backward": 64, "dropout_keep_mask": 0}
    sp = chip_smoke._p14_expected(
        "flatten_transformer sp 2 ring",
        cases["flatten_transformer sp 2 ring"], one, 1, 1)
    assert sp == dict(one, additive_pool=13)
    pp = chip_smoke._p14_expected("bert-naml pp 2", cases["bert-naml pp 2"],
                                  one, 1, 1)
    pages = chip_smoke.P13_SMALL_DATA_KW["num_items"] // 512
    assert pp == dict(one, packed_attention=192 + pages * 2 * (4 - 2),
                      packed_attention_backward=pages * 4)


def test_phase15_cases_run_what_they_name():
    """Phase 15's cases: bert-naml at (mp 2, pp 2) on 2,048 items (phase
    5's layer-split training at dropout 0), flatten_transformer at (mp 2,
    sp 2) under Ulysses, the sp x pp composition (a 2-layer BERT item
    operator at the flatten model's width, every dropout 0) on four ranks;
    bert-naml catalog_parallel at dp 2 by full forwards, on two."""
    cases = chip_smoke.p15_cases()
    assert [(s.case.mesh, s.group) for s in cases.values()] == [
        ({"mp": 2, "pp": 2}, "four"), ({"mp": 2, "sp": 2}, "four"),
        ({"sp": 2, "pp": 2}, "four"),
        ({"dp": 2, "catalog_parallel": True}, "two")]
    for spec in cases.values():
        n = 1
        for a in ("dp", "mp", "sp", "pp"):
            n *= spec.case.mesh.get(a, 1)
        assert n == chip_smoke.P15_GROUPS[spec.group]
    tp, ms, sppp, cat = cases.values()
    assert (tp.case.data, tp.case.cfg["config"]["item_config"]["dropout"]) \
        == ("small", 0.0)
    assert ms.case.cfg["config"]["user_config"]["sp_impl"] == "ulysses"
    cfg = sppp.case.cfg["config"]
    assert cfg["embedding_dim"] == cfg["hidden_size"]
    assert cfg["item_config"]["num_hidden_layers"] == 2
    assert cfg["user_config"]["attention_dropout"] == 0.0
    assert cat.case.test and not cat.case.cfg["config"]["use_fast_eval"]


def test_p15_runs_hold_the_pp_cases_at_f32_too():
    """Every case runs at its own dtype, then each pp case again at f32 (a
    flatten case at phase 14's f32 batches); the catalog-parallel case's
    batch is small enough for several dev batches."""
    runs = chip_smoke.p15_runs()
    cases = chip_smoke.p15_cases()
    assert [(label, dtype) for label, _, dtype in runs] == (
        [(n, None) for n in cases]
        + [(f"{n} f32", "f32") for n in chip_smoke.P15_F32])
    by = {label: spec for label, spec, _ in runs}
    assert by["bert-naml mp 2 x pp 2 f32"] == cases["bert-naml mp 2 x pp 2"]
    assert (by["bert flatten sp 2 x pp 2 f32"].batch,
            by["bert flatten sp 2 x pp 2 f32"].eval_batch) == (
        chip_smoke.P14_F32_BATCH, chip_smoke.P14_F32_EVAL)
    cat = cases["bert-naml catalog_parallel dp 2"]
    assert (cat.batch, cat.eval_batch) == (
        chip_smoke.P15_CATALOG_BATCH, chip_smoke.P15_CATALOG_PAGE)


@pytest.mark.parametrize("got,passes", [
    # a rounding spread: within PP_NOISE times the noise run's
    (1.0 + 1.5e-3, True),
    # a tensor whose own spread is below F32_GRAD_TOL, within it
    (1.0 + 5e-5, True),
    # a dropped microbatch's share of the sum
    (1.0 - 1 / 16, False)])
def test_p15_f32_rule_allows_one_process_own_spread(got, passes):
    """The f32 ranks' gradient passes within F32_GRAD_TOL of one
    process's, or within PP_NOISE times the spread one ulp of input noise
    gives one process (here 1e-3 on w, nothing on b); a microbatch's
    share of the sum fails."""
    import torch
    want = {"w": torch.tensor([1.0, -1.0]), "b": torch.tensor([2.0, 1.0])}
    noisy = {"w": torch.tensor([1.001, -1.0]), "b": torch.tensor([2.0, 1.0])}
    tensor = "w" if abs(got - 1.0) > 1e-4 else "b"
    got_g = {k: v.clone() for k, v in want.items()}
    got_g[tensor][0] = got * want[tensor][0]
    rule, allow = chip_smoke._p15_f32_rule(got_g, want, noisy)
    assert allow["w"] == pytest.approx(chip_smoke.PP_NOISE * 1e-3, rel=1e-3)
    assert allow["b"] == chip_smoke.F32_GRAD_TOL
    assert (rule["excess"] <= chip_smoke.F32_GRAD_TOL) == passes


def test_p15_ulp_noise_moves_float_columns_by_an_ulp():
    """The noise run's columns: floats times 1 + 2^-23 n, ids untouched."""
    import types

    import torch
    cols = {"ids": torch.arange(6).reshape(2, 3),
            "h": torch.ones(64, 8)}
    m = types.SimpleNamespace(device=torch.device("cpu"),
                              contents=types.SimpleNamespace(columns=cols))
    ids = cols["ids"].clone()
    chip_smoke._p15_ulp_noise(m)
    assert torch.equal(cols["ids"], ids)
    rel = (cols["h"] - 1).abs()
    assert 0 < float(rel.max()) < 2.0 ** -23 * 8
    assert float((rel > 0).float().mean()) > 0.5


def test_p15_expected_launches_are_the_codes():
    """A (mp 2, pp 2) rank runs its one layer in 4 microbatches a page of
    512 (4 pages of 2,048 items), twice forward (`ffn`) and once backward;
    the sp x pp rank its one BERT layer in 4 microbatches of the
    candidates' one encode and only the item pools; a catalog-parallel
    rank its 1,024 rows (2 pages) once a step (and the recompute), once
    for simple_dev and once for the test, the user pool once a step, a
    dev batch and a test page."""
    cases = chip_smoke.p15_cases()
    one = {"additive_pool": 26, "packed_attention": 24,
           "packed_attention_backward": 8, "dropout_keep_mask": 0}
    tp = chip_smoke._p15_expected(cases["bert-naml mp 2 x pp 2"], one,
                                  (1, 1))
    assert tp == dict(one, packed_attention=24 + 4 * 2 * (4 - 2),
                      packed_attention_backward=4 * 4)
    sppp = chip_smoke._p15_expected(cases["bert flatten sp 2 x pp 2"], one,
                                    (1, 1))
    assert sppp == dict(one, additive_pool=13, packed_attention=24 + 2,
                        packed_attention_backward=4)
    cat = chip_smoke._p15_expected(
        cases["bert-naml catalog_parallel dp 2"], one, (1, 1), (3, 5))
    assert cat == dict(one, additive_pool=2 * 4 + 1 + 3 + 5,
                       packed_attention=2 * 2 * 4,
                       packed_attention_backward=2 * 2)


@pytest.mark.parametrize("got,passes", [
    # within one process's own bf16 error of its bf16 gradient
    (0.85, True),
    # further from it, but as near the f32 gradient as PP_ROUNDING allows
    (1.25, True),
    # far from both: a missed sum over pp or mp
    (0.0, False)])
def test_p15_bf16_rule_anchors_a_rounding_spread_at_f32(got, passes):
    """A tensor whose bf16 error dominates (one process's bf16 gradient
    0.7 against f32's 1.0, own error 0.3) passes within that error of the
    bf16 gradient, or within PP_ROUNDING times it of the f32 gradient; a
    rank gradient far from both fails."""
    import torch
    want32 = {"w": torch.tensor([1.0, -1.0])}
    want16 = {"w": torch.tensor([0.7, -1.0])}
    got_g = {"w": torch.tensor([got, -1.0])}
    rule, allow = chip_smoke._p15_bf16_rule(got_g, want16, want32)
    assert allow["w"] == pytest.approx(0.3)
    assert (rule["excess"] <= chip_smoke.BF16_REL_TOL) == passes


def test_cut_history_keeps_the_first_users_eval_rows():
    kw = dict(chip_smoke.DATA_KW, num_items=200, num_users=12,
              vocab_size=300, inters_per_user=4)
    data = SyntheticProcessor(**kw).as_lego_data()
    cut = chip_smoke.cut_history(data, 3, users=5)
    for phase in ("dev", "test"):
        users = cut.inters[phase]["user_id"]
        assert len(users) and users.max() < 5
        assert len(users) == int((data.inters[phase]["user_id"] < 5).sum())
    assert cut.inters["train"] is data.inters["train"]
    assert chip_smoke.cut_history(data, 3).inters is data.inters


def test_phase13_cases_shard_what_they_name():
    """Phase 13's cases: bert-naml at mp 2 is phase 5's layer-split
    training at dropout 0.1 evaluated through its caches, in bf16 and
    again with its LM in f32, both on 2,048 items;
    dcnv2_id's CrossNetMix shards its 4 experts 2 a rank; NAML's
    30,000-word table shards to 15,000 rows a rank at min_rows_to_shard
    0; the catalog-parallel bert-naml runs at dropout 0 over the two
    ranks. A rank runs `chip_smoke.p13_rank` (parallel/launch.py)."""
    from legommenders_tpu_torch.parallel import mesh as tmesh

    cases = chip_smoke.p13_cases()
    assert list(cases) == ["bert-naml mp 2", "bert-naml mp 2 f32",
                           "dcnv2_id mp 2", "naml mp 2",
                           "bert-naml catalog_parallel"]
    bert = cases["bert-naml mp 2"]
    item = bert.cfg["config"]["item_config"]
    assert bert.mesh == {"mp": 2} and not bert.test
    assert (bert.dtype, bert.data) == ("bf16", "small")
    assert (item["tune_from"], item["dropout"], item["attn_dropout"]) == (
        10, chip_smoke.TRAIN_DROPOUT, chip_smoke.TRAIN_DROPOUT)
    assert bert.cfg["config"]["item_page_remat"] == "ffn"
    assert bert.cfg["config"]["use_fast_eval"]
    f32 = cases["bert-naml mp 2 f32"]
    assert (f32.mesh, f32.dtype, f32.data) == ({"mp": 2}, "f32", "small")
    item32 = dict(f32.cfg["config"]["item_config"], lm_dtype="bf16")
    assert f32.cfg["config"]["item_config"]["lm_dtype"] == "f32"
    assert item32 == item and item["lm_dtype"] == "bf16"
    assert chip_smoke.P13_SMALL_DATA_KW == dict(chip_smoke.DOTS_DATA_KW,
                                                num_items=2048)
    cat = cases["bert-naml catalog_parallel"]
    assert cat.mesh == {"catalog_parallel": True} and cat.test
    assert cat.cfg["config"]["item_config"]["dropout"] == 0.0
    kw = dict(chip_smoke.DATA_KW, num_items=200, num_users=12,
              inters_per_user=4)
    data = SyntheticProcessor(**kw).as_lego_data()
    mesh = tmesh.Mesh(1, 1, 2)
    for name, want in (("dcnv2_id mp 2", "U_0"), ("naml mp 2", "tables")):
        cfg, mcfg = cases[name].cfg, cases[name].mesh
        m = Manager(model_cfg=cfg, data=data, device="cpu")
        plan = tmesh.shard_plan(m.model, mesh,
                                mcfg.get("min_rows_to_shard", 0))
        assert any(want in k for k in plan.sharded), (name, plan.sharded)
        if name == "naml mp 2":
            table = m.model.eh.tables["vocab__word"]
            assert table.shape[0] == 30000
            tmesh.place_model(m.model, mesh)
            assert table.shape[0] == 15000


def _adam_first_step(w, g):
    """w after torch's Adam's first step at chip_smoke.TRAIN_LR."""
    import torch

    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    torch.optim.Adam([p], lr=chip_smoke.TRAIN_LR, eps=chip_smoke.ADAM_EPS
                     ).step()
    return p.detach()


@pytest.mark.parametrize("fault,want", [
    (None, 0.0), ("skipped", 1.0), ("doubled", 1.0), ("flipped", 2.0)])
def test_p13_update_check_reads_a_faulty_step(fault, want):
    """Phase 13's update check: the ranks' Adam step against one process's
    over lr. A gradient within the gradient gate of zero may take the
    other sign (a whole step of 2 lr apart) and is left out, as is one
    within 50 eps; a skipped, doubled or flipped step reads 1, 1 or 2."""
    import torch

    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn(64, 8, generator=gen)
    # every other gradient far from zero: only the three below are small
    g = torch.randn(64, 8, generator=gen).sign() * (
        0.5 + torch.rand(64, 8, generator=gen)) * 1e-3
    g[0, 0], g[1, 0], g[2, 0] = 1e-7, 1e-9, 0.0
    got_g = g.clone()
    got_g[0, 0] = -g[0, 0]  # rounding residue of the other sign
    got_g[1, 0] = -g[1, 0]
    want_w = _adam_first_step(w0, g)
    got_w = _adam_first_step(w0, got_g)
    if fault == "skipped":
        got_w = w0.clone()
    elif fault == "doubled":
        got_w = w0 + 2 * (got_w - w0)
    elif fault == "flipped":
        got_w = w0 - (got_w - w0)
    names = ("layer.weight",)
    errs, left_out = chip_smoke._p13_update_errs(
        dict(zip(names, [got_w])), dict(zip(names, [w0])),
        dict(zip(names, [want_w])), dict(zip(names, [w0])),
        dict(zip(names, [g])), dict.fromkeys(names, chip_smoke.BF16_REL_TOL))
    # the updates are differences of f32 weights near 1: ulps of lr
    assert errs["layer.weight"] == pytest.approx(want, abs=5e-3)
    assert left_out == pytest.approx(3 / g.numel())


def test_p13_update_check_holds_a_tensor_without_gradient_whole():
    import torch

    w0 = torch.zeros(4)
    moved = w0 + chip_smoke.TRAIN_LR
    errs, left_out = chip_smoke._p13_update_errs(
        {"b": moved}, {"b": w0}, {"b": w0}, {"b": w0}, {}, {})
    assert errs["b"] == pytest.approx(1.0) and left_out == 0.0


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


@pytest.mark.parametrize("label,want", [
    ("dp 1", {"additive_pool": 6}), ("dp 2 mp 2", {"additive_pool": 6}),
    ("sp 4", {}), ("pp 2", {"packed_attention": 2 + 4}),
    ("catalog 4", {"additive_pool": 4})])
def test_p16_point_expected_launches_are_the_codes(label, want):
    """A sweep point's launches on each rank (3 steps): an NRMS step pools
    its items and its users once; the sp pool is plain; the pp point runs
    the serial slice's 2 layers, then its one staged layer in 4
    microbatches; the catalog point one process's step and the sharded
    step, two pools each. The counts a CPU rehearsal of the phase read
    from the plain versions' calls."""
    assert chip_smoke._p16_point_expected(label, 3) == want


@pytest.mark.parametrize("name,rec,mesh_cfg,rank,want", [
    # the serial BERT: 2 steps of 2 layers, 2 evaluations of 3 item pages
    # (40 items in pages of 16) and 2 user pages (24 users)
    ("pp", {"steps": 2, "evaluations": 2, "cache": (40, 24, 16)}, None, 0,
     {"additive_pool": 14, "packed_attention": 16,
      "packed_attention_backward": 4}),
    # staged at (dp 2, pp 2), rank 3 (dp index 1): 4 microbatches of its
    # one layer a step; its block of 20 items and of 12 users, 2 + 1 pages
    ("pp", {"steps": 2, "evaluations": 2, "cache": (40, 24, 16)},
     {"dp": 2, "pp": 2}, 3,
     {"additive_pool": 10, "packed_attention": 16,
      "packed_attention_backward": 8}),
    ("mesh", {"steps": 2, "evaluations": 2, "cache": (64, 32, 512)},
     {"dp": 2, "mp": 2}, 1, {"additive_pool": 8}),
    ("catalog", {"steps": 2, "evaluations": 2, "cache": (64, 32, 512)},
     {"dp": 4, "catalog_parallel": True}, 2, {"additive_pool": 8}),
    ("sp", {}, {"sp": 4}, 0, {})])
def test_p16_trainer_expected_launches_are_the_codes(name, rec, mesh_cfg,
                                                     rank, want):
    """The dry run's Trainer passes: a step pools its rows' items and users
    once (the BERT's layers forward and backward once, or under pp its
    stage's layer once a microbatch); an evaluation encodes the rank's dp
    block of items and users in cache pages (the BERT's layers once a
    page). The counts a CPU rehearsal of the phase read from the plain
    versions' calls."""
    assert chip_smoke._p16_trainer_expected(name, rec, mesh_cfg,
                                            rank) == want


def test_p16_pool_shapes_are_the_models():
    """Phase 16's pool checks take every (L, D) the phase's models pool:
    the entry NRMS, the BERT, the catalog point's NAML and NRMS at its
    YAML's width on titles of 30 and histories of 50."""
    import torch
    from legommenders_tpu_torch import graft, scaling
    from legommenders_tpu_torch.models.common import AdditiveAttention

    seen = set()

    def hook(mod, args):
        if isinstance(mod, AdditiveAttention):
            seen.add(tuple(args[0].shape[-2:]))

    wide = SyntheticProcessor(num_items=200, num_users=50, title_len=30,
                              history_len=50).as_lego_data()
    models = [(graft.nrms_cfg(), graft.synthetic(64, 32)),
              (graft.BERT_CFG, graft.synthetic(40, 24, history_len=4)),
              (scaling.CATALOG_CFG, graft.synthetic(100, 40, history_len=6)),
              (chip_smoke.p16_cfg(), wide)]
    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        for cfg, data in models:
            m = Manager(model_cfg=cfg, exp_cfg={"policy": {
                "batch_size": 16}}, data=data, device="cpu")
            with torch.no_grad():
                m.model(graft.first_batch(m), m.contents.columns)
    finally:
        handle.remove()
    assert seen == {(L, d) for _, L, d in chip_smoke.P16_POOLS.values()}


def test_p16_full_expected_launches_are_the_codes():
    """The full-width points (batch 2,048, 65,000 items, 4 negatives,
    histories of 50; pages of 8,192 under `full` remat): one process and
    a (dp 2, mp 2) rank encode the whole catalog a step (8 pages, twice),
    a dp-4 rank its 512 rows' 28,160 occurrences (4 pages, twice); the
    user pool once; 3 steps."""
    import numpy as np

    class Fixture:
        num_items = chip_smoke.DATA_KW["num_items"]

        @staticmethod
        def history_matrix():
            return np.zeros((4, chip_smoke.DATA_KW["history_len"]))

    for n_dp, pages in ((1, 8), (2, 8), (4, 4)):
        assert chip_smoke._p16_full_expected(n_dp, Fixture) == {
            "additive_pool": 3 * (2 * pages + 1)}

