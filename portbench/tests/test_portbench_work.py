"""The yardstick's operation and byte counts against shapes worked by
hand."""
import pytest

from tiny import ROOT  # noqa: F401
from portbench import harness, readers, work
from portbench.reference import model
from portbench.reference.precision import CASTS


def test_pool_bound_by_hand():
    # N 65,238 items, L 31, d 64, h 256, bf16 x
    N, L = 65238, 31
    flops = 2.0 * N * L * (64 * 256 + 256 + 64)
    nbytes = N * L * 64 * 2 + N * L * 4 + (64 * 256 + 512) * 4 + N * 64 * 2
    tanh = N * L * 256 / (16 * 132 * 1.98e9)
    want = max(flops / 989e12, nbytes / 3.35e12, tanh)
    assert work.pool_bound_s(N, L, 64, 256) == pytest.approx(want)
    # here the tanh units bound it: 517.7 M tanh at 4.18 T/s
    assert want == pytest.approx(tanh)
    assert tanh == pytest.approx(1.2383e-4, rel=1e-3)


def test_attention_bound_by_hand():
    # a full page: 171 rows of T 102 (3 items of 34), D 768, bf16
    B, T, D = 171, 102, 768
    flops = 4.0 * B * T * T * D
    nbytes = 4 * B * T * D * 2 + B * T * T * 2
    assert flops == pytest.approx(5.4652e9, rel=1e-4)
    assert work.attention_bound_s(B, T, D) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    # the bytes bound it: 107.2 MB of q, k, v and out and 3.6 MB of bias
    # at 3.35 TB/s, 33.05 us
    assert work.attention_bound_s(B, T, D) == pytest.approx(3.3051e-5,
                                                            rel=1e-4)


def _files(w):
    f = harness.cell_files(harness.manifest(), w)
    return f["config"], f["traffic"], harness.kind(f)


def test_cell_shapes_by_hand():
    cfg, tr, kind = _files("bert-naml.eval")
    ref = cfg["reference"]
    # [CLS] 30 [SEP] cat [SEP]
    assert model.family(ref).positions(ref, cfg["data"]) == 34
    pages = work.pages(65238, 512)
    assert len(pages) == 128 and pages[-1] == 214
    calls = kind.attention_calls(cfg, tr)
    assert len(calls) == 128 * 12
    assert calls[0] == (171, 102) and calls[-1] == (72, 102)
    assert sorted(set(calls)) == [(72, 102), (171, 102)]
    assert len(kind.pool_calls(cfg, tr)) == 128 + 98
    assert work.test_rows(cfg) == sum(
        2 + (i * 71) // 73152 for i in range(73152))
    cfg, tr, kind = _files("naml.train")
    assert kind.pool_calls(cfg, tr) == [(65238, 31), (16384, 50)]


def test_flops_by_hand():
    cfg, tr, kind = _files("bert-naml.eval")
    positions = (127 * 171 + 72) * 102 * 12
    per_token = 2.0 * (4 * 768 * 768 + 2 * 768 * 3072)
    want = (positions * per_token + 12 * 2 * 2.0 * 768 * 32 * 768
            + 2.0 * 65238 * 34 * 768 * 64 + 2.0 * work.test_rows(cfg) * 64)
    assert kind.gemm_flops(cfg, tr) == pytest.approx(want)
    assert kind.gemm_flops(cfg, tr) == pytest.approx(3.7775e14, rel=1e-3)
    L, pool = 34, 2.0 * 34 * (64 * 256 + 256 + 64)
    item = 12 * (L * per_token + 4.0 * L * L * 768) + 2.0 * L * 768 * 64 \
        + pool
    want = (65238 * item + 2.0 * 50000 * 50 * (64 * 256 + 256 + 64)
            + 2.0 * work.test_rows(cfg) * 64)
    assert kind.model_flops(cfg, tr) == pytest.approx(want)
    cfg, tr, kind = _files("naml.train")
    item = (2.0 * 30 * 64 * 64 * 3 + 2.0 * 64 * 64
            + 2.0 * 31 * (64 * 256 + 256 + 64))
    user = 2.0 * 16384 * 50 * (64 * 256 + 256 + 64)
    want = 3 * (65238 * item + user + 2.0 * 16384 * 5 * 64)
    assert kind.model_flops(cfg, tr) == pytest.approx(want)


class _Trace:
    busy_s, window_s = 0.4, 0.9


class _Run:
    """What the readers read of a traced run: 2 profiled units, 0.4 s
    busy on the device between them, 0.25 s a unit unprofiled."""

    def __init__(self, workload):
        self.cfg, self.traffic, self.kind = _files(workload)
        self.trace, self.traced_units, self.unit_s = _Trace(), 2, 0.25


@pytest.mark.parametrize("workload", ["naml.train", "bert-naml.eval"])
def test_mfu_and_idle_take_the_unprofiled_unit(workload):
    """The profiler's host cost stretches the profiled window (0.9 s here
    for 2 units of 0.25 s); the readers divide by the unprofiled unit."""
    run = _Run(workload)
    flops = run.kind.model_flops(run.cfg, run.traffic)
    assert readers.mfu(run) == pytest.approx(100 * flops / 0.25 / 989e12)
    assert readers.idle_share(run) == pytest.approx(100 * (1 - 0.2 / 0.25))
    run.unit_s = None
    assert readers.mfu(run) is None and readers.idle_share(run) is None


@pytest.mark.parametrize("name,ulp", [("bf16", 2.0 ** -8),
                                      ("tf32", 2.0 ** -11),
                                      ("fp8", 2.0 ** -4)])
def test_control_casts_round_to_their_format(name, ulp):
    import torch

    g = torch.Generator().manual_seed(5)
    # magnitudes in [0.5, 8): normal numbers in every format, fp8's scale
    # too
    x = (torch.rand(4096, generator=g) * 7.5 + 0.5) * torch.where(
        torch.rand(4096, generator=g) < 0.5, -1.0, 1.0)
    x.requires_grad_(True)
    y = CASTS[name](x)
    rel = ((y - x).abs() / x.abs()).max().item()
    assert 0 < rel <= ulp * 1.0001
    g = torch.autograd.grad(y.sum(), x)[0]
    assert torch.isfinite(g).all()
