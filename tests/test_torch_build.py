"""The port's kernel build rule and the names its smoke run profiles, on
the CPU (nothing is compiled here): a library is stale when its source or
any csrc/ header it includes is newer; every device-side name that
chip_smoke.py matches in a profile is a kernel of its source, and no name
is part of another; the attention pages chip_smoke.py and the A/B timer
share.
"""
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from legommenders_tpu_torch.ops import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ and _build/ of their own: a.cu includes a.cuh, which includes
    b.cuh (and itself, and a system header)."""
    src, out = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    out.mkdir()
    (src / "a.cu").write_text('#include <cstdint>\n#include "a.cuh"\n')
    (src / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n'
                               '#include "a.cuh"\n')
    (src / "b.cuh").write_text("// leaf\n")
    (src / "c.cu").write_text("// no includes\n")
    monkeypatch.setattr(build, "CSRC", str(src))
    monkeypatch.setattr(build, "BUILD", str(out))
    return src, out


def test_sources_follow_includes_through_headers(csrc):
    src, _ = csrc
    got = [os.path.basename(p) for p in build.sources("a")]
    assert got == ["a.cu", "a.cuh", "b.cuh"]
    assert [os.path.basename(p) for p in build.sources("c")] == ["c.cu"]


@pytest.mark.parametrize("touched,stale", [(None, False), ("a.cu", True),
                                           ("a.cuh", True), ("b.cuh", True),
                                           ("c.cu", False)])
def test_library_is_stale_when_any_source_is_newer(csrc, touched, stale):
    src, out = csrc
    lib = out / "liba.so"
    lib.write_bytes(b"")
    for f in src.iterdir():
        os.utime(f, (1000, 1000))
    os.utime(lib, (2000, 2000))
    if touched:
        os.utime(src / touched, (3000, 3000))
    assert build._stale("a") is stale


def test_missing_library_is_stale(csrc):
    assert build._stale("a")


def test_port_sources_include_the_hopper_header():
    names = [os.path.basename(p) for p in build.sources("packed_attention")]
    assert names == ["packed_attention.cu", "hopper.cuh"]


def _kernels(name):
    """Names of the __global__ functions of csrc/<name>.cu (the name starts
    the line after the declaration's first)."""
    with open(build.source(name)) as f:
        return set(re.findall(r"__global__ void[^\n]*\n([A-Za-z_]\w*)\(",
                              f.read()))


def test_profiled_names_are_kernels_of_the_sources():
    defined = _kernels("packed_attention") | _kernels("additive_pool")
    names = [n for ns in chip_smoke.KERNEL_NAMES.values() for n in ns]
    assert set(names) <= defined, set(names) - defined
    for a in names:
        for b in names:
            assert a == b or a not in b, (a, b)
    # the attention kernels the main paths launch are the tensor-core ones
    assert "attention_fwd_tc" in chip_smoke.KERNEL_NAMES["packed_attention"]
    assert "attention_bwd_tc" in \
        chip_smoke.KERNEL_NAMES["packed_attention_backward"]


@pytest.mark.parametrize("page,T", [("ATTN_PAGE", 102), ("TRAIN_PAGE", 120)])
def test_attention_pages_are_block_diagonal(page, T):
    """chip_smoke's attention inputs (also what tools/time_attention.py
    times): 171 rows of 3 items, each token seeing only the valid keys of
    its own item, at least 19 of them (the one pad item that fills the
    last row, 1)."""
    import torch

    cfg = getattr(chip_smoke, page)
    q, k, v, bias = chip_smoke.attention_inputs(torch.bfloat16, "cpu", 7,
                                                page=cfg)
    assert q.shape == k.shape == v.shape == (171, T, 768)
    assert bias.shape == (171, T, T) and bias.dtype == torch.bfloat16
    blk = torch.arange(T) // cfg["L"]
    seen = bias == 0
    assert not (seen & (blk[:, None] != blk[None, :])).any()
    assert (seen[:170].sum(-1) >= 19).all()
    assert (seen[170].sum(-1) >= 1).all()


def test_attention_timer_uses_the_smoke_runs_inputs_and_timer():
    sys.path.insert(0, os.path.join(ROOT, "legommenders_tpu_torch", "tools"))
    import time_attention

    assert time_attention.chip_smoke is chip_smoke
    assert not hasattr(time_attention, "HEAD_START_CYCLES")
