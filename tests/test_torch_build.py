"""The port's kernel build rule and the names its smoke run profiles, on
the CPU (nothing is compiled here): a library is stale when its source or
any csrc/ header it includes is newer; every device-side name that
chip_smoke.py matches in a profile is a kernel of its source, and no name
is part of another; which pool kernel takes which dtype and widths; the
attention pages and pool shapes chip_smoke.py and the A/B timer share;
the pool's and the keep mask's bounds chip_smoke.py reports.
"""
import os
import re
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from legommenders_tpu_torch.ops import additive, build  # noqa: E402


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
    names = [os.path.basename(p) for p in build.sources("additive_pool")]
    assert names == ["additive_pool.cu", "hopper.cuh"]


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
    # the kernels the main paths launch are the tensor-core ones
    assert chip_smoke.MAIN_POOL_KERNEL == additive.TC_KERNEL
    assert set(chip_smoke.KERNEL_NAMES["additive_pool"]) == {
        additive.TC_KERNEL, additive.SIMT_KERNEL}
    assert "attention_fwd_tc" in chip_smoke.KERNEL_NAMES["packed_attention"]
    assert "attention_bwd_tc" in \
        chip_smoke.KERNEL_NAMES["packed_attention_backward"]


@pytest.mark.parametrize("page,T", [("ATTN_PAGE", 102), ("TRAIN_PAGE", 120)])
def test_attention_pages_are_block_diagonal(page, T):
    """chip_smoke's attention inputs (also what tools/time_kernels.py
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
    import time_kernels

    assert time_kernels.chip_smoke is chip_smoke
    for own_copy in ("HEAD_START_CYCLES", "pool_inputs", "attention_inputs",
                     "time_ms", "POOLS"):
        assert not hasattr(time_kernels, own_copy)


# every (L, D, H) a main path pools at: NAML items (31), bert-naml items
# serving (34) and training (40, the cache's padded length), users (50)
MAIN_POOL_SHAPES = [(L, chip_smoke.D, chip_smoke.H) for L in chip_smoke.PAGE_LS]


@pytest.mark.parametrize("L,D,H", MAIN_POOL_SHAPES)
def test_main_path_pools_take_the_tensor_core_kernel(L, D, H):
    kernel, G = additive.pool_kernel(torch.bfloat16, L, D, H)
    assert kernel == additive.TC_KERNEL
    assert G == 128 // L and G * L <= 128 < (G + 1) * L
    assert {31: 4, 34: 3, 40: 3, 50: 2}[L] == G


@pytest.mark.parametrize("dtype,L,D,H,G", [
    (torch.bfloat16, 128, 64, 256, 1), (torch.bfloat16, 1, 64, 64, 128),
    (torch.bfloat16, 65, 64, 128, 1), (torch.bfloat16, 13, 64, 192, 9)])
def test_tensor_core_kernel_takes_whole_items_per_tile(dtype, L, D, H, G):
    assert additive.pool_kernel(dtype, L, D, H) == (additive.TC_KERNEL, G)


@pytest.mark.parametrize("dtype,L,D,H", [
    (torch.float32, 31, 64, 256),     # f32: its 1e-5 gate
    (torch.float32, 50, 64, 256),
    (torch.bfloat16, 13, 16, 32),     # D other than 64
    (torch.bfloat16, 1, 8, 300),      # D 8, H not a multiple of 64
    (torch.bfloat16, 31, 64, 96),     # H not a multiple of 64
    (torch.bfloat16, 31, 64, 320),    # H above 256
    (torch.bfloat16, 129, 64, 256),   # L above one tile
    (torch.bfloat16, 31, 128, 256),   # D 128
    (torch.float16, 31, 64, 256)])    # a dtype the tensor-core kernel lacks
def test_other_pools_take_the_cuda_core_kernel(dtype, L, D, H):
    assert additive.pool_kernel(dtype, L, D, H) == (additive.SIMT_KERNEL, 1)


def test_pool_timer_times_the_smoke_runs_pool_shapes():
    """tools/time_kernels.py times the full catalog, the user pool and one
    page at each main-path L, with chip_smoke.pool_inputs (here on the
    CPU, through the plain version, at a cut catalog)."""
    sys.path.insert(0, os.path.join(ROOT, "legommenders_tpu_torch", "tools"))
    import time_kernels
    from unittest import mock

    with mock.patch.object(chip_smoke, "POOLS", {"item": (9, 31),
                                                 "user": (5, 50)}), \
            mock.patch.object(chip_smoke, "PAGE_N", 3):
        cases = time_kernels.pool_cases(torch, "cpu")
    names = [name for name, _, _ in cases]
    assert names == ["pool item", "pool user", "pool page L31",
                     "pool page L34", "pool page L40", "pool page L50"]
    shapes = [tuple(fn.args[0].shape) for _, fn, _ in cases]
    assert shapes == [(9, 31, 64), (5, 50, 64), (3, 31, 64), (3, 34, 64),
                      (3, 40, 64), (3, 50, 64)]
    for _, fn, _ in cases:
        out = fn()
        assert out.dtype == torch.bfloat16 and out.shape[1] == 64


@pytest.mark.parametrize("N,L,dtype,by", [
    (65000, 31, "bf16", "tanh"), (20000, 50, "bf16", "tanh"),
    (512, 31, "bf16", "tanh"), (65000, 31, "f32", "flops")])
def test_pool_bound_is_the_longest_of_bytes_products_and_tanh(N, L, dtype,
                                                               by):
    """At bf16 the N*L*H tanh on the special-function units take longer
    than the bytes and the products; at f32 the products on the CUDA cores
    take longest."""
    D, H = chip_smoke.D, chip_smoke.H
    flops_ms, _ = chip_smoke.roof(2.0 * N * L * (D * H + H + D), 0, dtype)
    tanh_ms = N * L * H / chip_smoke.TANH_PER_S * 1e3
    ms, bound_by = chip_smoke.bound(N, L, dtype)
    assert bound_by == "operations"
    assert ms == pytest.approx({"tanh": tanh_ms, "flops": flops_ms}[by])
    assert ms >= max(tanh_ms, flops_ms)


@pytest.mark.parametrize("T", [1, 7, 8, 9, 16, 17, 102, 120, 128])
def test_philox_draws_cover_the_mask_once(T):
    """philox_draws counts the draws whose four words cover every (i, j)
    of a T x T mask, as dropout_mask's loop makes them."""
    seen = {}
    for i in range(T):
        if i & 8:
            continue
        for j in range(0, T, 2):
            for e in ((i, j), (i, j + 1), (i + 8, j), (i + 8, j + 1)):
                if e[0] < T and e[1] < T:
                    seen[e] = seen.get(e, 0) + 1
    assert chip_smoke.philox_draws(T) == sum(
        1 for i in range(T) if not i & 8) * len(range(0, T, 2))
    assert len(seen) == T * T and set(seen.values()) == {1}


def test_mask_bound_counts_the_philox_work():
    """The training page's mask: 7,879,680 draws of 24 integer-ALU
    operations each outlast its 2.95 MB of bytes."""
    B, heads, T = 171, 12, 120
    assert B * heads * chip_smoke.philox_draws(T) == 7_879_680
    ms, by = chip_smoke.mask_bound(B, heads, T)
    assert by == "operations"
    assert ms == pytest.approx(7_879_680 * 24 / chip_smoke.INT_PER_S * 1e3)
    assert ms > B * heads * T * T / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_sass_count_takes_the_kernels_last_loop():
    """tools/sass_count.py: the first function whose name holds the
    kernel's, the body of its last backward branch, counted by opcode and
    by pipe (the trailing self-branch is no loop)."""
    sys.path.insert(0, os.path.join(ROOT, "legommenders_tpu_torch", "tools"))
    import sass_count

    sass = """
        Function : _ZN5other12dropout_maskXv
        /*0000*/   IMAD R1, R2, R3, RZ ;
        /*0010*/   @!P0 BRA 0x0 ;
        Function : _ZN4anon12dropout_maskEPKiPhiij
        /*0000*/   LDC R1, c[0x0][0x28] ;
        /*0010*/   IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ ;
        /*0020*/   LOP3.LUT R4, R4, 0x1, RZ, 0xc0, !PT ;
        /*0030*/   @P1 STG.E.U8 desc[UR4][R2.64], R4 ;
        /*0040*/   @!P0 BRA 0x10 ;
        /*0050*/   EXIT ;
        /*0060*/   BRA 0x60;
        Function : _Z4nextv
        /*0000*/   IADD3 R1, R1, 0x1, RZ ;
    """
    insts = sass_count.instructions(sass, "dropout_maskEP")
    assert [a for a, _ in insts] == [0, 0x10, 0x20, 0x30, 0x40, 0x50, 0x60]
    got = sass_count.count(sass_count.loop_body(insts))
    assert got == {"range": ["0x10", "0x40"], "instructions": 4,
                   "by_pipe": {"fma": 1, "alu": 1, "other": 2},
                   "by_opcode": {"IMAD": 1, "LOP3": 1, "STG": 1, "BRA": 1}}
