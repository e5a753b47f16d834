"""The port's kernel build rule and the names its smoke run profiles, on
the CPU (nothing is compiled here): a library is stale when its source or
any csrc/ header it includes is newer; every device-side name that
chip_smoke.py matches in a profile is a kernel of its source, and no name
is part of another; which pool kernel takes which dtype and widths; the
attention pages and pool shapes chip_smoke.py and the A/B timer share;
the pool's and the keep mask's bounds chip_smoke.py reports; the keep-mask
kernel's work map; the SASS and integer-rate tools' counting.
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
        additive.TC_KERNEL, additive.SIMT_KERNEL, additive.LONG_KERNEL}
    assert chip_smoke.LONG_POOL_KERNEL == additive.LONG_KERNEL
    assert "attention_fwd_tc" in chip_smoke.KERNEL_NAMES["packed_attention"]
    assert "attention_bwd_tc" in \
        chip_smoke.KERNEL_NAMES["packed_attention_backward"]
    # and the f32 route's (3xTF32)
    assert "attention_fwd_tf32" in chip_smoke.KERNEL_NAMES["packed_attention"]
    assert "attention_bwd_tf32" in \
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
                     "time_ms", "POOLS", "mask_shape", "TRAIN_DROPOUT"):
        assert not hasattr(time_kernels, own_copy)
    # the mask set times the training page's mask and a ragged T
    assert "mask" in time_kernels.KERNELS
    assert [chip_smoke.mask_shape(p)[2] % 8 for p in
            (chip_smoke.TRAIN_PAGE, chip_smoke.ATTN_PAGE)] == [0, 6]


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
    # past one tile, the CUDA-core kernel that streams long sequences
    want = (additive.LONG_KERNEL if L > additive.TC_TILE_ROWS
            else additive.SIMT_KERNEL)
    assert additive.pool_kernel(dtype, L, D, H) == (want, 1)


@pytest.mark.parametrize("dtype,L,D,H", [
    (torch.float32, 129, 64, 256), (torch.bfloat16, 495, 64, 64),
    (torch.float32, 1023, 64, 64), (torch.bfloat16, 1023, 768, 256)])
def test_long_pools_take_the_long_kernel(dtype, L, D, H):
    """Every L > 128, of either dtype and any width: the flattened
    histories (495, 1,023) and one past a tile."""
    assert additive.pool_kernel(dtype, L, D, H) == (additive.LONG_KERNEL, 1)


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


def test_pool_timer_times_the_long_and_f32_sets():
    """tools/time_kernels.py's `long` set times the four flatten user pools
    in bf16 and f32, its `pool_f32` set the f32 pool at chip_smoke's
    catalog, user, CTR, semantic and phase-16 shapes, each with
    chip_smoke.bound's bound (here on the CPU, through the plain version,
    at cut sizes)."""
    sys.path.insert(0, os.path.join(ROOT, "legommenders_tpu_torch", "tools"))
    import time_kernels
    from unittest import mock

    assert {"long", "pool_f32"} <= set(time_kernels.KERNELS)
    bounds = {}
    with mock.patch.object(chip_smoke, "FLATTEN_MODELS", {
            "flatten_transformer": (31, 2, 3),
            "flatten_fastformer": (15, 4, 5)}):
        long = time_kernels.long_cases(torch, "cpu", bounds)
    assert [tuple(fn.args[0].shape) + (fn.args[0].dtype,)
            for _, fn, _ in long] == [
        (n, L, 64, dt) for L, ns in ((1023, (2, 3)), (495, (4, 5)))
        for n in ns for dt in (torch.bfloat16, torch.float32)]
    with mock.patch.object(chip_smoke, "POOLS", {"item": (9, 31),
                                                 "user": (5, 50)}), \
            mock.patch.object(chip_smoke, "CTR_POOLS", {"c": (3, 64)}), \
            mock.patch.object(chip_smoke, "SEMANTIC_POOLS",
                              {"s": (7, 4, 256)}), \
            mock.patch.object(chip_smoke, "P16_POOLS", {"p": (4, 9, 16)}):
        f32 = time_kernels.pool_f32_cases(torch, "cpu", bounds)
    assert [(name, tuple(fn.args[0].shape), fn.args[2].shape[1])
            for name, fn, _ in f32] == [
        ("f32 item", (9, 31, 64), 256), ("f32 user", (5, 50, 64), 256),
        ("f32 c", (3, 50, 64), 64), ("f32 s", (7, 4, 64), 256),
        ("f32 p", (4, 9, 16), 256)]
    for name, fn, _ in long + f32:
        out = fn()
        assert out.shape == fn.args[0].shape[::2]
        assert bounds[name] == pytest.approx(1e3 * chip_smoke.bound(
            out.shape[0], fn.args[0].shape[1],
            "bf16" if out.dtype == torch.bfloat16 else "f32",
            fn.args[2].shape[1], out.shape[1])[0])


@pytest.mark.parametrize("N,L", [(1, 129), (7, 300), (600, 257), (37, 13)])
def test_pool_edge_inputs_mask_the_tile_edges(N, L):
    """chip_smoke.pool_edge_inputs, which the card checks of the tile
    kernels pool: item 0 all masked (where N > 1), item 1 valid only in
    its last tile of 128 positions, item 2's second tile all masked, and
    every case of pool_edge_cases a multiple of 4 wide."""
    x, mask, w1, b1, w2 = chip_smoke.pool_edge_inputs(N, L, torch.float32,
                                                      "cpu", 3, 33, 20)
    assert x.shape == (N, L, 20) and w1.shape == (20, 33)
    valid = mask > 0
    last = (L - 1) // 128 * 128
    if N > 1:
        assert not valid[0].any()
    else:
        assert valid[0].any()
    if N > 2:
        assert not valid[1, :last].any() and valid[1, last]
    if N > 3 and L > 128:
        assert not valid[2, 128:256].any()
    assert all(d % 4 == 0 for _, _, d, _ in chip_smoke.pool_edge_cases())


@pytest.mark.parametrize("N,L,dtype,by", [
    (65000, 31, "bf16", "tanh"), (20000, 50, "bf16", "tanh"),
    (512, 31, "bf16", "tanh"), (65000, 31, "f32", "flops")])
def test_pool_bound_is_the_longest_of_bytes_products_and_tanh(N, L, dtype,
                                                               by):
    """At bf16 the N*L*H tanh on the special-function units take longer
    than the bytes and the products; at f32 the products, counted on the
    tensor cores in 3xTF32 (165 TFLOP/s), take longest."""
    D, H = chip_smoke.D, chip_smoke.H
    flops_ms, _ = chip_smoke.roof(2.0 * N * L * (D * H + H + D), 0,
                                  chip_smoke.product_peak(dtype))
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


@pytest.mark.parametrize("T", [1, 7, 8, 9, 16, 17, 102, 120, 127, 128, 129,
                               200, 2049])
def test_mask_work_map_covers_the_mask_once(T):
    """dropout_mask's thread -> work map (chip_smoke.mask_units: a column
    block per thread, rows by shifts and masks) covers every (i, j) of a
    T x T mask exactly once, through the four words of each draw it keeps;
    its draws past T are only those of the last block's columns; every
    store of W bytes starts on W in the (B, H, T, T) array and lies inside
    its row; with fewer column blocks than threads, a thread keeps one."""
    D = chip_smoke.MASK_DRAWS
    n_cb, n_gi, W = chip_smoke.mask_layout(T)
    assert n_cb == -(-T // (2 * D)) and W in (1, 8)
    assert n_gi == sum(1 for i in range(T) if not i & 8)
    seen, draws, blocks = {}, 0, {}
    rows = set(range(T)) if T <= 200 else {0, 7, 16, T - 1}
    for t, i0, j0, nv in chip_smoke.mask_units(T):
        assert not i0 & 8 and i0 < T and j0 % (2 * D) == 0
        assert 0 < nv <= 2 * D and j0 + nv <= T
        blocks.setdefault(t, set()).add(j0)
        if W == 8:
            assert nv == 8
        for row in (i0, i0 + 8):
            start = T * T + row * T + j0  # the next item's, so the base too
            assert row >= T or start % W == 0
        for d in range(D):
            j = j0 + 2 * d
            draws += j < T
            for e in ((i0, j), (i0, j + 1), (i0 + 8, j), (i0 + 8, j + 1)):
                if e[0] < T and e[1] < T and (e[0] in rows or T <= 200):
                    assert j0 <= e[1] < j0 + nv
                    seen[e] = seen.get(e, 0) + 1
    assert len(seen) == len(rows) * T and set(seen.values()) == {1}
    assert draws == chip_smoke.philox_draws(T)
    if n_cb < chip_smoke.MASK_THREADS:
        assert all(len(js) == 1 for js in blocks.values())


def test_mask_mirror_takes_the_sources_unit():
    """chip_smoke's mirror of the work map takes the kernel's draws per
    unit and threads per CTA (kMaskDraws, kMaskThreads in
    csrc/packed_attention.cu)."""
    with open(build.source("packed_attention")) as f:
        src = f.read()
    draws = re.search(r"constexpr int kMaskDraws = (\d+);", src)
    threads = re.search(r"constexpr int kMaskThreads = (\d+);", src)
    assert draws and int(draws.group(1)) == chip_smoke.MASK_DRAWS
    assert threads and int(threads.group(1)) == chip_smoke.MASK_THREADS


def _philox_words_read(rnd: int):
    """For round rnd of Philox4x32-10 at counter (jp, i, h, b) and key
    (seed, 0): the counter words that each of its two product inputs and
    each of its two XOR outputs holds, found by changing one word at a
    time over a small grid."""
    import itertools as it
    import torch
    from legommenders_tpu_torch.ops.attention import (
        _PHILOX_M, _PHILOX_W, _U32, _mulhilo,
    )

    grid = {"jp": [0, 1, 59], "i": [0, 7, 119], "h": [0, 5, 11],
            "b": [0, 2, 170]}
    names = list(grid)
    combos = list(it.product(*grid.values()))
    c = [torch.tensor([x[k] for x in combos], dtype=torch.int64)
         for k in range(4)]
    k0, k1 = 20231, 0
    for _ in range(rnd):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
    hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
    values = (c[0], c[2], hi1 ^ c[1] ^ k0, hi0 ^ c[3] ^ k1)

    def words(v):
        table = dict(zip(combos, v.tolist()))
        held = set()
        for x in combos:
            for k, name in enumerate(names):
                for other in grid[name]:
                    y = x[:k] + (other,) + x[k + 1:]
                    if table[y] != table[x]:
                        held.add(name)
        return held

    return [words(v) for v in values]


@pytest.mark.parametrize("rnd", range(10))
def test_philox_terms_hold_the_words_the_bound_counts(rnd):
    """chip_smoke.PHILOX_PRODUCT_WORDS / PHILOX_XOR_WORDS, from which the
    mask's bound counts each product and XOR once per distinct value of
    its counter words, are the words each really holds."""
    x_in, z_in, x_out, z_out = _philox_words_read(rnd)
    assert [x_in, z_in] == [set(w) for w in
                            chip_smoke.PHILOX_PRODUCT_WORDS[rnd]]
    assert [x_out, z_out] == [set(w) for w in
                              chip_smoke.PHILOX_XOR_WORDS[rnd]]


def test_mask_bound_counts_the_philox_work():
    """The training page's mask (chip_smoke.mask_shape): 7,879,680 draws,
    each 14 products and 16 XORs that hold all of (jp, i, h, b) plus the
    terms of rounds 0-2 that hold fewer, and 14,400 compares an item; at
    the measured rates the products outlast the ALU's work and the 2.95 MB
    of bytes."""
    B, heads, T = chip_smoke.mask_shape(chip_smoke.TRAIN_PAGE)
    assert (B, heads, T) == (171, 12, 120)
    assert chip_smoke.mask_shape(chip_smoke.ATTN_PAGE) == (171, 12, 102)
    draws = B * heads * chip_smoke.philox_draws(T)
    assert draws == 7_879_680
    R, J = 64, 60
    products, xors = chip_smoke.philox_ops(B, heads, T)
    assert products == (14 * draws + B * heads * J + heads * R * J
                        + heads * R + B * J + J + heads)
    assert xors == (16 * draws + B * heads * J + heads * R * J
                    + heads * R + B * J)
    ms, by = chip_smoke.mask_bound(B, heads, T)
    assert by == "operations"
    clocks = chip_smoke.SMS * chip_smoke.SM_HZ
    alu = (xors + B * heads * T * T) / (chip_smoke.ALU_PER_CLK * clocks)
    fma = products / (chip_smoke.IMAD_WIDE_PER_CLK * clocks)
    assert fma > alu
    assert ms == pytest.approx(fma * 1e3)
    assert ms == pytest.approx(0.013211640553)
    assert ms > B * heads * T * T / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_sass_count_takes_the_kernels_last_loop():
    """tools/sass_count.py: the first function whose name holds the
    kernel's, the body of its last innermost loop (a backward branch whose
    range holds no other; the trailing self-branch is no loop), counted by
    opcode, by IMAD form, by pipe, per draw, with the opcodes of a division
    sequence apart."""
    sys.path.insert(0, os.path.join(ROOT, "legommenders_tpu_torch", "tools"))
    import sass_count

    sass = """
        Function : _ZN5other12dropout_maskXv
        /*0000*/   IMAD R1, R2, R3, RZ ;
        /*0010*/   @!P0 BRA 0x0 ;
        Function : _ZN4anon12dropout_maskILi8EEvPKiPhiiiiij
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
    insts = sass_count.instructions(sass, "dropout_maskILi8E")
    assert [a for a, _ in insts] == [0, 0x10, 0x20, 0x30, 0x40, 0x50, 0x60]
    got = sass_count.count(sass_count.loop_body(insts))
    assert got == {"range": ["0x10", "0x40"], "instructions": 4, "draws": 1,
                   "per_draw": 4.0,
                   "by_pipe": {"fma": 1, "alu": 1, "other": 2},
                   "by_opcode": {"IMAD": 1, "LOP3": 1, "STG": 1, "BRA": 1},
                   "imad_forms": {"IMAD.WIDE.U32": 1}, "division": {}}
    # an outer loop (items) around an inner one (units of 4 draws, with a
    # division sequence): the inner one is counted, per draw
    nested = """
        Function : _Z12dropout_maskv
        /*0000*/   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/   I2F.U32.RP R5, R6 ;
        /*0020*/   MUFU.RCP R5, R5 ;
        /*0030*/   IMAD.HI.U32 R2, R3, R4, RZ ;
        /*0040*/   @!P0 BRA 0x10 ;
        /*0050*/   IADD3 R1, R1, 0x1, RZ ;
        /*0060*/   @!P1 BRA 0x0 ;
        /*0070*/   EXIT ;
    """
    got = sass_count.count(sass_count.loop_body(
        sass_count.instructions(nested, "dropout_mask")), draws=4)
    assert got["range"] == ["0x10", "0x40"] and got["per_draw"] == 1.0
    assert got["division"] == {"I2F": 1, "MUFU": 1}
    assert got["imad_forms"] == {"IMAD.HI.U32": 1}


def test_int_rates_count_each_kernels_loop_by_kind():
    """tools/int_rates.py counts, in each int_rate<op>'s loop, the
    instructions of the op's kind (IMAD.WIDE for op 0, LOP3 and ISETP for
    op 4, IMAD and LOP3 but not IMAD.WIDE for op 6) beside all of the
    loop's."""
    sys.path.insert(0, os.path.join(ROOT, "legommenders_tpu_torch", "tools"))
    import int_rates

    sass = """
        Function : _ZN48_GLOBAL__N__int_rates8int_rateILi0EEEvPKjPjiPx
        /*0000*/   CS2R R4, SR_CLOCKLO ;
        /*0010*/   IMAD.WIDE.U32 R2, R3, R6, R8 ;
        /*0020*/   IMAD.WIDE.U32 R8, R9, R2, R4 ;
        /*0030*/   IADD3 R1, R1, 0x1, RZ ;
        /*0040*/   @P0 BRA 0x10 ;
        Function : _ZN48_GLOBAL__N__int_rates8int_rateILi4EEEvPKjPjiPx
        /*0000*/   LOP3.LUT R2, R3, R4, R5, 0x96, !PT ;
        /*0010*/   ISETP.GE.U32.AND P1, PT, R2, R4, P1 ;
        /*0020*/   SEL R6, RZ, 0x1, !P1 ;
        /*0030*/   @P0 BRA 0x0 ;
        Function : _ZN48_GLOBAL__N__int_rates8int_rateILi6EEEvPKjPjiPx
        /*0000*/   IMAD R2, R3, R4, R5 ;
        /*0010*/   LOP3.LUT R2, R2, R4, R5, 0x96, !PT ;
        /*0020*/   IMAD.WIDE.U32 R6, R3, R4, RZ ;
        /*0030*/   @P0 BRA 0x0 ;
    """
    assert int_rates.loop_counts(sass, 0) == (2, 4)
    assert int_rates.loop_counts(sass, 4) == (2, 4)
    assert int_rates.loop_counts(sass, 6) == (2, 4)
    assert set(name for name, _ in int_rates.OPS.values()) == {
        "imad_wide", "imad_hi", "imad", "lop3", "lop3_isetp", "philox_mix",
        "imad_lop3", "philox_mix_2"}


class _Event:
    """A raw trace event as `trace_records` reads it."""

    def __init__(self, name, corr, device, start=0, end=0):
        self._name, self._corr, self._device = name, corr, device
        self._span = start, end

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._span[0]

    def end_ns(self):
        return self._span[1]


def test_trace_records_tie_lost_launch_calls_to_their_wrappers():
    """A launch call (runtime or driver API) whose correlation id no device
    record carries is a record the tracer lost; one inside a port
    wrapper's launch range is that wrapper's; the range's own record on
    the device is not a kernel's. torch's own ops and other runtime calls
    are not launches."""
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [_Event("aten::mm", 1, cpu, 0, 50),
              _Event("additive_pool", 3, cpu, 100, 200),
              _Event("cudaLaunchKernel", 7, cpu, 120, 130),
              _Event("additive_pool_tc<8>", 7, gpu),
              _Event("additive_pool", 4, cpu, 300, 400),
              _Event("additive_pool", 11, gpu),
              _Event("cudaLaunchKernel", 11, cpu, 310, 320),
              _Event("cudaLaunchKernelExC", 8, cpu, 10, 20),
              _Event("gemm", 8, gpu),
              _Event("cuLaunchKernel", 9, cpu, 500, 510),
              _Event("packed_attention", 5, cpu, 600, 700),
              _Event("cudaMemcpyAsync", 10, cpu, 610, 620),
              _Event("aten::add", 2, cpu, 800, 900)]
    got = chip_smoke.trace_records(events)
    assert (got["launch_calls"], got["device_records"], got["lost"]) == (
        4, 2, 2)
    assert got["calls_by_wrapper"] == {
        "additive_pool": 2, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    assert got["lost_by_wrapper"] == {
        "additive_pool": 1, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}


@pytest.mark.parametrize("listed,counted,lost,outcome", [
    ((2, 1), (2, 1), (0, 0), 0),
    ((1, 1), (2, 1), (1, 0), 1),
    ((1, 0), (2, 1), (2, 1), 2),
    ((1, 1), (2, 1), (0, 1), RuntimeError),
    ((0, 1), (2, 1), (1, 0), RuntimeError),
    ((3, 1), (2, 1), (0, 0), RuntimeError),
])
def test_profiled_launches_differ_only_by_records_the_tracer_lost(
        listed, counted, lost, outcome):
    """A port kernel's profiled launches may fall short of its wrapper's
    count only by launch calls inside that wrapper's ranges whose device
    record the trace lacks; a shortfall the trace does not show there, or
    more profiled launches than counted, raises."""
    names = ("additive_pool", "packed_attention")
    trace = {"launch_calls": 9, "device_records": 9 - sum(lost),
             "lost": sum(lost) + 1, "calls_by_wrapper": dict(zip(names,
                                                                 counted)),
             "lost_by_wrapper": dict(zip(names, lost))}
    listed, counted = dict(zip(names, listed)), dict(zip(names, counted))
    if outcome is RuntimeError:
        with pytest.raises(RuntimeError, match="launch calls"):
            chip_smoke.check_profiled_launches(listed, counted, trace)
    else:
        assert chip_smoke.check_profiled_launches(listed, counted,
                                                  trace) == outcome
