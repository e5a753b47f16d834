#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (legommenders_tpu_torch) on one card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card and nvcc (on PATH, or under CUDA_HOME), imports nothing of JAX,
and exits non-zero when any phase fails:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for the parity phases;
  2. build: compiles csrc/additive_pool.cu and csrc/packed_attention.cu
     with nvcc, one process each, both at once, and prints the build
     seconds and ptxas' register/spill report;
  3. kernels vs plain versions, each at the shapes its main path gives it,
     in f32 (within 1e-5 absolute) and bf16 (within 2e-2 of the largest
     output of the plain version computed from the same bf16 inputs),
     timed with CUDA events beside the card's least possible time (bound):
     - the additive pool at both NAML widths (item pool 65,000 x 31 x 64,
       user pool 20,000 x 50 x 64, H = 256) with partly and fully masked
       rows; all-masked rows must give exactly 0;
     - the packed attention at bert-naml's page shape (171 packed rows of
       3 items x 34 tokens = 102, D = 768, 12 heads), with the block-
       diagonal biases packed_mask_bias makes from random title lengths;
       torch's scaled_dot_product_attention is timed beside it as the
       yardstick (library_ms) and is never called by the port;
  4. main paths, each through Manager + Tester.test() at full width on one
     synthetic MIND-small-geometry fixture (65,000 items, 20,000 users,
     title 30, history 50, vocab 30,000), random weights from seed 0, bf16;
     every launch count is set to 0 just before a path and read just after:
     - NAML (CNN / Ada / Dot, hidden 64): the pool launches once per item
       page + user page, the attention never;
     - bert-naml (BertBase / Ada / Dot, item-bert.yaml's defaults: 12
       layers, d 768, 12 heads, LoRA r 32 folded, fused attention, tanh
       gelu, [CLS] title [SEP] category [SEP] compacted, pages of 512): the
       attention launches 12 times per item page, the pool once per item
       page + user page.
     The first 2,048 item and user reprs are held against the same model
     with every kernel patched out for its plain version, on the card, and
     the device metrics against the numpy MetricPool on the same scores.
     One more warm pass of each runs under torch.profiler for device time
     by kernel (each kernel's time at the main path's shapes included)
     and the device's idle share;
  5. prints one JSON line of kernels, the card line, and
     {"ok": true, "device": {...}} as the last line.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# NVIDIA H100 SXM data-sheet peaks (dense)
PEAK = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12

D, H = 64, 256
POOLS = {"item": (65000, 31), "user": (20000, 50)}
DATA_KW = dict(num_items=65000, num_users=20000, title_len=30, history_len=50,
               vocab_size=30000, inters_per_user=12)
MODEL_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 64,
               "cache_page_size": 512,
               "item_config": {"dropout": 0.1, "kernel_size": 3}},
}
# config/model/bert-naml.yaml with common/operators/item-bert.yaml's
# defaults as written (BertBase: 12 layers, 12 heads, d 768)
BERT_CFG = {
    "meta": {"item": "BertBase", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 64,
               "embedding_dim": 768, "cache_page_size": 512,
               "item_config": {
                   "lm_dtype": "bf16", "tune_from": None, "use_lora": True,
                   "lora_r": 32, "fused_attention": True,
                   "gelu_approximate": True, "lora_dropout": 0.0,
                   "lora_fold": True, "dropout_reuse": True,
                   "inputer_config": {"use_cls_token": True,
                                      "use_sep_token": True,
                                      "compact": True}}},
}
BERT_LAYERS = 12
# bert-naml's attention page: 512 items of L = 1 + 30 + 1 + 1 + 1 = 34
# tokens, packed G = 128 // 34 = 3 to a row: 171 rows of T = 102
ATTN_PAGE = dict(items=512, L=34, D=768, heads=12)
EXP_CFG = {"policy": {"dtype": "bf16"}}
F32_TOL, BF16_REL_TOL = 1e-5, 2e-2
REPR_ROWS = 2048


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def roof(flops: float, nbytes: float, dtype: str):
    """(ms, 'bytes'|'operations') the card needs at least for this work:
    the larger of the bytes over the memory rate and the operations over
    the data-sheet peak for dtype."""
    t_ops, t_bytes = flops / PEAK[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound(N: int, L: int, dtype: str):
    """The additive pool's bound: inputs read once, output written once."""
    xb = 2 if dtype == "bf16" else 4
    flops = 2.0 * N * L * (D * H + H + D)
    nbytes = N * L * D * xb + N * L * 4 + (D * H + 2 * H) * 4 + N * D * xb
    return roof(flops, nbytes, dtype)


def pool_inputs(N, L, dtype, device, seed):
    """x ~ N(0, 1); mask with random holes, every 97th row fully masked and
    every 89th fully valid; weights at the model's init scale."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(N, L, D, generator=g, device=device).to(dtype)
    mask = (torch.rand(N, L, generator=g, device=device) < 0.8).float()
    mask[::97] = 0.0
    mask[1::89] = 1.0
    w1 = torch.randn(D, H, generator=g, device=device) / math.sqrt(D)
    b1 = torch.randn(H, generator=g, device=device) * 0.1
    w2 = torch.randn(H, generator=g, device=device) / math.sqrt(H)
    return x, mask, w1, b1, w2


def check_pool(pool: str, N: int, L: int, dtype_name: str, device) -> dict:
    import torch
    from legommenders_tpu_torch.ops.additive import (
        additive_pool, additive_pool_reference,
    )

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    args = pool_inputs(N, L, dtype, device, seed=L)
    x, mask = args[0], args[1]
    with torch.inference_mode():
        got = additive_pool(*args)
        want = additive_pool_reference(x.float(), *args[1:])
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        zero_rows = mask.sum(dim=1) == 0
        res = {"pool": pool, "N": N, "L": L, "D": D, "H": H,
               "dtype": dtype_name,
               "max_abs_err": float(err.max()),
               "rel_err": float(err.max() / want.abs().max()),
               "all_masked_rows": int(zero_rows.sum()),
               "all_masked_exact_zero": bool((got[zero_rows] == 0).all()),
               "ms": time_ms(lambda: additive_pool(*args), iters=20),
               "plain_ms": time_ms(lambda: additive_pool_reference(*args),
                                   iters=5)}
    res["bound_ms"], res["bound_by"] = bound(N, L, dtype_name)
    res["bound_peak"] = f"{dtype_name} {PEAK[dtype_name] / 1e12:g} TFLOP/s"
    ok = (res["max_abs_err"] <= F32_TOL if dtype_name == "f32"
          else res["rel_err"] <= BF16_REL_TOL)
    if not (ok and res["all_masked_exact_zero"] and res["all_masked_rows"]):
        raise RuntimeError(f"additive_pool disagrees with its plain "
                           f"version: {res}")
    return res


def attention_inputs(dtype, device, seed):
    """q, k, v ~ N(0, 1) at bert-naml's attention page; the bias is the one
    packed_mask_bias makes for 512 items whose valid lengths are those of
    the fixture's titles (15..30 tokens + [CLS], 2 [SEP], category)."""
    import torch
    from legommenders_tpu_torch.models.lm.layers import (
        pack_items, packed_mask_bias,
    )

    items, L, Dm = ATTN_PAGE["items"], ATTN_PAGE["L"], ATTN_PAGE["D"]
    g = torch.Generator(device=device).manual_seed(seed)
    lens = torch.randint(19, L + 1, (items,), generator=g, device=device)
    mask = (torch.arange(L, device=device)[None] < lens[:, None]).int()
    _, mask_p, _ = pack_items(torch.zeros(items, L, 1, device=device), mask,
                              128 // L)
    B, T = mask_p.shape
    q, k, v = (torch.randn(B, T, Dm, generator=g, device=device).to(dtype)
               for _ in range(3))
    return q, k, v, packed_mask_bias(mask_p, L, dtype)[:, 0]


def check_attention(dtype_name: str, device) -> dict:
    import torch
    from torch.nn import functional as F
    from legommenders_tpu_torch.ops.attention import (
        packed_attention, reference_attention,
    )

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    heads = ATTN_PAGE["heads"]
    q, k, v, bias = attention_inputs(dtype, device, seed=7)
    B, T, Dm = q.shape
    # the head-split layout torch's own attention takes; timed only
    qh, kh, vh = (t.view(B, T, heads, Dm // heads).transpose(1, 2)
                  for t in (q, k, v))
    mask4 = bias[:, None]
    with torch.inference_mode():
        got = packed_attention(heads, 0.0, q, k, v, bias)
        want = reference_attention(heads, q, k, v, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        res = {"B": B, "T": T, "D": Dm, "heads": heads, "dtype": dtype_name,
               "max_abs_err": float(err.max()),
               "rel_err": float(err.max() / want.float().abs().max()),
               "finite": bool(torch.isfinite(got.float()).all()),
               "ms": time_ms(lambda: packed_attention(heads, 0.0, q, k, v,
                                                      bias), iters=50),
               "plain_ms": time_ms(lambda: reference_attention(
                   heads, q, k, v, bias), iters=5),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=mask4), iters=50)}
    flops = 4.0 * B * T * T * Dm
    nbytes = 4 * B * T * Dm * q.element_size() + B * T * T * bias.element_size()
    res["bound_ms"], res["bound_by"] = roof(flops, nbytes, dtype_name)
    res["bound_peak"] = f"{dtype_name} {PEAK[dtype_name] / 1e12:g} TFLOP/s"
    ok = (res["max_abs_err"] <= F32_TOL if dtype_name == "f32"
          else res["rel_err"] <= BF16_REL_TOL)
    if not (ok and res["finite"]):
        raise RuntimeError(f"packed_attention disagrees with its plain "
                           f"version: {res}")
    return res


# each kernel's device-side names, as the profiler lists them
KERNEL_NAMES = {"additive_pool": ("additive_pool_kernel",),
                "packed_attention": ("attention_mma", "attention_simt")}


def profile_serving(cache, ev) -> dict:
    """torch.profiler over one warm serving pass (cache build + scoring +
    metrics): device time by kernel and the device's idle share of the
    window's wall time (the profiler's own host cost included), and each
    port kernel's device time and launches summed over the pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cache.cache()
        ev.metrics("test", ev.score_phase_device("test"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ours = {}
    for name, keys in KERNEL_NAMES.items():
        evs = [e for e in kernels if any(k in e.key for k in keys)]
        ours[name] = {"ms": sum(e.self_device_time_total for e in evs) / 1e3,
                      "launches": sum(e.count for e in evs)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernels": ours,
            # no device time in the trace means the share was not measured
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:60], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _plain_attention(num_heads, dropout_p, q, k, v, bias, seed=None):
    from legommenders_tpu_torch.ops.attention import reference_attention

    return reference_attention(num_heads, q, k, v, bias)


def run_path(name: str, model_cfg: dict, data, device,
             attention_per_item_page: int) -> dict:
    """One serving path through Manager + Tester.test(); returns its record.
    Every kernel's launch count is set to 0 just before Tester.test() and
    read just after: the pool must launch once per item and user page, the
    attention `attention_per_item_page` times per item page."""
    from unittest import mock

    import numpy as np
    import torch
    import legommenders_tpu_torch.models.common as common
    import legommenders_tpu_torch.models.lm.layers as lm_layers
    from legommenders_tpu_torch.ops.additive import (
        additive_pool, additive_pool_reference,
    )
    from legommenders_tpu_torch.ops.attention import packed_attention
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    counters = {"additive_pool": additive_pool,
                "packed_attention": packed_attention}
    rec = {"path": name}
    t0 = time.perf_counter()
    m = Manager(model_cfg=model_cfg, exp_cfg=EXP_CFG, data=data,
                device=device, seed=0)
    tester = Tester(m)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = tester.test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    cache = m.cache
    rec["item_pages"] = len(cache.pages(cache.num_items))
    rec["user_pages"] = len(cache.pages(cache.num_users))
    rec["expected_launches"] = {
        "additive_pool": rec["item_pages"] + rec["user_pages"],
        "packed_attention": attention_per_item_page * rec["item_pages"]}
    rec["metrics"] = res

    # the same phases again, warm, one at a time
    ev = tester.evaluator

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    _, rec["cache_s"] = timed(cache.cache)
    scores, rec["score_s"] = timed(lambda: ev.score_phase_device("test"))
    dev_metrics, rec["metric_s"] = timed(lambda: ev.metrics("test", scores))
    ph = ev.phase("test")
    rec["rows"] = ph.n
    host_metrics = ev.pool(scores.float().cpu().numpy(), ph.labels, ph.groups)
    rec["metric_vs_numpy_err"] = max(abs(dev_metrics[k] - host_metrics[k])
                                     for k in host_metrics)
    rec["profile"] = profile_serving(cache, ev)

    # reprs of the first rows vs the same model with every kernel patched
    # out for its plain version, on the card, page by page
    item_repr, user_repr = cache.item_repr, cache.user_repr
    rec["item_repr_shape"] = list(item_repr.shape)
    rec["user_repr_shape"] = list(user_repr.shape)
    with mock.patch.object(common, "additive_pool", additive_pool_reference), \
            mock.patch.object(lm_layers, "packed_attention",
                              _plain_attention), \
            torch.inference_mode():
        item_ref = torch.cat([
            m.model.encode_item_page(
                {c: a[s:e] for c, a in cache.item_contents.items()})
            for s, e in cache.pages(min(REPR_ROWS, cache.num_items))])
        user_ref = torch.cat([
            m.model.encode_user(item_repr[cache.hist_safe[s:e]],
                                cache.hist_mask[s:e])
            for s, e in cache.pages(min(REPR_ROWS, cache.num_users))])
    for part, got, want in (("item", item_repr, item_ref),
                            ("user", user_repr, user_ref)):
        err = (got[:len(want)].float() - want.float()).abs().max()
        rec[f"{part}_repr_rel_err"] = float(err / want.float().abs().max())
        rec[f"{part}_repr_finite"] = bool(torch.isfinite(got).all())

    problems = []
    if rec["item_repr_shape"] != [data.num_items, 64] or \
            rec["user_repr_shape"] != [data.num_users, 64]:
        problems.append("repr shapes")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()):
        problems.append("metrics not finite in [0, 1]")
    if rec["metric_vs_numpy_err"] > 1e-5:
        problems.append("device metrics disagree with the numpy pool")
    for part in ("item", "user"):
        if not rec[f"{part}_repr_finite"]:
            problems.append(f"{part} reprs not finite")
        if rec[f"{part}_repr_rel_err"] > BF16_REL_TOL:
            problems.append(f"{part} reprs disagree with the plain path")
    if rec["launches"] != rec["expected_launches"]:
        problems.append("kernel launches on the path")
    if problems:
        raise RuntimeError(f"{name} path failed ({', '.join(problems)}): "
                           f"{rec}")
    del m, tester, cache, ev
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails outside a checkout: the port is part of the repository
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.ops import additive, build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    texts = build.build_all(["additive_pool", "packed_attention"])
    log(f"[build] additive_pool + packed_attention, one nvcc each at once, "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, text in texts.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    checks = []
    for pool, (N, L) in POOLS.items():
        for dtype in ("f32", "bf16"):
            res = check_pool(pool, N, L, dtype, device)
            checks.append(res)
            log(f"[kernel] {json.dumps(res)}")
    log(f"[kernel] persistent grid by (L, D, H, bf16, device): "
        f"{additive._grids}")
    attn_checks = []
    for dtype in ("f32", "bf16"):
        res = check_attention(dtype, device)
        attn_checks.append(res)
        log(f"[kernel] packed_attention {json.dumps(res)}")

    t0 = time.perf_counter()
    data = SyntheticProcessor(**DATA_KW).as_lego_data()
    log(f"[data] host data build {time.perf_counter() - t0:.2f} s, shared "
        f"by both paths")
    paths = {}
    for name, cfg, per_page in (("naml", MODEL_CFG, 0),
                                ("bert-naml", BERT_CFG, BERT_LAYERS)):
        paths[name] = run_path(name, cfg, data, device, per_page)
        log(f"[main] {json.dumps(paths[name])}")

    def by_path(key):
        return {p: rec["launches"][key] for p, rec in paths.items()}

    def profiled(key):
        return {p: rec["profile"]["kernels"][key] for p, rec in paths.items()}

    pool_bf16 = [c for c in checks if c["dtype"] == "bf16"]
    attn_bf16 = next(c for c in attn_checks if c["dtype"] == "bf16")
    kernels = [{
        "name": "additive_pool",
        "route": "cuda",
        "source": "legommenders_tpu_torch/csrc/additive_pool.cu",
        "replaces": "legommenders_tpu/ops/pallas_additive.py:34",
        "launches": sum(by_path("additive_pool").values()),
        "launches_by_path": by_path("additive_pool"),
        # item + user pool at NAML's full width, bf16 (the main dtype)
        "max_abs_err": max(c["max_abs_err"] for c in pool_bf16),
        "ms": sum(c["ms"] for c in pool_bf16),
        "plain_ms": sum(c["plain_ms"] for c in pool_bf16),
        "bound_ms": sum(c["bound_ms"] for c in pool_bf16),
        "bound_us": sum(c["bound_ms"] for c in pool_bf16) * 1e3,
        "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                   for c in pool_bf16) else "operations",
        "library_ms": None,
        # device time summed over the kernel's launches in each path's
        # profiled warm pass, at the shapes the path gives it
        "main_path_ms": sum(v["ms"] for v in profiled("additive_pool")
                            .values()),
        "main_path_by_path": profiled("additive_pool"),
        "checks": checks,
    }, {
        "name": "packed_attention",
        "route": "cuda",
        "source": "legommenders_tpu_torch/csrc/packed_attention.cu",
        "replaces": "legommenders_tpu/ops/pallas_attention.py:53",
        "launches": sum(by_path("packed_attention").values()),
        "launches_by_path": by_path("packed_attention"),
        # one bert-naml page, bf16 (the main dtype)
        "max_abs_err": attn_bf16["max_abs_err"],
        "ms": attn_bf16["ms"],
        "plain_ms": attn_bf16["plain_ms"],
        "bound_ms": attn_bf16["bound_ms"],
        "bound_by": attn_bf16["bound_by"],
        "library_ms": attn_bf16["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "main_path_ms": sum(v["ms"] for v in profiled("packed_attention")
                            .values()),
        "main_path_by_path": profiled("packed_attention"),
        "checks": attn_checks,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
