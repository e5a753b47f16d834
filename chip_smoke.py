#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (legommenders_tpu_torch) on one card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA card and nvcc (on PATH, or under CUDA_HOME), imports nothing of JAX,
and exits non-zero when any phase fails:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for the parity phases;
  2. build: compiles csrc/additive_pool.cu with nvcc and prints the build
     seconds and ptxas' register/spill report;
  3. kernel vs plain version: the additive pool at both widths the NAML
     serving path gives it (item pool 65,000 x 31 x 64, user pool
     20,000 x 50 x 64, H = 256), in f32 and bf16, with partly and fully
     masked rows; f32 within 1e-5 absolute, bf16 within 2e-2 of the
     largest output of the plain version computed in f32 from the same
     bf16 inputs; all-masked rows must give exactly 0. Times both with
     CUDA events beside the card's least possible time (bound);
  4. main path: NAML (CNN / Ada / Dot, hidden 64, bf16) at full width on
     the synthetic MIND-small-geometry fixture, random weights from seed
     0, through Manager + Tester.test(): item cache, user cache, cached
     scoring of the test phase and the group metrics. The kernel's launch
     count over that run must equal the item pages + user pages of the
     cache build. The first 2,048 item and user reprs are held against
     the plain version on the card, and the device metrics against the
     numpy MetricPool on the same scores. One more warm pass runs under
     torch.profiler for device time by kernel (the additive pool's time
     at the 512-row pages the path gives it included) and the idle share;
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


def bound(N: int, L: int, dtype: str):
    """(ms, 'bytes'|'operations') the card needs at least: inputs read
    once, output written once, against the data-sheet peak for dtype."""
    xb = 2 if dtype == "bf16" else 4
    flops = 2.0 * N * L * (D * H + H + D)
    nbytes = N * L * D * xb + N * L * 4 + (D * H + 2 * H) * 4 + N * D * xb
    t_ops, t_bytes = flops / PEAK[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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


def profile_serving(cache, ev) -> dict:
    """torch.profiler over one warm serving pass (cache build + scoring +
    metrics): device time by kernel and the device's idle share of the
    window's wall time (the profiler's own host cost included), and the
    additive pool's device time summed over its launches in the pass."""
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
    pool = [e for e in kernels if "additive_pool_kernel" in e.key]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "pool_ms": sum(e.self_device_time_total for e in pool) / 1e3,
            "pool_launches": sum(e.count for e in pool),
            # no device time in the trace means the share was not measured
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:60], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def run_main_path(device) -> dict:
    """NAML serving through Manager + Tester.test(); returns its record."""
    from unittest import mock

    import numpy as np
    import torch
    import legommenders_tpu_torch.models.common as common
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.ops.additive import (
        additive_pool, additive_pool_reference,
    )
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    rec = {}
    t0 = time.perf_counter()
    data = SyntheticProcessor(**DATA_KW).as_lego_data()
    rec["host_data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    m = Manager(model_cfg=MODEL_CFG, exp_cfg=EXP_CFG, data=data,
                device=device, seed=0)
    tester = Tester(m)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0

    additive_pool.launches = 0
    t0 = time.perf_counter()
    res = tester.test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["launches"] = additive_pool.launches
    cache = m.cache
    rec["pages"] = (len(cache.pages(cache.num_items))
                    + len(cache.pages(cache.num_users)))
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

    # reprs of the first rows vs the plain pool on the card, page by page
    item_repr, user_repr = cache.item_repr, cache.user_repr
    rec["item_repr_shape"] = list(item_repr.shape)
    rec["user_repr_shape"] = list(user_repr.shape)
    with mock.patch.object(common, "additive_pool", additive_pool_reference), \
            torch.inference_mode():
        item_ref = torch.cat([
            m.model.encode_item_page(
                {c: a[s:e] for c, a in cache.item_contents.items()})
            for s, e in cache.pages(min(REPR_ROWS, cache.num_items))])
        user_ref = torch.cat([
            m.model.encode_user(item_repr[cache.hist_safe[s:e]],
                                cache.hist_mask[s:e])
            for s, e in cache.pages(min(REPR_ROWS, cache.num_users))])
    for name, got, want in (("item", item_repr, item_ref),
                            ("user", user_repr, user_ref)):
        err = (got[:len(want)].float() - want.float()).abs().max()
        rec[f"{name}_repr_rel_err"] = float(err / want.float().abs().max())
        rec[f"{name}_repr_finite"] = bool(torch.isfinite(got).all())

    problems = []
    if rec["item_repr_shape"] != [data.num_items, 64] or \
            rec["user_repr_shape"] != [data.num_users, 64]:
        problems.append("repr shapes")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()):
        problems.append("metrics not finite in [0, 1]")
    if rec["metric_vs_numpy_err"] > 1e-5:
        problems.append("device metrics disagree with the numpy pool")
    for name in ("item", "user"):
        if not rec[f"{name}_repr_finite"]:
            problems.append(f"{name} reprs not finite")
        if rec[f"{name}_repr_rel_err"] > BF16_REL_TOL:
            problems.append(f"{name} reprs disagree with the plain pool")
    if problems:
        raise RuntimeError(f"main path failed ({', '.join(problems)}): {rec}")
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
    from legommenders_tpu_torch.ops import additive, build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    text = build.build("additive_pool")
    log(f"[build] additive_pool in {time.perf_counter() - t0:.2f} s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    checks = []
    for pool, (N, L) in POOLS.items():
        for dtype in ("f32", "bf16"):
            res = check_pool(pool, N, L, dtype, device)
            checks.append(res)
            log(f"[kernel] {json.dumps(res)}")
    log(f"[kernel] persistent grid by (L, D, H, bf16, device): "
        f"{additive._grids}")

    rec = run_main_path(device)
    log(f"[main] {json.dumps(rec)}")
    if rec["launches"] != rec["pages"]:
        raise RuntimeError(f"additive_pool launched {rec['launches']} times "
                           f"on the main path, the cache build ran "
                           f"{rec['pages']} pages")

    main_dtype = [c for c in checks if c["dtype"] == "bf16"]
    kernels = [{
        "name": "additive_pool",
        "route": "cuda",
        "source": "legommenders_tpu_torch/csrc/additive_pool.cu",
        "replaces": "legommenders_tpu/ops/pallas_additive.py:34",
        "launches": rec["launches"],
        # item + user pool at full width, bf16 (the main path's dtype)
        "max_abs_err": max(c["max_abs_err"] for c in main_dtype),
        "ms": sum(c["ms"] for c in main_dtype),
        "plain_ms": sum(c["plain_ms"] for c in main_dtype),
        "bound_ms": sum(c["bound_ms"] for c in main_dtype),
        "bound_us": sum(c["bound_ms"] for c in main_dtype) * 1e3,
        "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                   for c in main_dtype) else "operations",
        "library_ms": None,
        # the same kernel at the 512-row pages of the main path: device time
        # summed over its launches in the profiled warm pass
        "main_path_ms": rec["profile"]["pool_ms"],
        "main_path_profiled_launches": rec["profile"]["pool_launches"],
        "checks": checks,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
