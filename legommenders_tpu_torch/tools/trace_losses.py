#!/usr/bin/env python3
"""Counts the kernel records torch.profiler's trace loses on one card:

    python3 legommenders_tpu_torch/tools/trace_losses.py [--steps 150]
        [--out FILE]

Runs chip_smoke.profile_window (which raises when a port kernel's
profiled launches fall short of its wrapper's count by more than the
records the trace shows lost inside that wrapper's launch ranges) over
50 lone pool launches (2,048 x 50 x 64, bf16), 5 lone attention launches
(128 rows, T 128, D 4096, 32 heads, bf16), and the fused training steps
of gdcn_id (--steps windows) and of dcn_id and naml_id (40 each) at
chip_smoke.py's fixture, batch and policy. Per window it keeps the
trace's launch calls, the calls whose device record is missing (all, and
inside each wrapper's range), and the profiled launches of the port's
kernels; and it times `ops.build.launch_range`, with no profiler running
and under one. Prints one JSON summary (and writes the windows to --out).
"""
import argparse
import itertools
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import chip_smoke  # noqa: E402


def _window(kind, fn) -> dict:
    try:
        rec = chip_smoke.profile_window(fn)
    except RuntimeError as e:
        return {"kind": kind, "error": str(e)}
    return {"kind": kind, "launch_calls": rec["launch_calls"],
            "lost": rec["lost_records"], "port_calls": rec["port_calls"],
            "listed": {n: r["launches"] for n, r in rec["kernels"].items()}}


def _range_us(n: int) -> float:
    from legommenders_tpu_torch.ops import build

    t0 = time.perf_counter()
    for _ in range(n):
        with build.launch_range("additive_pool"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline,
    )
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.ops import build
    from legommenders_tpu_torch.ops.additive import additive_pool
    from legommenders_tpu_torch.ops.attention import packed_attention
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager

    dev = torch.device("cuda")
    build.build_all(["additive_pool", "packed_attention"])
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2048, 50, 64, device=dev, generator=g).bfloat16()
    mask = torch.ones(2048, 50, device=dev)
    w1, b1, w2 = (torch.randn(*s, device=dev, generator=g)
                  for s in ((64, 256), (256,), (256,)))
    windows = [_window("pool", lambda: additive_pool(x, mask, w1, b1, w2))
               for _ in range(50)]
    q = torch.randn(128, 128, 4096, device=dev, generator=g).bfloat16()
    bias = torch.zeros(128, 128, 128, device=dev, dtype=torch.bfloat16)
    windows += [_window("attention", lambda: packed_attention(
        32, 0.0, q, q, q, bias)) for _ in range(5)]
    summary = {"launch_range_us_off": _range_us(100000)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        summary["launch_range_us_on"] = _range_us(10000)

    data = SyntheticProcessor(**chip_smoke.DATA_KW).as_lego_data()
    for name, n in (("gdcn_id", args.steps), ("dcn_id", 40),
                    ("naml_id", 40)):
        m = Manager(model_cfg=chip_smoke.zoo_cfg(name),
                    exp_cfg=chip_smoke.ZOO_EXP, data=data, device=dev, seed=0)
        cfg = m.lego_cfg
        dp = DeviceTrainPipeline(data, batch_size=chip_smoke.TRAIN_BATCH,
                                 neg_count=cfg.neg_count,
                                 use_neg_sampling=cfg.use_neg_sampling,
                                 seed=0, device=dev)
        step = dp.make_fused_train_step(
            m.model, m.contents.columns,
            steps.adam(m.model, chip_smoke.TRAIN_LR), seed=0)
        rows = itertools.chain.from_iterable(iter(dp.epoch_indices, None))
        step(next(rows), 0)
        windows += [_window(name, lambda: step(next(rows), i + 1))
                    for i in range(n)]
        del m, dp, step
        torch.cuda.empty_cache()

    ok = [w for w in windows if "error" not in w]
    short = [w for w in ok if w["listed"] != {
        n: w["port_calls"][n] for n in w["listed"]}]
    summary.update({
        "windows": len(windows), "raised": len(windows) - len(ok),
        "errors": [w["error"] for w in windows if "error" in w][:5],
        "lost_any": sum(w["lost"] > 0 for w in ok),
        "lost_most": max((w["lost"] for w in ok), default=0),
        "port_launch_missing": len(short),
        "when_port_launch_missing": [
            {k: w[k] for k in ("kind", "launch_calls", "lost")}
            for w in short]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "windows": windows}, f)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
