#!/usr/bin/env python3
"""Summarises one profiled window both ways and times each on the host:

    python3 legommenders_tpu_torch/tools/profile_summary.py [--out FILE]

The window is one bert-naml layer-split training step at
chip_smoke.py's configuration (BERT_TRAIN_CFG: 65,000 items in 127
pages of 512 under the `ffn` remat policy, batch 2,048, bf16, seed 0; one
warm step first), under torch.profiler with the CPU and CUDA activities.
Its trace is then summarised:
  - by `key_averages()` (the profiler's operator tree; what
    chip_smoke.profile_window read until it took the one walk), its
    device-side entries but the port wrappers' launch ranges;
  - by chip_smoke.trace_records + summarize_kernels (one walk over the
    raw kineto events).
Prints, and writes to --out, one JSON object with each way's host
seconds, device busy ms, kernel launches, idle share of the window, the
port kernels' ms and launches, the ten longest kernels, and the card's
name and power limit. Needs one CUDA card and nvcc.
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

import chip_smoke  # noqa: E402  (no top-level torch or port import)


def by_key_averages(prof) -> dict:
    """The summary as key_averages() gives it."""
    from torch.autograd import DeviceType

    kernels = {e.key: {"count": e.count, "ms": e.self_device_time_total / 1e3}
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key not in chip_smoke.KERNEL_NAMES}
    return chip_smoke.summarize_kernels(kernels)


def by_one_walk(prof) -> dict:
    trace = chip_smoke.trace_records(prof.profiler.kineto_results.events())
    return chip_smoke.summarize_kernels(trace["kernels"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager

    if not torch.cuda.is_available():
        print("profile_summary: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    data = SyntheticProcessor(**chip_smoke.DATA_KW).as_lego_data()
    m = Manager(model_cfg=chip_smoke.BERT_TRAIN_CFG,
                exp_cfg=chip_smoke.EXP_CFG, data=data, device=device, seed=0)
    assert m.prepare_lm_cache(root=None)
    dp = DeviceTrainPipeline(data, batch_size=chip_smoke.TRAIN_BATCH,
                             neg_count=4, seed=0, device=device)
    step = dp.make_fused_train_step(
        m.model, m.contents.columns, steps.adam(m.model, chip_smoke.TRAIN_LR),
        seed=0)
    stream = itertools.chain.from_iterable(iter(dp.epoch_indices, None))
    step(next(stream), 0).item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(next(stream), 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"window": "bert-naml layer-split training step", "wall_ms": wall_ms,
           "card": chip_smoke.card_line()}
    # the one walk first: key_averages() keeps the parsed tree afterwards
    for name, fn in (("one_walk", by_one_walk),
                     ("key_averages", by_key_averages)):
        t0 = time.perf_counter()
        summary = fn(prof)
        summary["host_s"] = time.perf_counter() - t0
        summary["device_idle_share"] = 1.0 - summary["busy_ms"] / wall_ms
        out[name] = summary
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
