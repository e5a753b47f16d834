#!/usr/bin/env python3
"""Times the fused training steps of one checkout of the port on one card,
so that two trees can be compared in one run (parent, change, change,
parent):

    python3 legommenders_tpu_torch/tools/time_steps.py --root DIR \
        [--data FILE] [--out FILE]

Imports legommenders_tpu_torch from DIR (its kernels built there at first
use) and runs, on chip_smoke.py's fixture (65,000 items, 20,000 users,
bf16, seed 0) and configurations taken from this checkout for either tree,
1 warm and STEPS timed steps of 2,048 impressions, each to the device's
end of it, through DeviceTrainPipeline.make_fused_train_step:
  - naml: chip_smoke.MODEL_CFG (the catalog encoded once a step);
  - bert-naml: chip_smoke.BERT_TRAIN_CFG (layer-split at tune_from 10,
    the lower slice's cache built first, pages of 512).
`--data FILE` loads the fixture from a pickle, or builds it and writes the
pickle there when FILE does not exist (the build takes ~30 s of host time).
Prints one JSON object with each path's step ms (median, min, max) and the
card's name and power limit (and writes it to --out).
"""
import argparse
import itertools
import json
import os
import pickle
import statistics
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import chip_smoke  # noqa: E402  (no top-level torch or port import)

STEPS = 5


def _fixture(path):
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )

    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    data = SyntheticProcessor(**chip_smoke.DATA_KW).as_lego_data()
    if path:
        with open(path, "wb") as f:
            pickle.dump(data, f)
    return data


def time_path(torch, cfg, data, device) -> dict:
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline,
    )
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager

    m = Manager(model_cfg=cfg, exp_cfg=chip_smoke.EXP_CFG, data=data,
                device=device, seed=0)
    m.prepare_lm_cache(root=None)
    lc = m.lego_cfg
    dp = DeviceTrainPipeline(data, batch_size=chip_smoke.TRAIN_BATCH,
                             neg_count=lc.neg_count,
                             use_neg_sampling=lc.use_neg_sampling, seed=0,
                             device=device)
    step = dp.make_fused_train_step(
        m.model, m.contents.columns,
        steps.adam(m.model, chip_smoke.TRAIN_LR), seed=0)
    stream = itertools.chain.from_iterable(iter(dp.epoch_indices, None))
    step(next(stream), 0)
    times = []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(next(stream), i + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del m, dp, step
    torch.cuda.empty_cache()
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "n": len(times)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=CHECKOUT)
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_steps: no CUDA device", file=sys.stderr)
        return 1
    import legommenders_tpu_torch
    device = torch.device("cuda", 0)
    data = _fixture(args.data)
    res = {"root": os.path.abspath(args.root),
           "package": os.path.dirname(legommenders_tpu_torch.__file__),
           "card": chip_smoke.card_line(), "step_ms": {}}
    for name, cfg in (("naml", chip_smoke.MODEL_CFG),
                      ("bert-naml", chip_smoke.BERT_TRAIN_CFG)):
        res["step_ms"][name] = time_path(torch, cfg, data, device)
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
