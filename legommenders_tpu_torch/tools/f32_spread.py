#!/usr/bin/env python3
"""How far one process's f32 gradients of a bert-naml layer-split step lie
from the same step at f64, and how far one ulp of noise on what the step
reads moves them, on the CPU:

    python3 legommenders_tpu_torch/tools/f32_spread.py [--items N]
        [--batch B] [--out FILE]

The step is chip_smoke.py phase 15's (`_p13_bert(0.0)`: BERT-base,
tune_from 10, LoRA r 32, dropout 0) on a synthetic catalog of N items (the
fixture's widths, title 30, history 50), from the same seed at each
precision: the lower slice's cache built in that precision, one loss and
its backward over the first training batch of B impressions. The noise
run is the f32 run after `chip_smoke._p15_ulp_noise`. Prints one JSON
object: for each of the `top` tensors furthest from f64, its error against
f64 and its spread under the noise, each over the tensor's largest value
(`chip_smoke._p13_errs`), and the largest of each over all tensors. This
is what `chip_smoke._p15_f32_rule` reads the noise spread as: one
process's own f32 error at the step's size.
"""
import argparse
import json
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import chip_smoke  # noqa: E402  (no top-level torch or port import)


def _grads(data, batch, lm_dtype, noise: bool) -> dict:
    import torch
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager

    cfg = chip_smoke._p13_bert(0.0)
    cfg["config"]["item_config"]["lm_dtype"] = lm_dtype
    m = Manager(model_cfg=cfg, data=data, device="cpu", seed=0,
                dtype=lm_dtype)
    m.prepare_lm_cache(root=None)
    if noise:
        chip_smoke._p15_ulp_noise(m)
    loss = steps.make_loss_fn(m.model, m.contents.columns, True)(
        batch, steps.step_generator(0, 0, "cpu"))
    loss.backward()
    return {n: p.grad.detach().double()
            for n, p in m.model.named_parameters() if p.grad is not None}


def spread(items: int = 256, batch_size: int = 64, top: int = 5) -> dict:
    import torch
    from legommenders_tpu_torch.data.pipeline import TrainBatcher
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )

    data = SyntheticProcessor(**dict(
        chip_smoke.DOTS_DATA_KW, num_items=items, num_users=4 * batch_size,
        vocab_size=3000, inters_per_user=6)).as_lego_data()
    batch = {k: torch.as_tensor(v) for k, v in next(TrainBatcher(
        data, batch_size, neg_count=4, seed=0).epoch()).items()}
    f64 = _grads(data, batch, torch.float64, False)
    f32 = _grads(data, batch, torch.float32, False)
    noisy = _grads(data, batch, torch.float32, True)
    f64 = {k: g for k, g in f64.items() if float(g.abs().max()) > 0}
    err = chip_smoke._p13_errs(f32, f64)
    noise = chip_smoke._p13_errs(noisy, {k: f32[k] for k in f64})
    worst = sorted(err, key=lambda k: -err[k])[:top]
    return {"items": items, "batch": batch_size,
            "top": {k: {"f32_vs_f64": err[k], "noise_spread": noise[k]}
                    for k in worst},
            "max_f32_vs_f64": max(err.values()),
            "max_noise_spread": max(noise.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--items", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = spread(args.items, args.batch)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
