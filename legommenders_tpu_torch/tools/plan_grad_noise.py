#!/usr/bin/env python3
"""How far two backward passes of NAML's step lie apart on one card: the
catalog gradient plans against themselves, the plain backward against
itself and the two against each other, by default and under
`torch.use_deterministic_algorithms` (chip_smoke.deterministic):

    python3 legommenders_tpu_torch/tools/plan_grad_noise.py [--reps N] \
        [--out FILE]

The model and batch are chip_smoke.py phase 7.3's (NAML at its fixture,
f32, seed 0, the device pipeline's first batch of 2,048); each error is
over chip_smoke._plan_scale (a bias against the larger of its own and its
weight's largest gradient), for the item pool's proj_bias (the largest)
and the largest of every other tensor. Prints, and writes to --out, one
JSON object with each repeat's errors and the card's name and power
limit. Needs one CUDA card and nvcc.
"""
import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

BIAS = "item_op.attention.proj_bias"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    import chip_smoke as cs
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline, step_generator,
    )
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.ops import build
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager

    build.build_all(["additive_pool", "packed_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    data = SyntheticProcessor(**cs.DATA_KW).as_lego_data()
    m = Manager(model_cfg=cs.MODEL_CFG, exp_cfg={"policy": {"dtype": "f32"}},
                data=data, device=device, seed=0)
    pipe = DeviceTrainPipeline(data, batch_size=cs.TRAIN_BATCH, seed=0,
                               device=device)
    batch = pipe.assemble(next(pipe.epoch_indices(shuffle=False)),
                          step_generator(0, 0, device))
    model = m.model
    loss_fn = steps.make_loss_fn(model, m.contents.columns, True)
    plans = model.catalog_plans, model.catalog_history_plan

    def grads(side):
        model.catalog_plans, model.catalog_history_plan = (
            plans if side == "plans" else (None, None))
        model.zero_grad(set_to_none=True)
        loss_fn(batch, step_generator(0, 1, device)).backward()
        return {n: p.grad.float().clone()
                for n, p in model.named_parameters() if p.grad is not None}

    def err(a, b, n, ref):
        return (a[n] - b[n]).abs().max().item() / cs._plan_scale(n, ref)

    out = {"card": cs.card_line()}
    for mode in ("default", "deterministic"):
        rows = []
        for _ in range(args.reps):
            with (cs.deterministic() if mode == "deterministic"
                  else contextlib.nullcontext()):
                p1, q1, q2, p2 = (grads("plans"), grads("plain"),
                                  grads("plain"), grads("plans"))
            rows.append({
                "plans_vs_plain": err(p1, q1, BIAS, q1),
                "plain_vs_plain": err(q2, q1, BIAS, q1),
                "plans_vs_plans": err(p2, p1, BIAS, q1),
                "others_plans_vs_plain": max(
                    err(p1, q1, n, q1) for n in p1 if n != BIAS)})
        out[mode] = rows
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
