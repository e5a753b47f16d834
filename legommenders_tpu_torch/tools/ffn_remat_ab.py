#!/usr/bin/env python3
"""Times bert-naml's training step under `full` remat and under `ffn` kept
two ways, in one process on one card:

    python3 legommenders_tpu_torch/tools/ffn_remat_ab.py [--steps N] \
        [--out FILE]

The model is chip_smoke.py's layer-split bert-naml (BERT_TRAIN_CFG:
65,000 items in 127 pages of 512, tune_from 10, LoRA r 32 folded,
dropout 0.1, batch 2,048, bf16, seed 0) on its fixture. Three arms, each
from the same weights with a new pipeline and Adam state (so the same
batches and dropout draws), run in the order full, stash, selective,
selective, stash, full:
  - full: every page recomputed whole in the backward;
  - stash: the port's `ffn` (`models/lm/remat.FFNStash`: each page's FFN
    outputs kept, replayed in the recompute);
  - selective: `ffn` as a selective checkpoint whose policy keeps
    `ffn_dense`'s outputs (`create_selective_checkpoint_contexts`),
    patched in for this arm.
Each run is chip_smoke._train_steps: 1 warm and N timed steps, each to
the device's end of it, then one under torch.profiler. Prints, and writes
to --out, one JSON object with each run's step ms (median and each),
peak GB, idle share, GEMM launches, its losses' largest relative
difference from the first full run's, and the card's name and power
limit. Needs one CUDA card and nvcc.
"""
import argparse
import contextlib
import functools
import json
import os
import sys
import time
from unittest import mock

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import chip_smoke  # noqa: E402  (no top-level torch or port import)

ORDER = ("full", "stash", "selective", "selective", "stash", "full")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from torch.utils.checkpoint import (
        CheckpointPolicy, create_selective_checkpoint_contexts,
    )
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.models import legommender
    from legommenders_tpu_torch.models.lm.remat import FFN_DENSE_OP
    from legommenders_tpu_torch.runtime.manager import Manager

    def keep_ffn(ctx, op, *a, **k):
        return (CheckpointPolicy.MUST_SAVE if op == FFN_DENSE_OP
                else CheckpointPolicy.PREFER_RECOMPUTE)
    selective = functools.partial(create_selective_checkpoint_contexts,
                                  keep_ffn)

    device = torch.device("cuda")
    out = {"card": chip_smoke.card_line(), "steps": args.steps, "runs": []}
    t0 = time.perf_counter()
    data = SyntheticProcessor(**chip_smoke.DATA_KW).as_lego_data()
    m = Manager(model_cfg=chip_smoke.BERT_TRAIN_CFG,
                exp_cfg=chip_smoke.EXP_CFG, data=data, device=device, seed=0)
    assert m.prepare_lm_cache(root=None)
    out["setup_s"] = time.perf_counter() - t0
    start = chip_smoke._snapshot(m.model)
    first_full = None
    for arm in ORDER:
        m.model.load_state_dict(start)
        m.model.item_page_remat = "full" if arm == "full" else "ffn"
        patch = (mock.patch.dict(legommender.PAGE_CONTEXTS,
                                 {"ffn": selective})
                 if arm == "selective" else contextlib.nullcontext())
        with patch:
            rec, _ = chip_smoke._train_steps(m, data, device, args.steps)
        torch.cuda.empty_cache()
        if first_full is None:
            first_full = rec
        pr = rec["profile"]
        run = {"arm": arm, "step_ms": rec["step_ms"],
               "step_ms_each": rec["step_ms_each"],
               "peak_memory_gb": rec["peak_memory_gb"],
               "device_idle_share": pr["device_idle_share"],
               "gemm_launches": pr["gemm_launches"],
               "kernel_launches": pr["kernel_launches"],
               "launches_per_step": rec["launches_per_step"],
               "loss_rel_err_vs_full": chip_smoke.shared_loss_err(
                   rec, first_full)}
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
