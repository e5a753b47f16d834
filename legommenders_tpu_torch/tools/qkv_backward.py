#!/usr/bin/env python3
"""Lists the kernels of one BERT layer's forward and backward with
`fused_qkv` off and on:

    python3 legommenders_tpu_torch/tools/qkv_backward.py [--out FILE]

The layer is bert-naml's trainable layer at chip_smoke.py's training
page: D 768, 12 heads, LoRA r 32 on q and v folded into the frozen base
weights, bf16, dropout 0, over 171 packed rows of T 120 (512 items of
40 tokens, 3 to a row). The attention core is the plain one
(`fused_attention` off), so that nothing needs a build; its products
are bmm and do not depend on `fused_qkv`. For each side, after two warm
passes: the matrix products the dispatcher runs in the forward and in
the backward (aten mm / addmm / bmm / baddbmm and `ffn_dense`, with
their shapes) and the kernels torch.profiler records in each, by name
with counts (chip_smoke.trace_records), the ones chip_smoke counts as
matrix products marked. Prints, and writes to --out, one JSON object
with the card's name and power limit. Needs one CUDA card (`--device
cpu` lists the products alone).
"""
import argparse
import collections
import json
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import chip_smoke  # noqa: E402  (no top-level torch or port import)

ROWS, T, D, HEADS, LORA_R = 171, 120, 768, 12, 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu: the products only (no kernels to list)")
    ap.add_argument("--rows", type=int, default=ROWS)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from legommenders_tpu_torch.models.legommender import DOT_OPS
    from legommenders_tpu_torch.models.lm.layers import BertLayer

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in DOT_OPS:
                shapes = [list(a.shape) for a in args
                          if isinstance(a, torch.Tensor)]
                self.seen[f"{func} {shapes}"] += 1
            return func(*args, **(kwargs or {}))

    device = torch.device(args.device)
    on_card = device.type == "cuda"

    def kernels(fn):
        if not on_card:
            return {}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        tally = chip_smoke.trace_records(
            prof.profiler.kineto_results.events())["kernels"]
        return {("GEMM " if chip_smoke._is_gemm(k) else "") + k: r["count"]
                for k, r in sorted(tally.items())}

    out = {"card": chip_smoke.card_line() if on_card else "cpu", "shape": {
        "rows": args.rows, "T": T, "D": D, "heads": HEADS, "lora_r": LORA_R}}
    g = torch.Generator(device=device).manual_seed(0)
    x0 = torch.randn(args.rows, T, D, device=device, generator=g,
                     dtype=torch.bfloat16)
    bias = torch.zeros(args.rows, 1, 1, T, device=device, dtype=torch.bfloat16)
    for fused in (False, True):
        with torch.device(device):
            layer = BertLayer(D, HEADS, lora_r=LORA_R, freeze_base=True,
                              dropout=0.0, gelu_approximate=True,
                              fused_qkv=fused, lora_fold=True,
                              dtype=torch.bfloat16)
        init = torch.Generator(device=device).manual_seed(1)
        for m in layer.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(init)
        with torch.no_grad():
            for m in layer.modules():
                if getattr(m, "lora_r", 0) > 0:
                    m.lora_B.normal_(0.0, 0.05, generator=g)
        x = x0.clone().requires_grad_(True)
        for _ in range(2):
            layer(x, bias).float().sum().backward()
        side = {}
        fwd, bwd = Products(), Products()
        with fwd:
            y = layer(x, bias).float().sum()
        with bwd:
            y.backward()
        side["products_forward"] = dict(fwd.seen)
        side["products_backward"] = dict(bwd.seen)
        side["kernels_forward"] = kernels(lambda: layer(x, bias))
        holder = {}

        def forward():
            holder["y"] = layer(x, bias).float().sum()
        forward()
        side["kernels_backward"] = kernels(lambda: holder["y"].backward())
        for k in ("products_forward", "products_backward"):
            side[k + "_n"] = sum(side[k].values())
        for k in ("kernels_forward", "kernels_backward"):
            side[k + "_gemms"] = sum(n for name, n in side[k].items()
                                     if name.startswith("GEMM "))
        out["fused" if fused else "unfused"] = side
        del layer, x
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
