#!/usr/bin/env python3
"""Times the kernels of one checkout of the port on one card, so that two
trees can be compared in one run (parent, change, change, parent):

    python3 legommenders_tpu_torch/tools/time_kernels.py --root DIR \
        [--kernels pool,attention,mask,tp,f32,long,pool_f32] [--out FILE]

Imports legommenders_tpu_torch from DIR (its kernels built there at first
use) and times, with chip_smoke.time_ms, REPS times each (median, min,
max), on chip_smoke.py's inputs taken from this checkout for either tree:
  - pool: the additive pool in bf16 at chip_smoke's pool shapes
    (chip_smoke.pool_inputs): the full item catalog (65,000 x 31) and user
    pool (20,000 x 50) over 20 calls, and one page of 512 at each length
    the main paths pool (L = 31, 34, 40, 50) over 50 calls;
  - attention: the packed-attention forward and backward at bert-naml's
    attention pages (chip_smoke.attention_inputs: 171 packed rows, D 768,
    12 heads, bf16; the training page, T = 120, at dropout 0.1 and 0, and
    the serving page, T = 102, at 0) and torch's
    scaled_dot_product_attention (forward, and forward + backward) over 50
    calls; and the wrapper's host cost per call: time.perf_counter over
    1,000 calls enqueued while a sleep kernel holds the card, so that no
    call waits for the device;
  - mask: the dropout keep-mask kernel at dropout 0.1 over 50 calls, at
    the training page (171 x 12 heads, T = 120, chip_smoke.mask_shape)
    and at the serving page's T = 102 (byte stores, staged);
  - tp (a tree whose kernels take `head_offset`): the forward and the
    backward at the local heads of a rank under tensor parallelism at
    mp 2, beside the whole page: bert-naml's training page at 6 heads of
    64 (D 384) at dropout 0.1 and head offsets 0 and 6, and the Llama
    training page (chip_smoke.DECODER_PAGES: 128 rows of T 128) at 16
    heads of 128 (D 2048) at dropout 0 and offset 16, against 32 heads;
    with each case's bound (chip_smoke.roof: the bytes of q, k, v, the
    output and the bias, and the products, at the local width) under
    "bounds_us";
  - f32: the f32 (3xTF32 tensor-core) forward and backward at bert-naml's
    attention pages in f32 (the training page at dropout 0.1 and 0, the
    serving page at 0; the backward at the training page) and at the
    decoder pages (chip_smoke.DECODER_PAGES: Llama / GLM dh 128 and OPT
    dh 64, serving and training, causal packed biases, dropout 0; the
    backward at the training pages), and torch's
    scaled_dot_product_attention at f32 with the float mask and the
    dropout (forward, and forward + backward at the training pages), with
    each page's bound at 3xTF32's 165 TFLOP/s and, beside it, at the CUDA
    cores' 67 (chip_smoke.roof) under "bounds_us";
  - long: the long-sequence pool (additive_pool_long) at the flatten user
    pools (chip_smoke.FLATTEN_POOLS: L 1,023 over a flatten_transformer
    step's 128 users and a test page's 512, L 495 over a
    flatten_fastformer step's 2,048 and a test page's 8,192; D 64, H 64),
    bf16 and f32;
  - pool_f32: the pool at f32 (additive_pool_kernel) at the item catalog
    and user pool (chip_smoke.POOLS), the CTR user pools
    (chip_smoke.CTR_POOLS), the semantic items (chip_smoke.SEMANTIC_POOLS:
    L 4 over 65,000) and phase 16's shapes (chip_smoke.P16_POOLS);
  with each pool's bound (chip_smoke.bound: f32 products at 3xTF32's 165
  TFLOP/s) under "bounds_us".
Prints one JSON object (and writes it to --out).
"""
import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

import chip_smoke  # noqa: E402  (no top-level torch or port import)

CALLS, REPS = 50, 5
KERNELS = ("pool", "attention", "mask", "tp", "f32", "long", "pool_f32")


def _stats(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def _host_us(torch, fn, calls=1000):
    """Host microseconds per call with the device queue kept busy."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _sdpa_fwd(F, qh, kh, vh, mask, p):
    import torch
    with torch.no_grad():
        F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                       dropout_p=p)


def _sdpa_fwd_bwd(F, qh, kh, vh, mask, p, gh):
    F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                   dropout_p=p).backward(gh)


def pool_cases(torch, device):
    """(name, fn, calls) of the pool at chip_smoke's shapes, bf16."""
    from legommenders_tpu_torch.ops.additive import additive_pool

    shapes = list(chip_smoke.POOLS.items())
    shapes += [(f"page L{L}", (chip_smoke.PAGE_N, L))
               for L in chip_smoke.PAGE_LS]
    return [(f"pool {name}", functools.partial(
                additive_pool, *chip_smoke.pool_inputs(
                    N, L, torch.bfloat16, device, seed=L)),
             chip_smoke.pool_iters(N))
            for name, (N, L) in shapes]


def _pool_at(torch, device, bounds, name, N, L, dtype_name, h, d):
    """(name, fn, calls) of the pool at (N, L, d, h) on chip_smoke's
    inputs; its bound (chip_smoke.bound) into `bounds`."""
    from legommenders_tpu_torch.ops.additive import additive_pool

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    bounds[name] = chip_smoke.bound(N, L, dtype_name, h, d)[0] * 1e3
    return (name, functools.partial(additive_pool, *chip_smoke.pool_inputs(
        N, L, dtype, device, seed=L, h=h, d=d)), chip_smoke.pool_iters(N))


def long_cases(torch, device, bounds):
    """(name, fn, calls) of the long pool at the flatten user pools, bf16
    and f32; fills `bounds`."""
    cases = []
    for pool, (L, h) in chip_smoke.FLATTEN_POOLS.items():
        _, batch, eval_batch = chip_smoke.FLATTEN_MODELS[pool.split()[0]]
        for n, where in ((batch, "step"), (eval_batch, "test page")):
            for dt in ("bf16", "f32"):
                cases.append(_pool_at(torch, device, bounds,
                                      f"long {pool} N {n} ({where}) {dt}",
                                      n, L, dt, h, chip_smoke.D))
    return cases


def pool_f32_cases(torch, device, bounds):
    """(name, fn, calls) of the pool at f32 at the catalog, user, CTR,
    semantic and phase 16 shapes; fills `bounds`."""
    c = chip_smoke
    shapes = [(name, N, L, c.H, c.D) for name, (N, L) in c.POOLS.items()]
    shapes += [(name, N, 50, h, c.D) for name, (N, h) in c.CTR_POOLS.items()]
    shapes += [(name, N, L, h, c.D)
               for name, (N, L, h) in c.SEMANTIC_POOLS.items()]
    shapes += [(name, N, L, c.H, d)
               for name, (N, L, d) in c.P16_POOLS.items()]
    return [_pool_at(torch, device, bounds, f"f32 {name}", N, L, "f32", h, d)
            for name, N, L, h, d in shapes]


def attention_cases(torch, device):
    """(name, fn, calls) of the attention kernels and SDPA at bert-naml's
    pages."""
    from torch.nn import functional as F
    from legommenders_tpu_torch.ops import attention as A

    seed = torch.tensor([20231], dtype=torch.int32, device=device)
    heads = chip_smoke.ATTN_PAGE["heads"]
    cases = []
    for page, cfg, s in (("train", chip_smoke.TRAIN_PAGE, 11),
                         ("serve", chip_smoke.ATTN_PAGE, 7)):
        q, k, v, bias = chip_smoke.attention_inputs(torch.bfloat16, device,
                                                    seed=s, page=cfg)
        B, T, Dm = q.shape
        g = torch.randn(q.shape, generator=torch.Generator(
            device=device).manual_seed(12), device=device).to(q.dtype)
        for p in ((0.1, 0.0) if page == "train" else (0.0,)):
            cases.append((f"{page} p{p} fwd", functools.partial(
                A.packed_attention, heads, p, q, k, v, bias, seed), CALLS))
            if page == "train":
                cases.append((f"{page} p{p} bwd", functools.partial(
                    A.packed_attention_backward, heads, p, q, k, v, bias,
                    seed, g), CALLS))
        # torch's own attention in its head-split layout, at the page's
        # first dropout: timed only
        p = 0.1 if page == "train" else 0.0
        qh, kh, vh = (t.view(B, T, heads, Dm // heads).transpose(1, 2)
                      .detach().requires_grad_(True) for t in (q, k, v))
        gh = g.view(B, T, heads, Dm // heads).transpose(1, 2)
        cases.append((f"{page} sdpa fwd", functools.partial(
            _sdpa_fwd, F, qh, kh, vh, bias[:, None], p), CALLS))
        if page == "train":
            cases.append((f"{page} sdpa fwd+bwd", functools.partial(
                _sdpa_fwd_bwd, F, qh, kh, vh, bias[:, None], p, gh), CALLS))
    return cases


def mask_cases(torch, device):
    """(name, fn, calls) of the keep-mask kernel at bert-naml's pages."""
    from legommenders_tpu_torch.ops.attention import dropout_keep_mask

    seed = torch.tensor([20231], dtype=torch.int32, device=device)
    return [(f"mask T{T}", functools.partial(
                dropout_keep_mask, heads, chip_smoke.TRAIN_DROPOUT, B, T,
                seed), CALLS)
            for B, heads, T in (chip_smoke.mask_shape(chip_smoke.TRAIN_PAGE),
                                chip_smoke.mask_shape(chip_smoke.ATTN_PAGE))]


def _bounds_us(B, T, Dm, xb, bb, precision="bf16"):
    """(forward, backward) bound in microseconds of one call at (B, T,
    Dm), chip_smoke's rule, at the peak rate of `precision`."""
    fwd, _ = chip_smoke.roof(4.0 * B * T * T * Dm,
                             4 * B * T * Dm * xb + B * T * T * bb, precision)
    bwd, _ = chip_smoke.roof(10.0 * B * T * T * Dm,
                             7 * B * T * Dm * xb + B * T * T * bb, precision)
    return fwd * 1e3, bwd * 1e3


def f32_cases(torch, device, bounds):
    """(name, fn, calls) of the f32 attention kernels and SDPA at f32 at
    bert-naml's pages and the decoder pages; fills `bounds`."""
    from torch.nn import functional as F
    from legommenders_tpu_torch.ops import attention as A

    seed = torch.tensor([20231], dtype=torch.int32, device=device)

    def bert(cfg, s):
        q, k, v, bias = chip_smoke.attention_inputs(torch.float32, device,
                                                    seed=s, page=cfg)
        g = torch.randn(q.shape, generator=torch.Generator(
            device=device).manual_seed(12), device=device)
        return q, k, v, bias, g

    pages = [("train", chip_smoke.ATTN_PAGE["heads"], (0.1, 0.0), True,
              lambda: bert(chip_smoke.TRAIN_PAGE, 11)),
             ("serve", chip_smoke.ATTN_PAGE["heads"], (0.0,), False,
              lambda: bert(chip_smoke.ATTN_PAGE, 7))]
    pages += [(name, cfg["heads"], (0.0,), cfg["train"],
               functools.partial(chip_smoke.decoder_attention_inputs, cfg,
                                 torch.float32, device, 5))
              for name, cfg in chip_smoke.DECODER_PAGES.items()]
    cases = []
    for page, heads, ps, train, make in pages:
        q, k, v, bias, g = make()
        B, T, Dm = q.shape
        xb, bb = q.element_size(), bias.element_size()
        bounds[f"f32 {page}"] = dict(
            zip(("fwd", "bwd"), _bounds_us(B, T, Dm, xb, bb, "tf32x3")),
            **dict(zip(("fwd_cuda_core", "bwd_cuda_core"),
                       _bounds_us(B, T, Dm, xb, bb, "f32"))))
        calls = CALLS if Dm < 4096 else CALLS // 5
        for p in ps:
            cases.append((f"f32 {page} p{p} fwd", functools.partial(
                A.packed_attention, heads, p, q, k, v, bias, seed), calls))
            if train:
                cases.append((f"f32 {page} p{p} bwd", functools.partial(
                    A.packed_attention_backward, heads, p, q, k, v, bias,
                    seed, g), calls))
        p = ps[0]
        qh, kh, vh = (t.view(B, T, heads, Dm // heads).transpose(1, 2)
                      .detach().requires_grad_(True) for t in (q, k, v))
        gh = g.view(B, T, heads, Dm // heads).transpose(1, 2)
        cases.append((f"f32 {page} sdpa fwd", functools.partial(
            _sdpa_fwd, F, qh, kh, vh, bias[:, None], p), calls))
        if train:
            cases.append((f"f32 {page} sdpa fwd+bwd", functools.partial(
                _sdpa_fwd_bwd, F, qh, kh, vh, bias[:, None], p, gh), calls))
    return cases


def tp_cases(torch, device, bounds):
    """(name, fn, calls) of the attention kernels at a TP rank's heads
    (and the whole page beside them); fills `bounds`."""
    from legommenders_tpu_torch.ops import attention as A

    seed = torch.tensor([20231], dtype=torch.int32, device=device)
    cases = []
    bert = chip_smoke.TRAIN_PAGE
    llama = chip_smoke.DECODER_PAGES["llama training"]
    for label, heads, offsets, p, make in (
            ("bert 12 heads", 12, (0,), 0.1, lambda: chip_smoke
             .attention_inputs(torch.bfloat16, device, seed=11, page=bert)),
            ("bert 6 heads", 6, (0, 6), 0.1, lambda: chip_smoke
             .attention_inputs(torch.bfloat16, device, seed=11,
                               page=dict(bert, D=384, heads=6))),
            ("llama 32 heads", 32, (0,), 0.0, lambda: chip_smoke
             .decoder_attention_inputs(llama, torch.bfloat16, device, 5)[:4]),
            ("llama 16 heads", 16, (16,), 0.0, lambda: chip_smoke
             .decoder_attention_inputs(dict(llama, D=2048, heads=16),
                                       torch.bfloat16, device, 5)[:4])):
        q, k, v, bias = make()
        g = torch.randn(q.shape, generator=torch.Generator(
            device=device).manual_seed(12), device=device).to(q.dtype)
        B, T, Dm = q.shape
        bounds[label] = dict(zip(("fwd", "bwd"), _bounds_us(
            B, T, Dm, q.element_size(), bias.element_size())))
        for o in offsets:
            cases.append((f"{label} offset {o} fwd", functools.partial(
                A.packed_attention, heads, p, q, k, v, bias, seed,
                head_offset=o), CALLS))
            cases.append((f"{label} offset {o} bwd", functools.partial(
                A.packed_attention_backward, heads, p, q, k, v, bias, seed,
                g, head_offset=o), CALLS))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ", ".join(KERNELS))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels: {kernels} is not a subset of {KERNELS}")
    # the tree under test comes before this checkout on the path
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    import legommenders_tpu_torch

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    res = {"root": os.path.abspath(args.root),
           "port": os.path.dirname(legommenders_tpu_torch.__file__),
           "card": card, "torch": torch.__version__}
    cases = []
    if "pool" in kernels:
        cases += pool_cases(torch, device)
    if "attention" in kernels:
        cases += attention_cases(torch, device)
        by_name = {name: fn for name, fn, _ in cases}
        with torch.no_grad():
            res["host_us_fwd"] = _host_us(torch, by_name["train p0.1 fwd"])
            res["host_us_bwd"] = _host_us(torch, by_name["train p0.1 bwd"])
    if "mask" in kernels:
        cases += mask_cases(torch, device)
    if {"tp", "f32", "long", "pool_f32"} & set(kernels):
        res["bounds_us"] = {}
    if "tp" in kernels:
        cases += tp_cases(torch, device, res["bounds_us"])
    if "f32" in kernels:
        cases += f32_cases(torch, device, res["bounds_us"])
    if "long" in kernels:
        cases += long_cases(torch, device, res["bounds_us"])
    if "pool_f32" in kernels:
        cases += pool_f32_cases(torch, device, res["bounds_us"])
    # outside no_grad: the SDPA case runs its backward
    times = {name: [] for name, _, _ in cases}
    for _ in range(REPS):
        for name, fn, calls in cases:
            times[name].append(chip_smoke.time_ms(fn, iters=calls) * 1e3)
    res["us"] = {name: _stats(xs) for name, xs in times.items()}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
