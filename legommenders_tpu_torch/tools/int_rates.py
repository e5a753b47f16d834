#!/usr/bin/env python3
"""Measures, on one card, how many integer instructions of the kinds a
Philox4x32-10 draw is made of each SM issues per clock:

    python3 legommenders_tpu_torch/tools/int_rates.py [--iters N] [--out FILE]

Builds csrc/int_rates.cu at first use (ops/build.py), counts each of its
kernels' loop in the SASS (tools/sass_count.py), and runs each kernel REPS
times in one CTA of 1,024 threads on every SM, each thread running eight
independent chains of one instruction:
  - imad_wide: IMAD.WIDE.U32, the Philox round's 32 x 32 -> 64-bit product;
  - imad_hi: IMAD.HI.U32; imad: IMAD (the low half);
  - lop3: LOP3.LUT, the round's three-input XOR;
  - lop3_isetp: LOP3.LUT and ISETP (the keep compare) together;
  - philox_mix: IMAD.WIDE.U32 and LOP3.LUT one for one, as in a round;
  - imad_lop3: IMAD and LOP3.LUT one for one, both counted: 128 a clock
    if the FMA pipe and the integer ALU issue side by side, 64 if not;
  - philox_mix_2: IMAD.WIDE.U32 beside two LOP3.LUT, the mask kernel's
    mix: 32 a clock if the ALU's work hides under the products'.
A rate is the loop's instructions of that kind x iterations x 1,024 over
the CTA's span in SM clocks (clock64; median of the SMs), per SM per
clock; `issue` is every instruction of the loop, in warp instructions per
clock per SM (at most 4, one per scheduler); the SM clock is the span in
clocks over the span in %globaltimer nanoseconds. Prints one JSON object
(and writes it to --out) with the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import sass_count  # noqa: E402  (puts the checkout on sys.path)

REPS = 5
# op index of csrc/int_rates.cu -> (name, does a SASS mnemonic count)
OPS = {
    0: ("imad_wide", lambda m: m.startswith("IMAD.WIDE")),
    1: ("imad_hi", lambda m: m.startswith("IMAD.HI")),
    2: ("imad", lambda m: m == "IMAD" or m.startswith("IMAD.U32")),
    3: ("lop3", lambda m: m.startswith("LOP3")),
    4: ("lop3_isetp", lambda m: m.startswith(("LOP3", "ISETP"))),
    5: ("philox_mix", lambda m: m.startswith("IMAD.WIDE")),
    6: ("imad_lop3", lambda m: m == "IMAD" or m.startswith(("IMAD.U32",
                                                            "LOP3"))),
    7: ("philox_mix_2", lambda m: m.startswith("IMAD.WIDE")),
}


def loop_counts(sass: str, op: int):
    """(instructions of the op's kind, all instructions) in the loop of
    int_rate<op>."""
    body = sass_count.loop_body(sass_count.instructions(
        sass, f"int_rateILi{op}E"))
    hits = OPS[op][1]
    return (sum(1 for _, t in body if hits(sass_count.mnemonic(t))),
            len(body))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16384,
                    help="loop iterations (16 steps of 8 chains each)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("int_rates: no CUDA device", file=sys.stderr)
        return 1
    from legommenders_tpu_torch.ops import build

    lib = build.library("int_rates")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int_rates_run.argtypes = [i, i, i, p, p, p, p]
    lib.int_rates_run.restype = i
    lib.int_rates_error_string.argtypes = [i]
    lib.int_rates_error_string.restype = ctypes.c_char_p
    sass = sass_count.sass("int_rates")

    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = lib.int_rates_ctas_per_sm()
    threads = lib.int_rates_threads()
    blocks = sms * per_sm
    gen = torch.Generator(device=device).manual_seed(0)
    src = torch.randint(1, 2 ** 31, (1024,), generator=gen, device=device,
                        dtype=torch.int64).to(torch.int32)
    out = torch.empty(blocks * threads, dtype=torch.int32, device=device)
    cycles = torch.empty(blocks, 2, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    res = {"card": card, "torch": torch.__version__, "sms": sms,
           "ctas_per_sm": per_sm, "threads": threads, "iters": args.iters,
           "ops": {}}

    def run(op, iters):
        err = lib.int_rates_run(op, blocks, iters, src.data_ptr(),
                                out.data_ptr(), cycles.data_ptr(), stream)
        if err:
            raise RuntimeError(f"int_rates op {op}: "
                               f"{lib.int_rates_error_string(err).decode()}")

    for op, (name, _) in OPS.items():
        n_kind, n_all = loop_counts(sass, op)
        run(op, 16)  # warm-up
        rates, issue, clock, kernel_ms = [], [], [], []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run(op, args.iters)
            stop.record()
            torch.cuda.synchronize()
            spans = cycles.tolist()
            span = statistics.median(c for c, _ in spans)
            work = args.iters * threads * per_sm / span
            rates.append(n_kind * work)
            issue.append(n_all * work / 32)
            clock.append(statistics.median(c / ns for c, ns in spans))
            kernel_ms.append(start.elapsed_time(stop))
        res["ops"][name] = {
            "loop_instructions": n_all, "of_this_kind": n_kind,
            "per_clock_per_sm": {"median": statistics.median(rates),
                                 "min": min(rates), "max": max(rates)},
            "issue_warp_per_clock_per_sm": statistics.median(issue),
            "sm_clock_ghz": statistics.median(clock),
            "kernel_ms": statistics.median(kernel_ms),
        }
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
