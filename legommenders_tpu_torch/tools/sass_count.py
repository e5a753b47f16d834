#!/usr/bin/env python3
"""Counts the machine instructions of one kernel's loop in a built library
of the port, by opcode, from `cuobjdump -sass`:

    python3 legommenders_tpu_torch/tools/sass_count.py --lib packed_attention \
        --kernel dropout_mask [--out FILE]

Builds csrc/<lib>.cu if needed (ops/build.py), disassembles it, takes the
first function whose name holds `--kernel`, and counts the instructions
between the target of its last backward branch and that branch: the body
of its innermost-last loop (for dropout_mask, one Philox4x32-10 draw and
its four byte stores per iteration). Prints one JSON object: the loop's
address range, its instruction count, the count by opcode (the mnemonic
before its first '.'), and by the pipe the opcode issues to (`PIPES`;
others under "other").
"""
import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)

# integer opcodes by the pipe that executes them on sm_90: multiply-adds
# on the FMA pipe, the rest on the integer ALU
PIPES = {"fma": ("IMAD",),
         "alu": ("LOP3", "IADD3", "ISETP", "SHF", "SEL", "IABS", "VIADD",
                 "LEA", "IMNMX", "PRMT", "FLO", "POPC")}

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")


def instructions(sass: str, kernel: str):
    """[(address, instruction text)] of the first function whose name
    holds `kernel`."""
    out, inside = [], False
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            if inside:
                break
            inside = kernel in m.group(1)
            continue
        m = _LINE.search(line)
        if inside and m:
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    words = text.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def loop_body(insts):
    """The instructions from the target of the last backward branch to the
    branch itself."""
    for addr, text in reversed(insts):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            return [(a, t) for a, t in insts if start <= a <= addr]
    raise ValueError("no backward branch: the kernel has no loop")


def count(insts) -> dict:
    ops = Counter(opcode(t) for _, t in insts)
    pipes = Counter()
    for op, n in ops.items():
        pipe = next((p for p, names in PIPES.items() if op in names), "other")
        pipes[pipe] += n
    return {"range": [hex(insts[0][0]), hex(insts[-1][0])],
            "instructions": len(insts), "by_pipe": dict(pipes),
            "by_opcode": dict(ops.most_common())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", required=True)
    ap.add_argument("--kernel", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    from legommenders_tpu_torch.ops import build

    build.build(args.lib)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.lib_path(args.lib)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    res = {"lib": args.lib, "kernel": args.kernel,
           **count(loop_body(instructions(sass, args.kernel)))}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
