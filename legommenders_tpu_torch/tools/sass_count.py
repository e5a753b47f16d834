#!/usr/bin/env python3
"""Counts the machine instructions of one kernel's loop in a built library
of the port, by opcode, from `cuobjdump -sass`:

    python3 legommenders_tpu_torch/tools/sass_count.py --lib packed_attention \
        --kernel dropout_maskILi8ELb0E --draws 4 [--out FILE]

Builds csrc/<lib>.cu if needed (ops/build.py), disassembles it, takes the
first function whose (mangled) name holds `--kernel` (dropout_maskILi8ELb0E:
the mask kernel's instance with 8-byte stores, the training page's), and
counts the instructions of its innermost loop: between the target of the
last backward branch whose range holds no other backward branch and that
branch (for dropout_mask, one unit of four Philox4x32-10 draws and its
two 8-byte stores). Prints one JSON object: the loop's address range, its
instruction count and that count per draw (`--draws`: draws per
iteration), the count by opcode (the mnemonic before its first '.'), by
IMAD form, by the pipe the opcode issues to (`PIPES`; others under
"other"), and the opcodes of an integer division sequence it holds
(`DIVISION`).
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

# the opcodes nvcc's integer division by a run-time value is made of
# (a float reciprocal estimate, then corrections; IABS for signed operands)
DIVISION = ("I2F", "F2I", "MUFU", "IABS")

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


def mnemonic(text: str) -> str:
    """The instruction's mnemonic with its modifiers (no predicate)."""
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def opcode(text: str) -> str:
    return mnemonic(text).split(".")[0]


def loops(insts):
    """(start, end) address of every backward branch's loop, in order."""
    out = []
    for addr, text in insts:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return out


def loop_body(insts):
    """The instructions of the innermost loop: from the target of the last
    backward branch whose range holds no other backward branch to the
    branch itself."""
    spans = loops(insts)
    inner = [(s, e) for s, e in spans
             if not any(s <= s2 and e2 < e for s2, e2 in spans
                        if (s2, e2) != (s, e))]
    if not inner:
        raise ValueError("no backward branch: the kernel has no loop")
    start, end = inner[-1]
    return [(a, t) for a, t in insts if start <= a <= end]


def count(insts, draws: int = 1) -> dict:
    ops = Counter(opcode(t) for _, t in insts)
    pipes = Counter()
    for op, n in ops.items():
        pipe = next((p for p, names in PIPES.items() if op in names), "other")
        pipes[pipe] += n
    return {"range": [hex(insts[0][0]), hex(insts[-1][0])],
            "instructions": len(insts), "draws": draws,
            "per_draw": len(insts) / draws, "by_pipe": dict(pipes),
            "by_opcode": dict(ops.most_common()),
            # IMAD.WIDE.U32, IMAD.HI.U32, IMAD.MOV.U32, ... apart
            "imad_forms": dict(Counter(
                mnemonic(t) for _, t in insts
                if opcode(t) == "IMAD").most_common()),
            "division": {op: ops[op] for op in DIVISION if ops[op]}}


def sass(lib: str) -> str:
    """`cuobjdump -sass` of csrc/<lib>.cu's library, built first if needed."""
    from legommenders_tpu_torch.ops import build

    build.build(lib)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", build.lib_path(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", required=True)
    ap.add_argument("--kernel", required=True)
    ap.add_argument("--draws", type=int, default=1,
                    help="Philox draws per iteration of the loop")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    res = {"lib": args.lib, "kernel": args.kernel,
           **count(loop_body(instructions(sass(args.lib), args.kernel)),
                   args.draws)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
