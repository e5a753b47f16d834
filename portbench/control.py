"""The controls of a cell's correctness check: the plain reference put in
the program's place at the precision the configuration names for its
control (`control`: fp8 below the bf16 model; its metric engine at bf16,
below the program's float32 one) and at float32 with each fault of the
cell's kind (kinds/<kind>.py `controls`: for training, a loss over half of
each batch and a step that leaves the weights unchanged), compared with
the float32 reference by the numbers and limits a run uses. Each must come
out not correct.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \
        [--out FILE]

Runs on the card at the cell's own sizes (nothing of the program is
imported); prints one JSON line a seed, and writes them all to --out.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control(files: dict, seed: int, device) -> dict:
    from portbench import compare, fixture, harness, reference
    from portbench.reference.model import family

    reference.tf32_off()
    cfg = files["config"]
    kind = harness.kind(files)
    arrays = fixture.make(cfg["data"], kind.PHASES, seed)
    shapes = family(cfg["reference"]).parameter_shapes(cfg["reference"],
                                                       cfg["data"])
    W = harness.draw_weights(shapes, cfg["weights"], seed, 0, device)
    out = {"seed": seed, "workload": files["cell"]["name"]}
    for mode, res in kind.controls(files, arrays, W, seed, device).items():
        res["correct"] = compare.check(res["numbers"], files["limits"])[0]
        out[mode] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    files = harness.cell_files(harness.manifest(), args.workload)
    lines = []
    for seed in args.seeds:
        lines.append(json.dumps(control(files, seed, "cuda")))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
