"""Runs one cell of the port's benchmark once, on the machine it is started
on:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `legommenders_tpu_torch`. The cell,
its configuration, traffic, metrics and limits are found by name from
BENCHMARK.json (portbench/harness.py). With `--trace 0` the last line of
standard output is the result with the cell's end-to-end metrics, with
`--trace 1` with its per-layer metrics read from a profiled window; both
carry `correct`, decided by the plain reference (portbench/reference/),
and under `checks`, last, each compared number beside its limit, which
also end standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program beside the benchmark, or
when JAX, flax or the JAX package is loaded by the end of the run.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the build and of the libraries at a fixed path inside the
# checkout; nothing that would load JAX
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"
# the bytecode of every module the run imports (torch, torch._dynamo,
# which the program's first optimizer and library calls load, the port)
# is cached there too, so that only a checkout's first run compiles it
# from source, even where the environment turns the writing off
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, ROOT)


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    if not os.path.isfile(os.path.join(ROOT, "BENCHMARK.json")):
        fail(2, f"no BENCHMARK.json in {ROOT}")
    files = harness.cell_files(harness.manifest(), args.workload)
    if not os.path.isfile(os.path.join(ROOT, harness.PORT, "__init__.py")):
        fail(2, f"the program ({harness.PORT}) is not in {ROOT}")

    import torch

    setup = {"imports": time.perf_counter() - T0}
    chips = int(files["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(3, f"the cell needs {chips} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                f" available")
    torch.set_num_threads(4)
    t = time.perf_counter()
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    setup["card"] = time.perf_counter() - t
    for name, s in setup.items():
        log(f"[setup] {name}: {s:.3f} s")

    out = harness.run_cell(files, args.seed, args.seconds, bool(args.trace),
                           "cuda", log=log, t0=T0, setup=setup)
    found = harness.forbidden_modules()
    if found:
        fail(4, f"modules of JAX or of the JAX package are loaded: {found}")
    for name, c in out["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
