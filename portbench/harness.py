"""The benchmark's harness: one cell, one run.

Everything that belongs to a configuration, a traffic mix, a kind of work
or a metric is found by its name:
  * configs/<config>.json (BENCHMARK.json names the file): the fixture's
    sizes (`data`), the program's model configuration (`model`), the
    reference's geometry and family (`reference`; the family's module is
    reference/<family>.py), how the weights are drawn (`weights`), the
    kernels the cell builds (`kernels`) and the precision of its control
    (`control`);
  * traffic/<mix>.json: the kind of work (`kind`) and the traffic's own
    parameters (batch, negatives, learning rate, metrics, weight sets);
  * kinds/<kind>.py: how that kind of work is driven, judged, controlled
    and counted (`drive`, `judge`, `controls`, the work of one unit);
  * metrics/<metric>.py: a reader `read(run)` of one metric (None where it
    finds nothing to read);
  * limits/<workload>.json: the limit of each number that decides
    `correct`.
A new configuration, mix, kind, family or metric is a new file.

A run: set-up (fixture, model, weights, kernels, warm-up; the first
training steps checked), then either the measured window (`--trace 0`) or
the traced run (`--trace 1`: unprofiled units timed, then a few profiled
ones); then the program's outputs are kept, its state freed, and the plain
reference works out the same outputs to judge them.
"""
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PORT = "legommenders_tpu_torch"


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_files(man: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and the metrics
    its run reports, by name."""
    cell = next((w for w in man["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT, conf["file"])
    traffic = load_json(BENCH, "traffic", f"{cell['traffic']}.json")
    limits = load_json(BENCH, "limits", f"{workload}.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "config": cfg, "traffic": traffic,
            "limits": limits,
            "end_to_end": [m for m in man["end_to_end"] if mine(m)],
            "per_layer": [m for m in man["per_layer"] if mine(m)]}


def load_module(folder: str, name: str):
    """portbench/<folder>/<name>.py, loaded once (names may hold dots)."""
    key = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(BENCH, folder, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def reader(name: str):
    return load_module("metrics", name).read


def kind(files: dict):
    """The module of the cell's kind of work."""
    return load_module("kinds", files["traffic"]["kind"])


def seed32(seed: int) -> int:
    """The program's seeds: its generators take (seed << 32) + step."""
    return int(seed) % (2 ** 31 - 1)


# ------------------------------------------------------------------------ #
# weights                                                                  #
# ------------------------------------------------------------------------ #
def draw_weights(shapes: dict, rules: list, seed: int, k: int, device):
    """Weight set k of the run: one normal draw on the device for all
    leaves (leaves in name order), each leaf then scaled and shifted by
    the first of the configuration's rules [pattern, mean, std] whose
    pattern it matches."""
    import re

    import torch

    names = sorted(shapes)
    numel = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device)
    g.manual_seed(seed32(seed) * 64 + k)
    flat = torch.randn(sum(numel), generator=g, device=device)
    out, off = {}, 0
    for name, n in zip(names, numel):
        mean, std = next((m, s) for pat, m, s in rules
                         if re.search(pat, name))
        out[name] = flat[off:off + n].view(shapes[name]).mul_(std).add_(mean)
        off += n
    return out


def load_weights(model, weights: dict):
    """Copy a weight set into the program's parameters (names and shapes
    must match the reference's)."""
    import torch

    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(
            f"the program's parameters differ from the reference's: "
            f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise RuntimeError(f"{name}: program {tuple(p.shape)}, "
                                   f"reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])


# ------------------------------------------------------------------------ #
class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, files: dict, seed: int, seconds: float, trace: bool,
                 device, log):
        self.files = files
        self.cfg, self.traffic = files["config"], files["traffic"]
        self.kind = kind(files)
        self.seed, self.seconds, self.trace_on = seed, seconds, trace
        self.device, self.log = device, log
        self.setup = {}
        self.setup_s = None
        self.window_s = None
        self.units = 0            # steps or passes completed in the window
        self.unit_rows = 0        # impressions a step, scored rows a pass
        self.unit_ms = []         # each unit's ms (a step's on the device)
        self.unit_s = None        # traced run: an unprofiled unit's median s
        self.spans = {}           # name -> [ms, ...] (eval)
        self.trace = None
        self.traced_units = 0
        self.counts = {}
        self.memory_peak = 0

    def timed(self, name, fn, *a, **kw):
        """fn(*a, **kw) as a part of set-up, ended by a synchronise."""
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        self.sync()
        self.setup[name] = time.perf_counter() - t0
        self.log(f"[setup] {name}: {self.setup[name]:.3f} s")
        return out

    def end_setup(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        other = self.setup_s - sum(self.setup.values())
        self.log(f"[setup] other: {other:.3f} s; setup_s {self.setup_s:.3f}")

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()


def counters():
    """The program's own launch counters of its kernel wrappers."""
    from legommenders_tpu_torch.ops.additive import additive_pool
    from legommenders_tpu_torch.ops.attention import packed_attention

    return {"additive_pool": additive_pool.launches,
            "packed_attention": packed_attention.launches}


def build_kernels(run):
    if run.device.type != "cuda":
        return
    from legommenders_tpu_torch.ops import build

    for name, out in build.build_all(run.cfg["kernels"]).items():
        if out:
            run.log(f"[setup] built {name}")
        build.library(name)


def manager(run, data):
    from legommenders_tpu_torch.runtime.manager import Manager

    exp = {"policy": dict(run.cfg["policy"]),
           "metrics": list(run.traffic.get("metrics") or [])}
    return Manager(model_cfg=run.cfg["model"], exp_cfg=exp, data=data,
                   device=run.device, seed=seed32(run.seed))


def free():
    """Once a kind's run returned (its locals, the program's state, gone)."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def marker(device):
    """A unit boundary: a CUDA event on the card (read after the units),
    the host clock on the CPU."""
    import torch

    if device.type == "cuda":
        def mark():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return mark
    return time.perf_counter


def elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def memory_peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if device.type == "cuda" else 0


def units(run, unit, device_marks: bool, seconds=None, count=None):
    """Units back to back, with no synchronise between them, until
    `seconds` have passed (the window) or `count` are done; (per-unit ms,
    host seconds from the first dispatch to the device's end). Each unit's
    ms comes from CUDA events at its boundaries where `device_marks`, else
    from the host clock."""
    mark = marker(run.device) if device_marks else time.perf_counter
    run.sync()
    t0 = time.perf_counter()
    marks = [mark()]
    while True:
        unit()
        marks.append(mark())
        if (count is not None and len(marks) > count) or (
                seconds is not None
                and time.perf_counter() - t0 >= seconds):
            break
    run.sync()
    total = time.perf_counter() - t0
    return [elapsed_ms(a, b) for a, b in zip(marks, marks[1:])], total


# ------------------------------------------------------------------------ #
def run_cell(files: dict, seed: int, seconds: float, trace: bool, device,
             log=print, t0=None, setup=None) -> dict:
    """One run of a cell: the result object (the contract's keys) with the
    compared numbers under `checks`. `setup`: parts of set-up timed before
    (imports, the card)."""
    import torch

    from portbench import compare, fixture

    device = torch.device(device)
    run = Run(files, seed, seconds, trace, device, log)
    run.t0 = time.perf_counter() if t0 is None else t0
    run.setup.update(setup or {})
    cfg = run.cfg
    arrays = run.timed("fixture", fixture.make, cfg["data"],
                       run.kind.PHASES, seed)
    data = run.timed("lego_data", fixture.lego_data, arrays, cfg["data"])
    prog, weights = run.kind.drive(run, arrays, data)
    del data
    free()
    t = time.perf_counter()
    numbers = run.kind.judge(run, arrays, prog, weights)
    log(f"[reference] {time.perf_counter() - t:.3f} s")
    log("[numbers] " + " ".join(f"{k} {v!r}" for k, v in numbers.items()))
    correct, checks = compare.check(numbers, files["limits"])

    metrics = {}
    wanted = files["per_layer"] if trace else files["end_to_end"]
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = run.traced_units if trace else run.units
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": 0 if correct else attempted, "metrics": metrics,
           "device": device_info(run)}
    if trace and run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    if run.unit_ms:
        ms = sorted(run.unit_ms)
        log(f"[window] {len(ms)} units in {run.window_s:.3f} s; ms min "
            f"{ms[0]:.3f} median {median(ms):.3f} max {ms[-1]:.3f}")
    if run.unit_s:
        log(f"[traced] {run.unit_s * 1e3:.3f} ms an unprofiled unit; "
            f"{run.traced_units} profiled in {run.trace.window_s:.3f} s, "
            f"{run.trace.busy_s:.3f} s busy")
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def device_info(run) -> dict:
    import torch

    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def p95(values) -> float:
    """The 95th percentile, by the nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def median(values) -> float:
    return statistics.median(values)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "legommenders_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: the port's begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
