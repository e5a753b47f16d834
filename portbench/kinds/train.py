"""The kind "train": the port's fused training step
(`DeviceTrainPipeline.make_fused_train_step`) over the `epoch_indices`
stream, back to back.

Set-up builds one step object, drives it through its first CHECK_STEPS
steps (their losses, the first gradient as Adam got it and the weights
after them are what the reference judges), then WARMUP_STEPS more. The
window then dispatches steps with no synchronise the program does not
make itself; each step's time comes from CUDA events at the step
boundaries. The traced run times TIMED_STEPS steps unprofiled (their
median sets the step's time for `mfu` and the idle share) and profiles
PROFILE_STEPS.

Traffic parameters (traffic/<mix>.json): batch_size, neg_count, lr.
"""
import itertools

import numpy as np

from portbench import compare, harness, reference, trace
from portbench.reference.model import family

PHASES = ("train",)
CHECK_STEPS = 3
WARMUP_STEPS = 2
TIMED_STEPS = 25
PROFILE_STEPS = 5
# a control's faults besides its precision: the loss over the first half
# of each batch; a step that leaves the weights as they were
FAULTS = ("half_batch", "unchanged")


def drive(run, arrays, data):
    import torch

    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline,
    )
    from legommenders_tpu_torch.ops import catalog_grad
    from legommenders_tpu_torch.runtime import steps

    tr, s = run.traffic, harness.seed32(run.seed)
    m = run.timed("model_and_plans", harness.manager, run, data)
    ref = run.cfg["reference"]
    shapes = family(ref).parameter_shapes(ref, run.cfg["data"])
    start = run.timed("weights", harness.draw_weights, shapes,
                      run.cfg["weights"], run.seed, 0, run.device)
    run.timed("load_weights", harness.load_weights, m.model, start)
    run.timed("kernels", harness.build_kernels, run)

    def pipeline():
        dp = DeviceTrainPipeline(data, batch_size=tr["batch_size"],
                                 neg_count=tr["neg_count"],
                                 use_neg_sampling=True, seed=s,
                                 device=run.device)
        opt = steps.adam(m.model, tr["lr"])
        return dp, opt, dp.make_fused_train_step(m.model, m.contents.columns,
                                                 opt, seed=s)

    dp, opt, step = run.timed("pipeline", pipeline)
    stream = itertools.chain.from_iterable(iter(dp.epoch_indices, None))
    names = {p: n for n, p in m.model.named_parameters()}

    def checked_steps():
        """The first steps, through the window's own call and feed; their
        losses, the first gradient (Adam's first moment / (1 - beta1)) and
        the weights after them."""
        batches, losses, grad = [], [], None
        for i in range(CHECK_STEPS):
            idx = next(stream)
            batches.append(idx.copy())
            losses.append(step(idx, i))
            if grad is None:
                b1 = opt.param_groups[0]["betas"][0]
                grad = {names[p]: st["exp_avg"].detach() / (1 - b1)
                        for p, st in opt.state.items()}
        trace = dict(catalog_grad.last_trace)
        if not (trace["live"] and trace["history"]):
            raise RuntimeError(f"the catalog gradient plans did not carry "
                               f"the step: {trace}")
        params = {n: p.detach().clone() for n, p in m.model.named_parameters()}
        return {"batches": batches, "loss": [float(x) for x in losses],
                "grad": grad, "params": params}

    prog = run.timed("checked_steps", checked_steps)
    count = itertools.count(CHECK_STEPS)

    def one_step():
        step(next(stream), next(count))

    run.timed("warm_up", lambda: [one_step() for _ in range(WARMUP_STEPS)])
    run.unit_rows = tr["batch_size"]
    run.end_setup()
    if run.trace_on:
        ms, _ = harness.units(run, one_step, True, count=TIMED_STEPS)
        run.unit_s = harness.median(ms) / 1e3
        before = harness.counters()

        def steps_traced():
            for _ in range(PROFILE_STEPS):
                with torch.profiler.record_function("portbench.step"):
                    one_step()

        run.trace = trace.profile(steps_traced)
        run.counts = {k: v - before[k] for k, v in harness.counters().items()}
        run.traced_units = PROFILE_STEPS
    else:
        run.unit_ms, run.window_s = harness.units(run, one_step, True,
                                                  seconds=run.seconds)
        run.units = len(run.unit_ms)
    run.memory_peak = harness.memory_peak(run.device)
    return prog, start


def judge(run, arrays, prog, start):
    reference.tf32_off()
    tr = run.traffic
    ref = reference.train_steps(run.cfg, arrays, start, prog["batches"],
                                harness.seed32(run.seed), tr["lr"],
                                tr["neg_count"], device=run.device)
    for number, gaps in compare.train_leaves(prog, ref, start).items():
        run.log(f"[leaves] {number} " + " ".join(
            f"{k}={v:.3e}" for k, v in sorted(gaps.items())))
    return compare.train_numbers(prog, ref, start)


# ------------------------------------------------------------------------ #
# the control                                                              #
# ------------------------------------------------------------------------ #
def first_batches(n: int, batch: int, steps: int, seed: int):
    """The first batches of the seed's first epoch, as the program's
    `DeviceTrainPipeline.epoch_indices` draws them."""
    perm = np.random.default_rng(seed).permutation(n)
    return [perm[i * batch:(i + 1) * batch].astype(np.int32)
            for i in range(steps)]


def controls(files: dict, arrays: dict, W: dict, seed: int, device) -> dict:
    """{mode: numbers} of the reference in the program's place at the
    configuration's control precision, and at float32 with each fault,
    against the float32 reference over the first CHECK_STEPS steps."""
    cfg, tr = files["config"], files["traffic"]
    s = harness.seed32(seed)
    batches = first_batches(len(arrays["train_user"]), tr["batch_size"],
                            CHECK_STEPS, s)
    args = (cfg, arrays, W, batches, s, tr["lr"], tr["neg_count"])
    ref = reference.train_steps(*args, device=device)
    out = {}
    for mode in (cfg["control"],) + FAULTS:
        ctl = reference.train_steps(
            *args, device=device,
            precision=cfg["control"] if mode == cfg["control"] else "f32",
            half_batch=mode == "half_batch", unchanged=mode == "unchanged")
        out[mode] = {"numbers": compare.train_numbers(ctl, ref, W),
                     "leaves": compare.train_leaves(ctl, ref, W)}
    return out


# ------------------------------------------------------------------------ #
# the work of one step, counted from the shapes                            #
# ------------------------------------------------------------------------ #
def pool_calls(cfg: dict, traffic: dict) -> list:
    """(N, L) of every pool launch of one step: the whole catalog's items,
    the batch's users."""
    data, ref = cfg["data"], cfg["reference"]
    fam = family(ref)
    return (fam.item_pool_calls(ref, data, data["items"])
            + fam.user_pool_calls(ref, data, traffic["batch_size"]))


def model_flops(cfg: dict, traffic: dict) -> float:
    """The model's operations in one step, counted on the items' and
    users' own positions: the whole catalog's encode, the batch's user
    pool and scores; the backward at twice the forward."""
    ref, data, fam = cfg["reference"], cfg["data"], family(cfg["reference"])
    B, K = traffic["batch_size"], traffic["neg_count"] + 1
    fwd = (data["items"] * fam.item_flops(ref, data)
           + fam.user_flops(ref, data, B) + 2.0 * B * K * ref["hidden"])
    return 3.0 * fwd

