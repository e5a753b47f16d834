"""The kind "eval": the port's `Tester.test()` passes back to back, each one
loading the next of the traffic's weight sets held on the device
(successive checkpoints, so that no pass reuses the last one's vectors),
rebuilding the repr caches, scoring every row of the test phase and
computing its group metrics.

Set-up warms up with WARMUP_PASSES passes, each timed by its stages. The
window counts only completed passes, each timed by the host clock. The
traced run times TIMED_PASSES whole passes unprofiled (their median
sets the pass's time for `mfu` and the idle share), then SPAN_PASSES
passes with their stages (`ReprCache.cache`, the scores,
`Evaluator.metrics`) timed apart, each ended by a synchronise, then
profiles PROFILE_PASSES.

Traffic parameters (traffic/<mix>.json): metrics, weight_sets.
"""
import logging
import time

from portbench import compare, harness, reference, trace, work
from portbench.reference.model import family

PHASES = ("test",)
WARMUP_PASSES = 1
TIMED_PASSES = 3
SPAN_PASSES = 1
PROFILE_PASSES = 1


def drive(run, arrays, data):
    import torch

    from legommenders_tpu_torch.runtime.tester import Tester

    tr = run.traffic
    m = run.timed("model_and_plans", harness.manager, run, data)
    ref = run.cfg["reference"]
    shapes = family(ref).parameter_shapes(ref, run.cfg["data"])
    sets = run.timed("weights", lambda: [
        harness.draw_weights(shapes, run.cfg["weights"], run.seed, k,
                             run.device)
        for k in range(tr["weight_sets"])])
    run.timed("kernels", harness.build_kernels, run)

    def make_tester():
        quiet = logging.getLogger("portbench.tester")
        quiet.propagate = False
        quiet.addHandler(logging.NullHandler())
        return Tester(m, log=quiet)

    tester = run.timed("tester", make_tester)
    ev = tester.evaluator
    state = {"pass": 0}
    results = []
    # the scores of the latest pass, as the evaluator scored them
    score = ev.score_phase_device

    def keep_scores(phase):
        state["scores"] = score(phase)
        return state["scores"]

    ev.score_phase_device = keep_scores

    def load():
        k = state["pass"] % len(sets)
        harness.load_weights(m.model, sets[k])
        return k

    def one_pass():
        k = load()
        results.append((k, tester.test()))
        state["pass"] += 1

    def staged_pass(record):
        """A pass in `evaluate`'s order, each stage ended by a synchronise
        and recorded by record(stage, seconds)."""
        k = load()
        for stage, fn in (("cache", ev.cache.cache),
                          ("score", lambda: ev.score_phase_device("test")),
                          ("metrics",
                           lambda: ev.metrics("test", state["scores"]))):
            t = time.perf_counter()
            out = fn()
            run.sync()
            record(stage, time.perf_counter() - t)
        results.append((k, out))
        state["pass"] += 1

    for i in range(WARMUP_PASSES):
        def record(stage, s, i=i):
            run.setup[f"warm_up.{i}.{stage}"] = s
            run.log(f"[setup] warm_up.{i}.{stage}: {s:.3f} s")
        staged_pass(record)
    run.unit_rows = ev.phase("test").n
    run.end_setup()
    if run.trace_on:
        ms, _ = harness.units(run, one_pass, False, count=TIMED_PASSES)
        run.unit_s = harness.median(ms) / 1e3
        for _ in range(SPAN_PASSES):
            staged_pass(lambda stage, s: run.spans.setdefault(
                stage, []).append(s * 1e3))
        before = harness.counters()

        def passes_traced():
            for _ in range(PROFILE_PASSES):
                k = state["pass"] % len(sets)
                with torch.profiler.record_function("portbench.load"):
                    load()
                with torch.profiler.record_function("portbench.cache"):
                    ev.cache.cache()
                with torch.profiler.record_function("portbench.score"):
                    scores = ev.score_phase_device("test")
                with torch.profiler.record_function("portbench.metrics"):
                    res = ev.metrics("test", scores)
                results.append((k, res))
                state["pass"] += 1

        run.trace = trace.profile(passes_traced)
        run.counts = {k: v - before[k] for k, v in harness.counters().items()}
        run.traced_units = PROFILE_PASSES
    else:
        run.unit_ms, run.window_s = harness.units(run, one_pass, False,
                                                  seconds=run.seconds)
        run.units = len(run.unit_ms)
    run.memory_peak = harness.memory_peak(run.device)
    k_last, res = results[-1]
    prog = {"items": ev.cache.item_repr.detach().float().clone(),
            "users": ev.cache.user_repr.detach().float().clone(),
            "scores": state["scores"].detach().float().clone(),
            "metrics": res}
    return prog, sets[k_last]


def judge(run, arrays, prog, weights):
    reference.tf32_off()
    names = run.traffic["metrics"]
    ref = reference.evaluate(run.cfg, arrays, weights, names,
                             device=run.device)
    judged = reference.metrics_of(prog["scores"], arrays, names)
    return compare.eval_numbers(prog, ref, judged)


def controls(files: dict, arrays: dict, W: dict, seed: int, device) -> dict:
    """{mode: numbers} of the reference in the program's place at the
    configuration's control precision (its metric engine a step below
    float32), against the float32 reference over a test pass."""
    cfg, names = files["config"], files["traffic"]["metrics"]
    ref = reference.evaluate(cfg, arrays, W, names, device=device)
    ctl = reference.evaluate(cfg, arrays, W, names,
                             precision=cfg["control"], device=device)
    judged = reference.metrics_of(ctl["scores"], arrays, names)
    return {cfg["control"]: {"numbers": compare.eval_numbers(ctl, ref,
                                                             judged)}}


# ------------------------------------------------------------------------ #
# the work of one pass, counted from the shapes                            #
# ------------------------------------------------------------------------ #
def _item_pages(cfg: dict) -> list:
    return work.pages(cfg["data"]["items"], work.cache_page(cfg))


def pool_calls(cfg: dict, traffic: dict) -> list:
    """(N, L) of every pool launch of one pass: each page of the item
    cache, then each page of the user cache."""
    data, ref = cfg["data"], cfg["reference"]
    fam = family(ref)
    return ([c for n in _item_pages(cfg)
             for c in fam.item_pool_calls(ref, data, n)]
            + [c for n in work.pages(data["users"], work.cache_page(cfg))
               for c in fam.user_pool_calls(ref, data, n)])


def attention_calls(cfg: dict, traffic: dict) -> list:
    """(B, T) of every attention launch of one pass."""
    ref, fam = cfg["reference"], family(cfg["reference"])
    return [c for n in _item_pages(cfg)
            for c in fam.page_attention(ref, cfg["data"], n)]


def gemm_flops(cfg: dict, traffic: dict):
    """The matrix products of one pass as the card runs them: the item
    encoder's (the family's count; None where it counts none) and the
    dot-product scores of every test row."""
    ref = cfg["reference"]
    enc = family(ref).gemm_flops(ref, cfg["data"], _item_pages(cfg))
    if enc is None:
        return None
    return enc + 2.0 * work.test_rows(cfg) * ref["hidden"]


def model_flops(cfg: dict, traffic: dict) -> float:
    """The model's operations in one pass, counted on the items' and
    users' own positions (no packing pad): the catalog's encode, every
    user's, every test row's score."""
    ref, data, fam = cfg["reference"], cfg["data"], family(cfg["reference"])
    return (data["items"] * fam.item_flops(ref, data)
            + fam.user_flops(ref, data, data["users"])
            + 2.0 * work.test_rows(cfg) * ref["hidden"])
