"""The numbers that decide `correct`, each a gap between what the program's
timed path produced and what the reference works out, and their check
against the cell's limits (`portbench/limits/<workload>.json`).

Training (the first steps of the window's own step object):
  * loss: the largest relative gap of a step's loss;
  * grad: the first step's gradient as Adam got it (its first moment over
    1 - beta1), by the worst leaf: |‖g_program‖ - ‖g_reference‖| over the
    larger of that leaf's reference norm and the median leaf's;
  * update: the parameters' change over the steps, by the worst leaf
    likewise, leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's (Adam moves those by round-off).
Evaluation (a test pass of the window):
  * items, users, scores: the largest gap of an element of the cached
    item or user vectors, or of a test row's score, over the largest
    element of the reference's;
  * metrics: the largest gap of a group metric of the pass from the
    reference's group metrics of the pass's own scores (the metric engine
    judged on its input).
"""
import math
import statistics

SMALL_GRAD = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """Each leaf's gap of norms, over the larger of the leaf's and the
    median leaf's reference norm."""
    pn, rn = _norms(prog), _norms(ref)
    names = list(rn) if names is None else list(names)
    med = statistics.median(rn[k] for k in rn)
    gaps = {}
    for k in names:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def leaf_gap(prog: dict, ref: dict, names=None) -> float:
    """The worst leaf's gap of norms."""
    return max(leaf_gaps(prog, ref, names).values())


def moved_leaves(ref_grad: dict) -> list:
    gn = _norms(ref_grad)
    med = statistics.median(gn.values())
    return [k for k, v in gn.items() if v >= SMALL_GRAD * med]


def train_numbers(prog: dict, ref: dict, start: dict) -> dict:
    """prog and ref: {"loss": [...], "grad": {leaf: g}, "params": {leaf:
    after the steps}}; start: the weights before the first step."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                     ref["loss"]))
    if not all(math.isfinite(x) for x in prog["loss"]):
        loss = math.inf
    dp = {k: prog["params"][k].float() - start[k].float() for k in start}
    dr = {k: ref["params"][k].float() - start[k].float() for k in start}
    return {"loss": loss,
            "grad": leaf_gap(prog["grad"], ref["grad"]),
            "update": leaf_gap(dp, dr, moved_leaves(ref["grad"]))}


def train_leaves(prog: dict, ref: dict, start: dict) -> dict:
    """{number: {leaf: gap}} of the two leaf numbers, for the record."""
    dp = {k: prog["params"][k].float() - start[k].float() for k in start}
    dr = {k: ref["params"][k].float() - start[k].float() for k in start}
    return {"grad": leaf_gaps(prog["grad"], ref["grad"]),
            "update": leaf_gaps(dp, dr, moved_leaves(ref["grad"]))}


def rel_max_gap(prog, ref) -> float:
    gap = float((prog.float() - ref.float()).abs().max())
    return gap / max(float(ref.float().abs().max()), 1e-30) \
        if math.isfinite(gap) else math.inf


def eval_numbers(prog: dict, ref: dict, judged: dict) -> dict:
    """prog and ref: {"items", "users", "scores", "metrics"} of one pass;
    judged: the reference's metrics of the program's own scores."""
    gaps = [abs(prog["metrics"][k] - v) for k, v in judged.items()]
    return {"items": rel_max_gap(prog["items"], ref["items"]),
            "users": rel_max_gap(prog["users"], ref["users"]),
            "scores": rel_max_gap(prog["scores"], ref["scores"]),
            "metrics": max(g if math.isfinite(g) else math.inf
                           for g in gaps)}


def check(numbers: dict, limits: dict):
    """(correct, [[name, value, limit], ...]): every number with a limit
    must be finite and at most its limit."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit is None:
            continue
        rows.append([name, value, limit])
        ok = ok and math.isfinite(value) and value <= limit
    return ok, rows
