"""The benchmark's plain reference: what the program should compute, worked
out again in float32 PyTorch from the fixture's arrays and the weights the
benchmark drew (nothing of the program is imported or read, but its
outputs where they are judged).

  * `train_steps`: the first steps of training as the fused step states
    them: for step i, a generator on the device seeded (seed << 32) + i
    draws the negatives (uniform keys over each user's negative list, the
    K smallest kept, topped up with uniform item ids where a user has
    fewer than K) and then the family's dropout of the whole-catalog
    encode;
    the forward, the loss, the gradients and Adam (betas 0.9 / 0.999,
    eps 1e-8);
  * `evaluate`: the item and user vectors of a test pass, the scores of
    every test row and their group metrics (`metrics_of`, which also
    judges the program's metrics on the program's own scores).
Both run in blocks of rows, so that they fit beside nothing else on the
card. `q` names the precision (precision.CASTS): "f32" for the reference,
a lower one for a control (whose metric engine then rounds to bfloat16,
the step below the float32 of the program's engine). The faults a control
plants: `half_batch` takes the loss over the first half of each batch
only; `unchanged` leaves the weights as they were before the steps.
"""
import torch

from portbench.reference import model
from portbench.reference.metrics import group_metrics
from portbench.reference.precision import BELOW_F32, CASTS

ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


def _dev(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()
            if k in ("title", "category", "history", "neg", "train_user",
                     "train_item")}


def negatives(t: dict, users: torch.Tensor, K: int, num_items: int,
              g: torch.Generator) -> torch.Tensor:
    rows = t["neg"][users].long()
    invalid = rows < 0
    if rows.shape[1] < K:
        pad = K - rows.shape[1]
        rows = torch.cat([rows, rows.new_full((len(users), pad), -1)], 1)
        invalid = torch.cat([invalid, invalid.new_ones((len(users), pad))],
                            1)
    counts = (~invalid).sum(dim=1)
    keys = torch.rand(rows.shape, generator=g, device=rows.device)
    keys = torch.where(invalid, 2.0, keys)
    chosen = rows.clamp(min=0).gather(
        1, torch.topk(keys, K, dim=1, largest=False).indices)
    rand = torch.randint(0, num_items, (len(users), K), generator=g,
                         device=rows.device)
    need = torch.arange(K, device=rows.device)[None] >= counts[:, None]
    return torch.where(need, rand, chosen)


def train_steps(cfg: dict, arrays: dict, weights: dict, batches, seed: int,
                lr: float, K: int, precision: str = "f32",
                half_batch: bool = False, unchanged: bool = False,
                device="cuda") -> dict:
    """`batches`: the training rows of each step (as the program's stream
    gave them). Returns {"loss": [per step], "grad": {name: first step's
    gradient}, "params": {name: after the last step}}."""
    ref, q = cfg["reference"], CASTS[precision]
    fam = model.family(ref)
    t = _dev(arrays, device)
    N = t["title"].shape[0]
    W = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    out = {"loss": [], "grad": None}
    for step, rows in enumerate(batches):
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) << 32) + step)
        rows = torch.as_tensor(rows, device=device).long()
        users = t["train_user"][rows].long()
        pos = t["train_item"][rows].long()
        cands = torch.cat([pos[:, None],
                           negatives(t, users, K, N, g)], dim=1)
        reprs = fam.items(ref, W, t["title"].long(), t["category"], q,
                          rng=g)
        hist = t["history"][users].long()
        hmask = (hist >= 0).float()
        u = fam.users(ref, W, reprs[hist.clamp(min=0)], hmask, q)
        s = model.scores(u, reprs[cands], q)
        if half_batch:
            s = s[:len(s) // 2]
        lval = model.loss(s)
        grads = torch.autograd.grad(lval, list(W.values()))
        out["loss"].append(float(lval.detach()))
        with torch.no_grad():
            k = step + 1
            bc1, bc2 = 1 - ADAM["b1"] ** k, 1 - ADAM["b2"] ** k
            for (name, p), gr in zip(W.items(), grads):
                m[name].lerp_(gr, 1 - ADAM["b1"])
                v2[name].mul_(ADAM["b2"]).addcmul_(gr, gr, value=1 - ADAM["b2"])
                denom = (v2[name].sqrt() / bc2 ** 0.5).add_(ADAM["eps"])
                if not unchanged:
                    p.addcdiv_(m[name], denom, value=-lr / bc1)
        if out["grad"] is None:
            out["grad"] = {n: gr.detach() for n, gr in zip(W, grads)}
        del reprs, u, s, lval, grads
    out["params"] = {k: v.detach() for k, v in W.items()}
    return out


@torch.no_grad()
def evaluate(cfg: dict, arrays: dict, weights: dict, metric_names,
             precision: str = "f32", device="cuda",
             item_block: int = 2048, user_block: int = 8192,
             row_block: int = 1 << 20) -> dict:
    """{"items": (N, H), "users": (U, H), "scores": (rows,), "metrics":
    {name: value}} of a test pass."""
    ref, q = cfg["reference"], CASTS[precision]
    fam = model.family(ref)
    W = {k: v.float() for k, v in weights.items()}
    title = torch.as_tensor(arrays["title"], device=device).long()
    category = torch.as_tensor(arrays["category"], device=device)
    items = torch.cat([fam.items(ref, W, title[s:s + item_block],
                                 category[s:s + item_block], q)
                       for s in range(0, len(title), item_block)])
    hist = torch.as_tensor(arrays["history"], device=device).long()
    users = torch.cat([
        fam.users(ref, W, items[hist[s:s + user_block].clamp(min=0)],
                  (hist[s:s + user_block] >= 0).float(), q)
        for s in range(0, len(hist), user_block)])
    tu = torch.as_tensor(arrays["test_user"], device=device).long()
    ti = torch.as_tensor(arrays["test_item"], device=device).long()
    scores = torch.cat([
        model.scores(users[tu[s:s + row_block]],
                     items[ti[s:s + row_block]][:, None, :], q)[:, 0]
        for s in range(0, len(tu), row_block)])
    engine = BELOW_F32 if precision != "f32" else "f64"
    return {"items": items, "users": users, "scores": scores,
            "metrics": metrics_of(scores, arrays, metric_names, engine)}


def metrics_of(scores: torch.Tensor, arrays: dict, metric_names,
               precision: str = "f64") -> dict:
    """The group metrics of a test phase's scores."""
    return group_metrics(scores.float().cpu().numpy(), arrays["test_click"],
                         arrays["test_imp"], metric_names, precision)


def tf32_off():
    """Products in float32 on the card, not TF32 (the reference's
    precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
