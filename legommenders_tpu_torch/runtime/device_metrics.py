"""Device-resident group-metric engine in torch.

The port of the JAX package's runtime/device_metrics.py:39-199 with the
same semantics as the numpy engine in runtime/metrics.py (the oracle in
tests/test_torch_metrics.py):
  * a group-major, score-descending STABLE sort (two stable torch.sorts,
    the same tie order as np.lexsort);
  * group starts/ends from cummax/cummin over the sorted order;
  * exact integer cumsums + boundary gathers for in-group positive counts
    and AUC tie-run rank totals (f32 counts stay integral below 2^24, the
    rank totals use int64);
  * ONE stacked `index_add_` for every per-group sum;
  * a two-pass (mean + correction) group mean.
These are plain torch ops; no custom kernel is involved.
"""
from typing import Tuple

import torch

# metric names the engine can compute; anything else falls back to host
DEVICE_SUPPORTED = {"GAUC", "MRR", "MRR0", "LRAP", "NDCG", "HitRatio",
                    "Recall"}


def _gmean(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean with a first-order correction pass (f32-safe)."""
    cnt = valid.sum().float()
    zero = torch.zeros_like(vals)
    v = torch.where(valid, vals, zero)
    denom = cnt.clamp(min=1.0)
    m0 = torch.where(cnt > 0, v.sum() / denom, 0.0)
    corr = torch.where(valid, vals - m0, zero).sum()
    return torch.where(cnt > 0, m0 + corr / denom, 0.0)


def _cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), dim=0).values.flip(0)


def _compute(scores: torch.Tensor, labels: torch.Tensor, groups: torch.Tensor,
             specs: Tuple[Tuple[str, int, str], ...], max_groups: int = 0):
    """specs: ((metric_name, k, output_key), ...). max_groups: an upper
    bound on the DISTINCT group count (0 = n) — the width of the stacked
    scatter; a bound that is too small would drop updates, so callers pass
    an exact count or a true upper bound. Returns {output_key: 0-d f32}."""
    n = scores.shape[0]
    dev = scores.device
    scores = scores.float()
    labels = labels.float()
    groups = groups.to(torch.int32)

    # group-major, score-descending, stable (np.lexsort((-s, g)) order)
    order = torch.sort(-scores, stable=True).indices
    order = order[torch.sort(groups[order], stable=True).indices]
    gid, s, lab = groups[order], scores[order], labels[order]
    idx = torch.arange(n, device=dev)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    change = torch.cat([true1, gid[1:] != gid[:-1]])

    # per-element group start/end offsets without scatters
    start = torch.cummax(torch.where(change, idx, 0), dim=0).values
    change_end = torch.cat([change[1:], true1])
    end = _cummin_reverse(torch.where(change_end, idx, n - 1))

    rank = (idx - start).float() + 1.0
    size = (end - start + 1).float()

    # in-group inclusive positive count (exact: f32 cumsum of 0/1)
    inc_lab = torch.cumsum(lab, dim=0)
    ex_lab = inc_lab - lab
    cum_in = inc_lab - ex_lab[start]

    names = {name for name, _, _ in specs}
    cols = {"lab": lab}   # name -> per-element summand of the ONE scatter
    if "MRR" in names:
        cols["mrr"] = lab / rank
    if "MRR0" in names:
        # exactly one element per group is the first positive in score
        # order; its 1/rank is the group MRR0
        cols["mrr0"] = torch.where((lab > 0) & (cum_in == 1.0),
                                   1.0 / rank, 0.0)
    if "LRAP" in names:
        cols["lrap"] = torch.where(lab > 0, cum_in / rank, 0.0)
    if "NDCG" in names:
        disc = 1.0 / torch.log2(rank + 1.0)
    for name, k, _key in specs:
        if name == "NDCG":
            cols[f"dcg{k}"] = lab * disc * (rank <= k)
        elif name in ("HitRatio", "Recall"):
            cols.setdefault(f"hits{k}", lab * (rank <= k))

    # per-element group positive total: inclusive cumsum at the group end
    # minus the exclusive cumsum at the group start
    pos_cnt = inc_lab[end] - ex_lab[start]
    if "NDCG" in names:
        for name, k, _key in specs:
            if name == "NDCG":
                cols[f"idcg{k}"] = disc * (rank <= pos_cnt.clamp(max=float(k)))

    if "GAUC" in names:
        # average ascending rank over (group, score) tie runs == sklearn;
        # run totals from an int64 cumsum (exact) and boundary gathers
        asc_i = end - idx
        false1 = torch.zeros(1, dtype=torch.bool, device=dev)
        same = torch.cat([false1, (gid[1:] == gid[:-1]) & (s[1:] == s[:-1])])
        rstart = torch.cummax(torch.where(~same, idx, 0), dim=0).values
        rchange_end = torch.cat([~same[1:], true1])
        rend = _cummin_reverse(torch.where(rchange_end, idx, n - 1))
        inc_asc = torch.cumsum(asc_i, dim=0)
        ex_asc = inc_asc - asc_i
        run_sum = (inc_asc[rend] - ex_asc[rstart]).float()
        run_cnt = (rend - rstart + 1).float()
        avg_rank = run_sum / run_cnt + 1.0
        cols["spr"] = avg_rank * lab
        cols["ones"] = torch.ones_like(lab)   # group sizes

    # ---- the ONE stacked segment scatter --------------------------------
    seg = torch.cumsum(change.to(torch.int64), dim=0) - 1   # dense 0..G-1
    num_groups = change.sum()
    ns = int(max_groups) if max_groups else n
    gvalid = torch.arange(ns, device=dev) < num_groups
    keys = list(cols)
    stacked = torch.stack([cols[c] for c in keys], dim=1)    # (n, m)
    seg_tot = torch.zeros((ns, len(keys)), dtype=torch.float32, device=dev)
    seg_tot.index_add_(0, seg, stacked)
    tot = {c: seg_tot[:, i] for i, c in enumerate(keys)}

    # per-group values below are indexed by dense segment id
    pos_g = tot["lab"]
    out = {}
    for name, k, key in specs:
        if name == "GAUC":
            neg_g = tot["ones"] - pos_g
            auc_g = (tot["spr"] - pos_g * (pos_g + 1.0) / 2.0) \
                / (pos_g * neg_g).clamp(min=1.0)
            out[key] = _gmean(auc_g, gvalid & (pos_g > 0) & (neg_g > 0))
        elif name == "MRR":
            out[key] = _gmean(tot["mrr"] / pos_g.clamp(min=1.0),
                              gvalid & (pos_g > 0))
        elif name == "MRR0":
            out[key] = _gmean(tot["mrr0"], gvalid)
        elif name == "LRAP":
            out[key] = _gmean(
                torch.where(pos_g > 0, tot["lrap"] / pos_g.clamp(min=1.0),
                            1.0), gvalid)
        elif name == "NDCG":
            idcg = tot[f"idcg{k}"]
            val = torch.where(idcg > 0,
                              tot[f"dcg{k}"] / idcg.clamp(min=1e-30), 0.0)
            out[key] = _gmean(val, gvalid)
        elif name == "HitRatio":
            out[key] = _gmean((tot[f"hits{k}"] > 0).float(), gvalid)
        elif name == "Recall":
            out[key] = _gmean(tot[f"hits{k}"] / pos_g.clamp(min=1.0),
                              gvalid & (pos_g > 0))
        else:
            raise ValueError(f"unsupported device metric {name}")
    return out


def compute_device(metrics, scores, labels, groups, max_groups: int = 0):
    """Run the engine for MetricPool `metrics` on device tensors; returns
    {str(metric): float} after ONE host copy of the scalar outputs."""
    specs = tuple((m.name, int(getattr(m, "n", 0) or 0), str(m))
                  for m in metrics)
    vals = _compute(scores, labels, groups, specs, max_groups)
    host = torch.stack([vals[key] for _, _, key in specs]).cpu().tolist()
    return {key: v for (_, _, key), v in zip(specs, host)}
