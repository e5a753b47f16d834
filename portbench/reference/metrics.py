"""Group metrics of a scored test phase, plain numpy in float64.

Rows are grouped by impression, ranked by score descending within a
group (ties kept in row order). Per group, with P positives, N negatives
and ranks r of the positives:
  * GAUC: the mean over groups with P > 0 and N > 0 of the group's AUC,
    (sum of the positives' ascending ranks, ties averaged, - P (P+1)/2)
    / (P N);
  * MRR: the mean over groups with P > 0 of sum(1 / r) / P (Legommenders'
    mean over the positives);
  * NDCG@k: the mean over all groups of DCG@k / IDCG@k (0 where IDCG is 0),
    DCG@k = sum over positives with r <= k of 1 / log2(r + 1), IDCG@k the
    same with the positives first.
"""
import numpy as np

from portbench.reference.precision import round_values


def group_metrics(scores, labels, groups, names,
                  precision: str = "f64") -> dict:
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels, np.float64)
    g = np.asarray(groups, np.int64)
    order = np.lexsort((-s, g))
    s, y, g = s[order], y[order], g[order]
    n = len(s)
    first = np.ones(n, bool)
    first[1:] = g[1:] != g[:-1]
    starts = np.flatnonzero(first)
    sizes = np.diff(np.append(starts, n))
    rank = np.arange(n) - np.repeat(starts, sizes) + 1.0
    P = np.add.reduceat(y, starts)
    N = sizes - P
    out = {}
    for name in names:
        if name == "GAUC":
            tie = np.zeros(n, bool)
            tie[1:] = (g[1:] == g[:-1]) & (s[1:] == s[:-1])
            run_start = np.flatnonzero(~tie)
            run_id = np.cumsum(~tie) - 1
            asc = np.repeat(sizes, sizes) - rank + 1.0
            mean_rank = (np.add.reduceat(asc, run_start)
                         / np.diff(np.append(run_start, n)))[run_id]
            ok = (P > 0) & (N > 0)
            auc = (np.add.reduceat(mean_rank * y, starts)[ok]
                   - P[ok] * (P[ok] + 1) / 2) / (P[ok] * N[ok])
            auc = round_values(auc, precision)
            out[name] = float(auc.mean()) if ok.any() else 0.0
        elif name == "MRR":
            ok = P > 0
            mrr = round_values(np.add.reduceat(y / rank, starts)[ok] / P[ok],
                               precision)
            out[name] = float(mrr.mean()) if ok.any() else 0.0
        elif name.startswith("NDCG@"):
            k = int(name[5:])
            disc = 1.0 / np.log2(rank + 1.0)
            dcg = np.add.reduceat(y * disc * (rank <= k), starts)
            ideal = rank <= np.minimum(np.repeat(P, sizes), k)
            idcg = np.add.reduceat(disc * ideal, starts)
            ndcg = np.where(idcg > 0, dcg / np.where(idcg > 0, idcg, 1), 0.0)
            out[name] = float(round_values(ndcg, precision).mean())
        else:
            raise ValueError(f"no reference for metric {name}")
    return out
