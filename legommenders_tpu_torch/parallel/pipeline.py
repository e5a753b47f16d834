"""Pipeline parallelism (GPipe) of a layer stack over the pp axis.

The port of the JAX package's parallel/pipeline.py (`gpipe`,
`gpipe_tree`). JAX stacks the stages' parameters and runs one `shard_map`
scan over the ticks; here each pp rank holds the whole weights (JAX's
`params_shardings` does not shard over pp either) and runs only its own
stage's layers. JAX's tick schedule: M microbatches through P stages take
M + P - 1 ticks; at tick t stage 0 takes microbatch t, stage s works on
microbatch t - s, the last stage banks microbatch t - (P - 1), and a ring
shift hands each stage's output to the next. A stage with no microbatch at
a tick (the bubble, (P - 1) / (M + P - 1) of the ticks) passes its input
on without running its layers. The last stage's outputs are summed over
pp (every other rank gives zeros), so every rank holds them.

Differentiable end to end: the shift (parallel/mesh.ring_shift) shifts the
gradients back, the final sum's backward is the identity (every pp rank
holds the same result and the same gradient of it), and the input's
gradient, which only stage 0 computes, is summed over pp. Every rank's
graph makes the same transfers in the same order, forward and backward
(selects, not branches, keep a stage's idle ticks in the graph, and the
first tick's input takes a gradient on every rank), so one
backward through the schedule gives each stage's layers their gradients:
the step then sums the stage layers' gradients over pp
(parallel/mesh.reduce_gradients).

Under dp (`rows`: the dp axis) each rank takes its mb / n_dp rows of every
microbatch (JAX gpipe_tree's P(None, "dp")), and the outputs are gathered
over dp after (their backward sums the gradients over dp and keeps the
rank's rows).
"""
from typing import Callable, Optional, Sequence

import torch

from legommenders_tpu_torch.parallel.mesh import (
    Axis, copy_to_mp, gather_grad, reduce_from_mp, ring_shift,
)


def _flag(value: bool, device) -> torch.Tensor:
    return torch.tensor(bool(value), device=device)


def gpipe(stage_fn: Callable, x: torch.Tensor, axis: Axis,
          num_microbatches: int, extras: Sequence[torch.Tensor] = (),
          rows: Optional[Axis] = None) -> torch.Tensor:
    """Run this rank's stage (stage `axis.index` of `axis.size`) over `x`
    (B, ...), B % num_microbatches == 0, in pipeline.

    stage_fn(m, x_mb, *extras_mb) -> y_mb applies the rank's stage to
    microbatch m; `extras` are per-row tensors without gradient (an
    attention bias) handed to it with each microbatch's rows. Returns the
    (B, ...) outputs of the last stage on every rank of the axis."""
    P, s = axis.size, axis.index
    M = num_microbatches
    B = x.shape[0]
    assert B % M == 0, f"batch {B} % microbatches {M} != 0"
    mb = B // M
    split = rows is not None and rows.size > 1
    if split:
        assert mb % rows.size == 0, \
            f"microbatch {mb} rows do not divide over dp={rows.size}"
    k = mb // rows.size if split else mb

    def cut(t):
        t = t.reshape(M, mb, *t.shape[1:])
        return t[:, rows.index * k:(rows.index + 1) * k] if split else t

    xs = cut(copy_to_mp(x, axis))
    ex = [cut(e) for e in extras]
    first, last = s == 0, s == P - 1
    # a leaf that takes a gradient: every rank's shifts then enter the
    # graph, stage 0's (whose first output comes from its layers) and the
    # others' (whose first outputs pass the zeros on) alike
    act = torch.zeros_like(xs[0]).requires_grad_(torch.is_grad_enabled())
    outs = [torch.zeros_like(xs[0]) for _ in range(M)]
    ticks = M + P - 1
    for t in range(ticks):
        act_in = torch.where(_flag(first and t < M, x.device),
                             xs[min(t, M - 1)], act)
        m = t - s
        act_out = (stage_fn(m, act_in, *(e[m] for e in ex))
                   if 0 <= m < M else act_in)
        slot = min(max(t - (P - 1), 0), M - 1)
        outs[slot] = torch.where(_flag(last and t >= P - 1, x.device),
                                 act_out, outs[slot])
        if t < ticks - 1:
            act = ring_shift(act_out, axis)
    out = torch.stack(outs)
    out = reduce_from_mp(torch.where(_flag(last, x.device), out,
                                     torch.zeros_like(out)), axis)
    if split:
        out = gather_grad(out, rows, 1)
    return out.reshape(B, *out.shape[2:])
