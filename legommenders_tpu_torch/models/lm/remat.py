"""What the LM page remat policies keep (models/legommender.py
`_encode_paged`; JAX models/legommender.py:186-205).

`ffn_dense` is the FFN's second dense layer of every LM layer (BERT
`ffn_output`, Llama `down_proj`, OPT `fc2`; the JAX package tags its
output `FFN_OUT_TAG`) as one operator of its own: a selective checkpoint
sees aten operators, not module names, so the `dots` policy can name it
(`FFN_DENSE_OP`) beside the aten products.

`ffn` keeps only these outputs (JAX `save_only_these_names(FFN_OUT_TAG)`)
through `FFNStash`, not through a selective checkpoint: the page's
checkpoint takes `FFNStash().contexts` as its `context_fn`; in the forward
each FFN output layer (`ffn_out`) keeps its output in the stash, and when
the backward recomputes the page each returns its kept output in the same
order (`_FFNReplay`) instead of running the product again. A selective
checkpoint runs a Python dispatch mode over every operator of a page, in
the forward and in the recompute; on bert-naml's host-bound training step
(127 pages of 512) that made `ffn` 1.5 times as slow as `full`, where the
stash is as fast (NVIDIA H100 80GB HBM3 at 700 W, `tools/ffn_remat_ab.py`).
`_FFNReplay` saves through `ffn_dense`'s own setup, so both nodes save the
same tensors in the same order, as the non-reentrant checkpoint matches
them by position.
"""
import contextlib
import contextvars
from typing import Optional

import torch


@torch.library.custom_op("legommenders_tpu_torch::ffn_dense", mutates_args=())
def ffn_dense(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ weight^T (+ bias, added after the product in x's dtype, as
    LoRADense adds it): the FFN's second dense layer as one operator."""
    y = x @ weight.t()
    return y + bias if bias is not None else y


@ffn_dense.register_fake
def _(x, weight, bias):
    return x.new_empty(tuple(x.shape[:-1]) + (weight.shape[0],))


def _ffn_dense_setup(ctx, inputs, output):
    x, weight, bias = inputs
    ctx.save_for_backward(x, weight)
    ctx.has_bias = bias is not None


def _ffn_dense_backward(ctx, g):
    x, weight = ctx.saved_tensors
    gx = g @ weight if ctx.needs_input_grad[0] else None
    g2 = g.reshape(-1, g.shape[-1])
    gw = (g2.t() @ x.reshape(-1, x.shape[-1])
          if ctx.needs_input_grad[1] else None)
    gb = (g2.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None)
    return gx, gw, gb


ffn_dense.register_autograd(_ffn_dense_backward, setup_context=_ffn_dense_setup)
# the operator a selective checkpoint sees for it
FFN_DENSE_OP = torch.ops.legommenders_tpu_torch.ffn_dense.default


class _FFNReplay(torch.autograd.Function):
    """`ffn_dense`'s node in a recomputed page: its output is the one the
    page's forward kept; it saves and differentiates as ffn_dense does."""

    @staticmethod
    def forward(ctx, x, weight, bias, kept):
        _ffn_dense_setup(ctx, (x, weight, bias), kept)
        return kept.view_as(kept)

    @staticmethod
    def backward(ctx, g):
        return _ffn_dense_backward(ctx, g) + (None,)


# (stash, replaying) while a page's forward or recompute runs
_ACTIVE = contextvars.ContextVar("ffn_stash", default=None)


class FFNStash:
    """One page's FFN outputs under the `ffn` policy; `contexts` is its
    checkpoint's `context_fn`: (the forward's context, which keeps them,
    the recompute's, which replays them). Only the kept outputs cost
    memory, tokens x D a trainable layer."""

    def __init__(self):
        self.kept, self.at = [], 0

    @contextlib.contextmanager
    def _scope(self, replaying: bool):
        self.at = 0
        token = _ACTIVE.set((self, replaying))
        try:
            yield
        finally:
            _ACTIVE.reset(token)

    def contexts(self):
        return self._scope(False), self._scope(True)


def ffn_out(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """An FFN output layer's product: `ffn_dense`, kept or replayed by the
    active FFNStash, if any."""
    active = _ACTIVE.get()
    if active is None:
        return ffn_dense(x, weight, bias)
    stash, replaying = active
    if not replaying:
        y = ffn_dense(x, weight, bias)
        stash.kept.append(y.detach())
        return y
    kept = stash.kept[stash.at]
    stash.at += 1
    return _FFNReplay.apply(x, weight, bias, kept)
