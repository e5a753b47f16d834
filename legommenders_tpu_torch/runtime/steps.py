"""Losses, the train steps and the eval step.

The port of the JAX package's runtime/steps.py (reference
legommender.py:114-118, 252-263): the model returns raw scores and the
loss lives here — cross-entropy over (B, K+1) scores with the positive at
column 0, or BCE-with-logits for pointwise ranking. A step takes an
explicit batch and an explicit dropout generator and updates the model's
parameters in place through a torch optimizer; `adam` builds
`optax.adam`'s update (betas 0.9 / 0.999, eps 1e-8 outside the square
root, no weight decay) over the trainable parameters.
`make_train_step_folded` draws each step's generator from (seed, step
index) (`step_generator`, as JAX folds the step index into its key);
`make_eval_step` runs the model in eval mode (no generator).
"""
from typing import Callable, Dict, Optional

import torch
from torch.nn import functional as F

from legommenders_tpu_torch.utils import spans


def neg_sampling_loss(scores: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with the positive always at column 0."""
    return -torch.log_softmax(scores, dim=-1)[..., 0].mean()


def ranking_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits over (B, 1) scores."""
    s = scores.reshape(-1)
    return F.binary_cross_entropy_with_logits(s,
                                              labels.reshape(-1).to(s.dtype))


def step_generator(seed: int, step_idx: int, device,
                   fold: int = 0) -> torch.Generator:
    """The generator of one step: seeded from (seed, step_idx), as JAX
    folds the step index into its key. A mesh step folds its dp index in
    too (`fold`), so that dp ranks draw different dropout for different
    rows while the mp ranks of one dp row draw alike, as JAX's activations
    replicated over mp do; index 0 draws what one process draws."""
    g = torch.Generator(device=device)
    key = (int(seed) << 32) + int(step_idx)
    if fold:
        key ^= (int(fold) * 0x9E3779B97F4A7C15) & (2 ** 63 - 1)
    g.manual_seed(key)
    return g


def trainable_parameters(model: torch.nn.Module):
    return [p for p in model.parameters() if p.requires_grad]


def adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) over the model's trainable parameters."""
    return torch.optim.Adam(trainable_parameters(model), lr=lr,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def make_loss_fn(model, item_contents: Dict[str, torch.Tensor],
                 use_neg_sampling: bool) -> Callable:
    """loss_fn(batch, rng) -> scalar loss of a training forward."""
    def loss_fn(batch, rng):
        scores = model(batch, item_contents, rng)
        if use_neg_sampling:
            return spans.region("lego.score", neg_sampling_loss, scores)
        return spans.region("lego.score", lambda s: ranking_loss(
            s, batch["label"]), scores)
    return loss_fn


def make_train_step(model, item_contents: Dict[str, torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    use_neg_sampling: bool = True) -> Callable:
    """step(batch, rng) -> loss (a 0-dim tensor, detached): one forward
    with dropout drawn from `rng`, the backward and the optimizer update."""
    loss_fn = make_loss_fn(model, item_contents, use_neg_sampling)

    def step(batch, rng):
        with spans.span("lego.zero_grad"):
            optimizer.zero_grad(set_to_none=True)
        with spans.span("lego.forward"):
            loss = loss_fn(batch, rng)
        with spans.span("lego.backward"):
            loss.backward()
        with spans.span("lego.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def make_train_step_folded(model, item_contents: Dict[str, torch.Tensor],
                           optimizer, use_neg_sampling: bool = True,
                           seed: int = 0) -> Callable:
    """step(batch, step_idx) -> loss: make_train_step with the dropout
    generator of (seed, step_idx) on the batch's device (JAX
    steps.py:77-93)."""
    train_step = make_train_step(model, item_contents, optimizer,
                                 use_neg_sampling)

    def step(batch, step_idx: int):
        device = next(iter(batch.values())).device
        return train_step(batch, step_generator(seed, step_idx, device))

    return step


def make_eval_step(model, item_contents: Dict[str, torch.Tensor],
                   item_reprs: Optional[torch.Tensor] = None) -> Callable:
    """step(batch) -> scores (B, K): the forward in eval mode (JAX
    steps.py:96-102); `item_reprs`, the catalog's reprs encoded before
    (catalog-parallel), in place of the item encode."""

    @torch.inference_mode()
    def step(batch):
        return model(batch, item_contents, item_reprs=item_reprs)

    return step
