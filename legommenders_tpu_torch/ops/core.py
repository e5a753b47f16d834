"""Core functional ops on tensors, with the semantics of the JAX package's
ops/core.py:9-51.

  * masked positions score `finfo(dtype).min` before the softmax;
  * the softmax denominator adds `EPS`;
  * a row whose mask is all zero pools to 0.
"""
import torch

EPS = 1e-8


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Numerically-stable softmax over `dim` with a 0/1 `mask` (of the
    scores' shape, or one that broadcasts to it: a key mask is not
    expanded over the queries); all-masked rows return zeros."""
    mask = mask.to(scores.dtype)
    neg = torch.finfo(scores.dtype).min
    masked_scores = scores.masked_fill(~(mask > 0), neg)
    m = masked_scores.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(masked_scores - m) * mask
    return e / (e.sum(dim=dim, keepdim=True) + EPS)


def masked_mean(inputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(…, L, D) masked mean over L."""
    mask = mask.to(inputs.dtype)
    s = torch.einsum("...l,...ld->...d", mask, inputs)
    n = mask.sum(dim=-1, keepdim=True)
    return s / torch.clamp(n, min=1.0)


def masked_max(inputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(…, L, D) masked max over L; rows with an empty mask give 0."""
    neg = torch.finfo(inputs.dtype).min
    masked = torch.where(mask[..., None] > 0, inputs,
                         torch.full_like(inputs, neg))
    out = masked.amax(dim=-2)
    any_valid = (mask > 0).any(dim=-1, keepdim=True)
    return torch.where(any_valid, out, torch.zeros_like(out))
