"""Ring attention over the sp axis: sequence-parallel attention with
rotating K/V blocks.

The port of the JAX package's ops/ring_attention.py (a shard_map with
lax.ppermute there; here each sp rank calls it on its own positions).
Each rank keeps its query block and streams every K/V block (and its key
mask) sp - 1 hops around the ring, keeping a flash-style online softmax
in f32 (running row max and row sum; a row that has seen only masked keys
so far keeps max -inf and weight 0). Exact to dense masked attention; a
query row whose keys are all masked gives 0 (the `+1e-8`). The result is
cast back to the input dtype. The shift is parallel/mesh.ring_shift,
whose backward shifts the gradients the other way. No head constraint.
"""
import torch

from legommenders_tpu_torch.parallel.mesh import Axis, ring_shift


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, axis: Axis,
                   num_heads: int) -> torch.Tensor:
    """q, k, v (B, l, D) and mask (B, l): this rank's l positions. Returns
    (B, l, D), this rank's positions of the attention output."""
    B, l, D = q.shape
    H, d = num_heads, D // num_heads
    f32 = torch.float32
    qh = q.reshape(B, l, H, d).to(f32)
    kc = k.reshape(B, l, H, d).to(f32)
    vc = v.reshape(B, l, H, d).to(f32)
    mc = mask.to(f32)
    scale = 1.0 / torch.tensor(float(d), dtype=f32).sqrt()
    neg = torch.finfo(f32).min
    zero = torch.zeros((), dtype=f32, device=q.device)
    o = torch.zeros(B, H, l, d, dtype=f32, device=q.device)
    mx = torch.full((B, H, l), neg, dtype=f32, device=q.device)
    s = torch.zeros(B, H, l, dtype=f32, device=q.device)
    for hop in range(axis.size):
        valid = mc[:, None, None, :] > 0
        scores = torch.einsum("blhd,bkhd->bhlk", qh, kc) * scale
        scores = torch.where(valid, scores, torch.full_like(scores, neg))
        new_mx = torch.maximum(mx, scores.amax(dim=-1))
        safe_mx = torch.where(new_mx > neg / 2, new_mx, zero)
        e = torch.exp(scores - safe_mx[..., None]) * valid
        corr = torch.where(mx > neg / 2, torch.exp(mx - safe_mx), zero)
        o = o * corr[..., None] + torch.einsum("bhlk,bkhd->bhld", e, vc)
        s = s * corr + e.sum(dim=-1)
        mx = new_mx
        if hop != axis.size - 1:
            kc, vc = ring_shift(kc, axis), ring_shift(vc, axis)
            mc = ring_shift(mc, axis)
    out = o / (s[..., None] + 1e-8)
    return out.transpose(1, 2).reshape(B, l, D).to(q.dtype)
