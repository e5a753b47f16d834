"""What the reference's model families share: the additive-attention pool
(NAML's item pool), its parameters and its operations, and the Ada user
operator built on it (`ada_*`: the pool over the clicked items' vectors).

  h = tanh(x W1 + b1), s = h w2, a = masked softmax(s) (masked positions
  at float32's lowest, 1e-8 added to the denominator, an all-masked row
  pools to 0), out = sum_l a_l x_l.
"""
import torch

NEG = torch.finfo(torch.float32).min


def masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = s.masked_fill(mask <= 0, NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * mask
    return e / (e.sum(dim=-1, keepdim=True) + 1e-8)


def pool(W: dict, prefix: str, x: torch.Tensor, mask: torch.Tensor,
         q) -> torch.Tensor:
    """The additive pool of x (n, L, d) under mask (n, L)."""
    x = q(x)
    h = torch.tanh(x @ q(W[prefix + ".proj_kernel"])
                   + W[prefix + ".proj_bias"])
    a = masked_softmax(h @ q(W[prefix + ".query"])[:, 0], mask.float())
    return (a[..., None] * x).sum(dim=1)


def pool_shapes(prefix: str, d: int, h: int) -> dict:
    return {f"{prefix}.proj_kernel": (d, h), f"{prefix}.proj_bias": (h,),
            f"{prefix}.query": (h, 1)}


def pool_flops(n: int, L: int, d: int, h: int) -> float:
    """The pool's operations over n rows of L positions of width d."""
    return 2.0 * n * L * (d * h + h + d)


ADA = "user_op.attention"


def ada_shapes(ref: dict) -> dict:
    return pool_shapes(ADA, ref["hidden"], ref["pool_hidden"])


def ada_users(ref: dict, W: dict, clicks: torch.Tensor, mask: torch.Tensor,
              q) -> torch.Tensor:
    """User vectors from the clicked items' vectors (n, S, H)."""
    return pool(W, ADA, clicks, mask, q)


def ada_pool_calls(ref: dict, data: dict, n: int) -> list:
    """(N, L) of the pool launches that encode n users."""
    return [(n, data["history"][1])]


def ada_flops(ref: dict, data: dict, n: int) -> float:
    return pool_flops(n, data["history"][1], ref["hidden"],
                      ref["pool_hidden"])
