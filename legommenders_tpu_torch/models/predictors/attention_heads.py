"""Attention-based heads: AutoInt, DIN, MINER.

The port of the JAX package's models/predictors/attention_heads.py:
  * AutoIntPredictor (:22-61; reference autoint_predictor.py:32-107):
    stacked self-attention `attn_<i>` over the two fields (user, item)
    (ReLU out, no output projection), a `prediction` Dense over the
    flattened result, plus the MLP `MLPLayer_0` over the raw fields;
  * DINPredictor (:64-110; reference din_predictor.py:63-143): the
    candidate attends over the raw click sequence through the Dice MLP
    `att_mlp` over [c, s, c - s, c * s], then the MLP `dnn` over the
    pooled clicks. Ranking only; its user input is the null operator's
    {"embedding", "mask"}. Its Dice batch norm takes statistics over the
    whole (B, K, S) batch, padded clicks included, so its scores depend
    on the batch they are computed in, in JAX too;
  * MINERPredictor (:113-133; reference miner_predictor.py:18-64): user
    (B, C, D) codes, items (B, K, D) -> scores (B, K): the item-code
    products reduced by `score_type` "max", "mean", or "weighted" (a
    softmax over the codes of the items against gelu(Dense_0(user)),
    bias-free, exact erf). Matching only.
"""
from typing import Sequence

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    MLPLayer, MultiHeadSelfAttention, dense, einsum, gelu, reset_children,
    reset_linear,
)
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.utils.registry import PREDICTORS

SCORE_TYPES = ("weighted", "max", "mean")


@PREDICTORS.register
class MINERPredictor(BasePredictor):
    allow_ranking = False
    keep_input_dim = True

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 score_type: str = "weighted",
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        if score_type not in SCORE_TYPES:
            raise ValueError(f"MINERPredictor: score_type {score_type!r} is "
                             f"not one of {SCORE_TYPES}")
        self.score_type = score_type
        self.Dense_0 = (nn.Linear(input_dim, input_dim, bias=False)
                        if score_type == "weighted" else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.Dense_0 is not None:
            reset_linear(self.Dense_0, generator)

    def forward(self, user: torch.Tensor, items: torch.Tensor,
                rng=None) -> torch.Tensor:
        scores = einsum("bkd,bcd->bkc", items, user)
        if self.score_type == "max":
            return scores.amax(dim=-1)
        if self.score_type == "mean":
            return scores.mean(dim=-1)
        proj = gelu(dense(self.Dense_0, user, self.dtype))
        w = torch.softmax(einsum("bkd,bcd->bkc", items, proj), dim=-1)
        return (w * scores).sum(dim=-1)


@PREDICTORS.register
class AutoIntPredictor(BasePredictor):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 dnn_hidden_units: Sequence[int] = (1000, 1000, 1000),
                 dnn_activations: str = "relu", dnn_dropout: float = 0.0,
                 dnn_batch_norm: bool = False, num_attention_layers: int = 3,
                 num_attention_heads: int = 8, attention_dim: int = 64,
                 attention_dropout: float = 0.0,
                 attention_layer_norm: bool = False, use_scale: bool = False,
                 use_residual: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        self.num_attention_layers = num_attention_layers
        width = input_dim
        for i in range(num_attention_layers):
            self.add_module(f"attn_{i}", MultiHeadSelfAttention(
                width, num_attention_heads, attention_dim,
                dropout=attention_dropout, use_residual=use_residual,
                use_scale=use_scale, layer_norm=attention_layer_norm,
                relu_out=True, out_proj=False, dtype=dtype))
            width = attention_dim
        self.prediction = nn.Linear(2 * width, 1)
        self.MLPLayer_0 = (MLPLayer(2 * input_dim, dnn_hidden_units, 1,
                                    dnn_activations, dnn_dropout,
                                    dnn_batch_norm, dtype=dtype)
                           if dnn_hidden_units else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_children(self, generator)

    def score_pair(self, user, item, rng=None):
        fields = torch.stack([user, item], dim=-2)          # (..., 2, D)
        lead = fields.shape[:-2]
        x = fields.reshape(-1, 2, fields.shape[-1])
        for i in range(self.num_attention_layers):
            x = getattr(self, f"attn_{i}")(x, rng=rng)
        out = dense(self.prediction, x.reshape(*lead, -1),
                    self.dtype).squeeze(-1)
        if self.MLPLayer_0 is not None:
            out = out + self.MLPLayer_0(fields.reshape(*lead, -1),
                                        rng).squeeze(-1)
        return out


@PREDICTORS.register
class DINPredictor(BasePredictor):
    allow_matching = False

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 dnn_hidden_units: Sequence[int] = (),
                 dnn_activations: str = "relu",
                 attention_hidden_units: Sequence[int] = (),
                 attention_dropout: float = 0.0, net_dropout: float = 0.0,
                 batch_norm: bool = False, din_use_softmax: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        D = input_dim
        self.din_use_softmax = din_use_softmax
        self.att_mlp = MLPLayer(4 * D, tuple(attention_hidden_units) or (D,),
                                1, use_dice=True, dropout=attention_dropout,
                                batch_norm=batch_norm, dtype=dtype)
        self.dnn = MLPLayer(D, tuple(dnn_hidden_units) or (8 * D, 2 * D, D),
                            1, dnn_activations, net_dropout, batch_norm,
                            dtype=dtype)

    def reset_parameters(self, generator=None):
        reset_children(self, generator)

    def forward(self, user, items, rng=None):
        clicks, mask = user["embedding"], user["mask"]      # (B,S,D), (B,S)
        if isinstance(clicks, dict):
            # a SimpleInputer's columns, concatenated on S
            cols = list(clicks)
            mask = torch.cat([mask[c] for c in cols], dim=-1)
            clicks = torch.cat([clicks[c] for c in cols], dim=-2)
        # the (B, K, S, D) interaction tensor, every candidate at once
        c, cl = torch.broadcast_tensors(items[..., :, None, :],
                                        clicks[..., None, :, :])
        att_in = torch.cat([c, cl, c - cl, c * cl], dim=-1)
        w = self.att_mlp(att_in, rng).squeeze(-1)           # (B, K, S)
        m = mask[..., None, :].to(w.dtype)
        w = w * m
        if self.din_use_softmax:
            w = torch.softmax(torch.where(m > 0, w, torch.full_like(w, -1e9)),
                              dim=-1)
        pooled = einsum("bks,bsd->bkd", w, clicks)
        return self.dnn(pooled, rng).squeeze(-1)            # (B, K)
