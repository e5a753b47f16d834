"""IISAN operators: frozen-LM side-adapter item encoders.

The port of the JAX package's models/operators/iisan.py:25-139 (reference
model/operators/iisan_operator.py:51-216). The LM is always cached: its
slice `lm` (all `num_hidden_layers`, frozen, no LoRA) runs once over every
item with `collect_pooled`, giving each layer's masked mean over the
item's tokens, (N, num_hidden_layers, D) (`encode_lower`,
runtime/lm_cache.load_or_build_iisan_cache); the layers
`get_selected_layers` names (every `layer_selection_step`-th, shifted so
that the last layer is one of them) are gathered into the item contents.
At train and test time the operator runs only its side network over those
(B, H_sel, D) states: an optional bias-free projection `global_proj` of
every state, optional bias-free `local_proj_{i}` per selected layer, then
a chain of SANBlocks `san_{i}` that fuse the running state with the next
layer's through learned gates (`gates`, 0.5 at init, through a sigmoid),
and `linear` to the hidden size. The LM never runs in a training step.

The frozen slice runs the attention kernel (ops/attention.py) in the cache
build; JAX's IISAN slice runs XLA's attention, the same math at f32. The
gated mix is taken in f32, as jnp promotes a bf16 state times the f32
gate.
"""
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    FrozenableLayerNorm, dense, reset_linear,
)
from legommenders_tpu_torch.models.operators.lm_ops import (
    BertOperator, GLMOperator, LlamaOperator, OPTOperator,
)
from legommenders_tpu_torch.utils.registry import OPERATORS


class SANBlock(nn.Module):
    """fc_up (D -> 2D), ReLU, fc_down (2D -> D), LayerNorm(h + x) (flax's
    default eps 1e-6), in `dtype` (JAX iisan.py:25-36)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc_up = nn.Linear(dim, 2 * dim)
        self.fc_down = nn.Linear(2 * dim, dim)
        self.LayerNorm_0 = FrozenableLayerNorm(dim, 1e-6, dtype=dtype)

    def reset_parameters(self, generator=None):
        reset_linear(self.fc_up, generator)
        reset_linear(self.fc_down, generator)
        self.LayerNorm_0.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(dense(self.fc_up, x, self.dtype))
        h = dense(self.fc_down, h, self.dtype)
        return self.LayerNorm_0(h + x)


class IISANMixin:
    """What the four IISAN operators share over their LM family (JAX
    IISANMixin). `layer_selection_step`, `global_proj_size` and
    `local_proj_size` are its options; the LM's own (`tune_from`, LoRA,
    dropout) have no effect."""

    is_iisan = True

    def __init__(self, layer_selection_step: int = 2,
                 global_proj_size: Optional[int] = None,
                 local_proj_size: Optional[int] = None, **kw):
        # plain attributes, read by `build`
        self.layer_selection_step = int(layer_selection_step)
        self.global_proj_size = global_proj_size
        self.local_proj_size = local_proj_size
        super().__init__(**kw)

    @property
    def use_lm_cache(self) -> bool:
        return True

    @property
    def transformer_key(self) -> str:
        """The family's name in cache paths (JAX iisan.py:50-53)."""
        return (type(self).__name__.replace("Operator", "")
                .replace("IISAN", "").lower())

    def get_selected_layers(self):
        """Every `layer_selection_step`-th layer, shifted so that the last
        layer is selected (JAX iisan.py:55-62)."""
        n, step = self.num_hidden_layers, self.layer_selection_step
        sel = list(range(0, n, step))
        margin = n - sel[-1] - 1
        return [s + margin for s in sel]

    def build(self, common: dict, pipeline_stages: int, **_):
        # the slice refuses pipeline_stages beside collect_pooled, as JAX's
        # slice does (JAX's IISAN operator drops the option)
        common = dict(common, fused_attention=True)
        self.lm = self.make_slice(0, self.num_hidden_layers, trainable=False,
                                  collect_pooled=True,
                                  pipeline_stages=pipeline_stages, **common,
                                  **self._lora_kwargs(trainable=False))
        self.lm.requires_grad_(False)
        n_sel = len(self.get_selected_layers())
        width = self.input_dim
        if self.global_proj_size:
            self.global_proj = nn.Linear(width, self.global_proj_size,
                                         bias=False)
            width = self.global_proj_size
        if self.local_proj_size:
            for i in range(n_sel):
                self.add_module(f"local_proj_{i}", nn.Linear(
                    width, self.local_proj_size, bias=False))
            width = self.local_proj_size
        for i in range(n_sel - 1):
            self.add_module(f"san_{i}", SANBlock(width, self.dtype))
        self.gates = nn.Parameter(torch.full((n_sel - 1,), 0.5))
        self.linear = nn.Linear(width, self.hidden_size)

    def reset_parameters(self, generator=None):
        self.lm.reset_parameters(generator)
        for m in self.children():
            if isinstance(m, nn.Linear):
                reset_linear(m, generator)
            elif isinstance(m, SANBlock):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.gates.fill_(0.5)

    def _local(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if not self.local_proj_size:
            return x
        return dense(getattr(self, f"local_proj_{i}"), x, self.dtype)

    def forward(self, states: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """states: the gathered cached (B, H_sel, D) selected-layer states
        (the mask, (B, 1) of ones, is not read)."""
        n_sel = len(self.get_selected_layers())
        if states.dim() != 3 or states.shape[1] != n_sel:
            raise ValueError(
                f"{type(self).__name__}: takes the cached states of its "
                f"{n_sel} selected layers (B, {n_sel}, D), got "
                f"{tuple(states.shape)}: build them first "
                f"(Manager.prepare_lm_cache)")
        x = states.to(self.dtype)
        if self.global_proj_size:
            x = dense(self.global_proj, x, self.dtype)
        current = self._local(x[:, 0], 0)
        gates = torch.sigmoid(self.gates)
        for i in range(n_sel - 1):
            nxt = self._local(x[:, i + 1], i + 1)
            g = gates[i]
            mixed = g * current.float() + (1 - g) * nxt.float()
            current = getattr(self, f"san_{i}")(mixed)
        return dense(self.linear, current, self.dtype)

    def encode_lower(self, embeddings: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        """The offline pass: every layer's pooled states (B,
        num_hidden_layers, D), in eval mode."""
        return self.lm(embeddings, mask)


@OPERATORS.register
class BertIISANOperator(IISANMixin, BertOperator):
    pass


@OPERATORS.register
class LlamaIISANOperator(IISANMixin, LlamaOperator):
    pass


@OPERATORS.register
class OPTIISANOperator(IISANMixin, OPTOperator):
    pass


@OPERATORS.register
class GLMIISANOperator(IISANMixin, GLMOperator):
    pass
