"""Cross-network heads: DCN, DCNv2 (CrossNetV2 / CrossNetMix), GDCN.

The port of the JAX package's models/predictors/cross.py (reference
dcn_predictor.py:50-108, dcnv2_predictor.py:65-206 with the low-rank
mixture of experts and the four structures, the parallel DNN fed the
cross output as the reference feeds it; gdcn_predictor.py:41-109). Names
and layouts are flax's: CrossNet `w_<i>` (Dense to 1) and `b_<i>`;
CrossNetV2 `cross_<i>`; CrossNetMix `U_<i>` / `V_<i>` (E, D, r),
`C_<i>` (E, r, r), `bias_<i>` and the gates `gate_<i>_<e>`; GateCrossLayer
`w_<i>`, `wg_<i>`, `b_<i>`; the heads' `CrossNet_0`, `CrossNetV2_0`,
`CrossNetMix_0`, `GateCrossLayer_0`, `MLPLayer_0`, `stacked`, `parallel`
and the last `Dense_0`. An f32 parameter that JAX applies uncast (the
b_<i>, the mixture's factors) promotes the sum to f32 at bf16, as in JAX.
"""
from typing import Sequence

import torch
from torch import nn

from legommenders_tpu_torch.models.common import (
    MLPLayer, dense, einsum, glorot_normal_, reset_children, reset_linear,
)
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.parallel.mesh import (
    copy_to_mp, reduce_from_mp, shard_slice,
)
from legommenders_tpu_torch.utils.registry import PREDICTORS

STRUCTURES = ("crossnet_only", "stacked", "parallel", "stacked_parallel")


class CrossNet(nn.Module):
    """DCN v1: x_{l+1} = x_l + x0 <w_l, x_l> + b_l."""

    def __init__(self, dim: int, num_layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"w_{i}", nn.Linear(dim, 1, bias=False))
            self.register_parameter(f"b_{i}", nn.Parameter(torch.zeros(dim)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for i in range(self.num_layers):
            reset_linear(getattr(self, f"w_{i}"), generator)
            with torch.no_grad():
                getattr(self, f"b_{i}").zero_()

    def forward(self, x0):
        x = x0
        for i in range(self.num_layers):
            w = dense(getattr(self, f"w_{i}"), x, self.dtype)
            x = x + w * x0 + getattr(self, f"b_{i}")
        return x


class CrossNetV2(nn.Module):
    """DCN v2: x_{l+1} = x_l + x0 * (W_l x_l + b_l)."""

    def __init__(self, dim: int, num_layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"cross_{i}", nn.Linear(dim, dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        reset_children(self, generator)

    def forward(self, x0):
        x = x0
        for i in range(self.num_layers):
            x = x + x0 * dense(getattr(self, f"cross_{i}"), x, self.dtype)
        return x


class CrossNetMix(nn.Module):
    """The low-rank mixture-of-experts cross (DCNv2 paper; reference
    dcnv2_predictor.py:80-137): per layer and expert e, v = tanh(V_e^T x),
    v = tanh(C_e v), x0 * (U_e v + bias), mixed by a softmax over the
    gates <g_e, x>.

    Expert parallelism (JAX's mp sharding of U / V / C, GSPMD's combine):
    after `shard_experts` this rank holds experts [r E/n, (r+1) E/n). It
    computes every gate logit (the gates stay whole) and the outputs of
    its own experts weighted by the softmax over all experts; one
    all-reduce over mp sums the weighted outputs. x and x0 enter the
    experts through `copy_to_mp`, so their gradient sums the ranks'
    parts; the gates' and the bias's gradients are partial on each rank
    (parallel/mesh.ShardPlan.partial)."""

    def __init__(self, dim: int, num_layers: int = 2, low_rank: int = 32,
                 num_experts: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.num_experts = num_layers, num_experts
        self.dtype = dtype
        E, r = num_experts, low_rank
        for i in range(num_layers):
            for name, shape in (("U", (E, dim, r)), ("V", (E, dim, r)),
                                ("C", (E, r, r))):
                self.register_parameter(f"{name}_{i}",
                                        nn.Parameter(torch.empty(shape)))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.zeros(dim)))
            for e in range(E):
                self.add_module(f"gate_{i}_{e}", nn.Linear(dim, 1, bias=False))
        self.mp_axis = None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for i in range(self.num_layers):
            for name in ("U", "V", "C"):
                glorot_normal_(getattr(self, f"{name}_{i}"), generator)
            with torch.no_grad():
                getattr(self, f"bias_{i}").zero_()
            for e in range(self.num_experts):
                reset_linear(getattr(self, f"gate_{i}_{e}"), generator)

    def shard_experts(self, axis):
        """Keep this rank's experts of every layer's U, V and C."""
        for i in range(self.num_layers):
            for n in ("U", "V", "C"):
                p = getattr(self, f"{n}_{i}")
                p.data = shard_slice(p.data, 0, axis)
        self.mp_axis = axis

    def forward(self, x0):
        axis = self.mp_axis
        x = x0
        for i in range(self.num_layers):
            U, V, C = (getattr(self, f"{n}_{i}") for n in ("U", "V", "C"))
            xe, x0e = copy_to_mp(x, axis), copy_to_mp(x0, axis)
            gates = torch.stack(
                [dense(getattr(self, f"gate_{i}_{e}"), xe, self.dtype)[..., 0]
                 for e in range(self.num_experts)], dim=-1)
            gates = torch.softmax(gates, dim=-1)
            if axis is not None:
                k = U.shape[0]
                gates = gates[..., axis.index * k:(axis.index + 1) * k]
            v_x = torch.tanh(einsum("...d,edr->...er", xe, V))
            # C @ v (rows r, columns s): out[r] = sum_s C[r, s] v[s]
            v_x = torch.tanh(einsum("ers,...es->...er", C, v_x))
            uv_x = einsum("...er,edr->...ed", v_x, U)
            expert_out = x0e[..., None, :] * (uv_x
                                              + getattr(self, f"bias_{i}"))
            x = x + reduce_from_mp(
                einsum("...ed,...e->...d", expert_out, gates), axis)
        return x


class GateCrossLayer(nn.Module):
    """GDCN: x_{l+1} = x0 * (W_l x_l + b_l) * sigmoid(Wg_l x_l) + x_l."""

    def __init__(self, dim: int, num_layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"w_{i}", nn.Linear(dim, dim, bias=False))
            self.add_module(f"wg_{i}", nn.Linear(dim, dim, bias=False))
            self.register_parameter(f"b_{i}", nn.Parameter(torch.empty(dim)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for i in range(self.num_layers):
            reset_linear(getattr(self, f"w_{i}"), generator)
            reset_linear(getattr(self, f"wg_{i}"), generator)
            with torch.no_grad():
                # flax's uniform(1.0): [0, 1)
                getattr(self, f"b_{i}").uniform_(0.0, 1.0,
                                                 generator=generator)

    def forward(self, x0):
        x = x0
        for i in range(self.num_layers):
            xw = dense(getattr(self, f"w_{i}"), x, self.dtype)
            xg = torch.sigmoid(dense(getattr(self, f"wg_{i}"), x, self.dtype))
            x = x0 * (xw + getattr(self, f"b_{i}")) * xg + x
        return x


class _CrossHead(BasePredictor):
    """The cross heads' parameters: their submodules'."""

    def reset_parameters(self, generator=None):
        reset_children(self, generator)


@PREDICTORS.register
class DCNPredictor(_CrossHead):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 dnn_hidden_units: Sequence[int] = (1000, 1000, 1000),
                 dnn_activations: str = "relu", dnn_dropout: float = 0.0,
                 dnn_batch_norm: bool = False, cross_num: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        D = 2 * input_dim
        self.CrossNet_0 = CrossNet(D, cross_num, dtype)
        self.MLPLayer_0 = MLPLayer(D, dnn_hidden_units, None,
                                   dnn_activations, dnn_dropout,
                                   dnn_batch_norm, dtype=dtype)
        self.Dense_0 = nn.Linear(D + self.MLPLayer_0.out_dim, 1)
        self.reset_parameters()

    def score_pair(self, user, item, rng=None):
        x = torch.cat([user, item], dim=-1)
        out = torch.cat([self.CrossNet_0(x), self.MLPLayer_0(x, rng)], dim=-1)
        return dense(self.Dense_0, out, self.dtype).squeeze(-1)


@PREDICTORS.register
class DCNv2Predictor(_CrossHead):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 model_structure: str = "parallel",
                 use_low_rank_mixture: bool = False, low_rank: int = 32,
                 num_experts: int = 4,
                 stacked_dnn_hidden_units: Sequence[int] = (1000, 1000, 1000),
                 parallel_dnn_hidden_units: Sequence[int] = (1000, 1000,
                                                             1000),
                 dnn_activations: str = "relu", cross_num: int = 3,
                 dnn_dropout: float = 0.0, dnn_batch_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        if model_structure not in STRUCTURES:
            raise ValueError(f"DCNv2Predictor: model_structure "
                             f"{model_structure!r} is not one of "
                             f"{STRUCTURES}")
        self.model_structure = model_structure
        D = 2 * input_dim
        self.CrossNetMix_0 = self.CrossNetV2_0 = None
        if use_low_rank_mixture:
            self.CrossNetMix_0 = CrossNetMix(D, cross_num, low_rank,
                                             num_experts, dtype)
        else:
            self.CrossNetV2_0 = CrossNetV2(D, cross_num, dtype)

        def mlp(units):
            return MLPLayer(D, units, None, dnn_activations, dnn_dropout,
                            dnn_batch_norm, dtype=dtype)

        self.stacked = (mlp(stacked_dnn_hidden_units) if model_structure in
                        ("stacked", "stacked_parallel") else None)
        self.parallel = (mlp(parallel_dnn_hidden_units) if model_structure in
                         ("parallel", "stacked_parallel") else None)
        if model_structure == "crossnet_only":
            width = D
        elif model_structure == "stacked":
            width = self.stacked.out_dim
        elif model_structure == "parallel":
            width = D + self.parallel.out_dim
        else:
            width = self.stacked.out_dim + self.parallel.out_dim
        self.Dense_0 = nn.Linear(width, 1)
        self.reset_parameters()

    def score_pair(self, user, item, rng=None):
        x = torch.cat([user, item], dim=-1)
        cross = (self.CrossNetMix_0 or self.CrossNetV2_0)(x)
        s = self.model_structure
        if s == "crossnet_only":
            out = cross
        elif s == "stacked":
            out = self.stacked(cross, rng)
        elif s == "parallel":
            out = torch.cat([cross, self.parallel(cross, rng)], dim=-1)
        else:
            out = torch.cat([self.stacked(cross, rng),
                             self.parallel(cross, rng)], dim=-1)
        return dense(self.Dense_0, out, self.dtype).squeeze(-1)


@PREDICTORS.register
class GDCNPredictor(_CrossHead):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 dnn_hidden_units: Sequence[int] = (1000, 1000, 1000),
                 dnn_activations: str = "relu", dnn_dropout: float = 0.0,
                 dnn_batch_norm: bool = False, cross_num: int = 3,
                 sequential_mode: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, dtype)
        self.sequential_mode = sequential_mode
        D = 2 * input_dim
        self.GateCrossLayer_0 = GateCrossLayer(D, cross_num, dtype)
        self.MLPLayer_0 = MLPLayer(D, dnn_hidden_units,
                                   1 if sequential_mode else None,
                                   dnn_activations, dnn_dropout,
                                   dnn_batch_norm, dtype=dtype)
        self.Dense_0 = (None if sequential_mode
                        else nn.Linear(D + self.MLPLayer_0.out_dim, 1))
        self.reset_parameters()

    def score_pair(self, user, item, rng=None):
        x = torch.cat([user, item], dim=-1)
        cross = self.GateCrossLayer_0(x)
        if self.sequential_mode:
            return self.MLPLayer_0(cross, rng).squeeze(-1)
        out = torch.cat([cross, self.MLPLayer_0(x, rng)], dim=-1)
        return dense(self.Dense_0, out, self.dtype).squeeze(-1)
