"""GRUOperator — the LSTUR user encoder.

The port of the JAX package's models/operators/gru.py:16-37 (reference
gru_operator.py:18-54): a GRU over the click sequence, the hidden state
after the user's clicks, and a Linear back to input_dim.

The parameters are flax's GRUCell's, as they are: per layer `GRUCell_<i>`
holds `ir`, `iz`, `in` (input kernels with biases), `hr`, `hz` (recurrent
kernels without bias) and `hn` (recurrent kernel with bias). torch's GRU
has recurrent biases for r and z too, which flax has not: each call
assembles torch's weight_ih / weight_hh in (r, z, n) order with
bias_hh = [0, 0, b_hn] and runs one `torch.gru` over every layer, so the
equations are flax's exactly:
    r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h.
flax's `nn.RNN(seq_lengths=...)` returns the carry after `lengths` steps,
lengths = max(mask.sum(1), 1): it counts the mask's ones and does not look
at where they are. The GRU is causal, so the last layer's output at index
lengths - 1 of the padded run is that carry; it is gathered there (no
packed sequence: packing needs the lengths on the host). The recurrence
runs in f32 on the weights cast to the compute dtype; the result is cast
back.
"""
import warnings
from typing import Optional

import torch
from torch import nn

from legommenders_tpu_torch.models.common import dense, reset_linear
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.utils.registry import OPERATORS

_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


class GRUCell(nn.Module):
    """flax's GRUCell parameters: Linear modules named by gate (`in` is
    registered by name: it is a Python keyword)."""

    def __init__(self, input_dim: int, hidden_size: int):
        super().__init__()
        for gate in _GATES:
            fan_in = input_dim if gate[0] == "i" else hidden_size
            self.add_module(gate, nn.Linear(fan_in, hidden_size,
                                            bias=gate not in ("hr", "hz")))

    def gate(self, name: str) -> nn.Linear:
        return self._modules[name]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun_normal input kernels, orthogonal recurrent
        kernels, zero biases."""
        for name in _GATES:
            layer = self.gate(name)
            if name[0] == "i":
                reset_linear(layer, generator)
            else:
                nn.init.orthogonal_(layer.weight, generator=generator)
                if layer.bias is not None:
                    with torch.no_grad():
                        layer.bias.zero_()

    def torch_params(self, dtype: torch.dtype):
        """(weight_ih, weight_hh, bias_ih, bias_hh) of torch's GRU, in f32
        from the weights cast to `dtype`."""
        def w(name):
            return self.gate(name).weight.to(dtype).float()

        def b(name):
            return self.gate(name).bias.to(dtype).float()

        hn = b("hn")
        zero = torch.zeros_like(hn)
        return (torch.cat([w("ir"), w("iz"), w("in")]),
                torch.cat([w("hr"), w("hz"), w("hn")]),
                torch.cat([b("ir"), b("iz"), b("in")]),
                torch.cat([zero, zero, hn]))


@OPERATORS.register
class GRUOperator(BaseOperator):

    def __init__(self, hidden_size: int = 64, input_dim: int = 64,
                 num_layers: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(hidden_size, input_dim, dtype)
        self.num_layers = int(num_layers)
        for i in range(self.num_layers):
            self.add_module(f"GRUCell_{i}", GRUCell(
                input_dim if i == 0 else hidden_size, hidden_size))
        self.Dense_0 = nn.Linear(hidden_size, input_dim)
        self.reset_parameters()

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def cells(self):
        return [self._modules[f"GRUCell_{i}"] for i in range(self.num_layers)]

    def reset_parameters(self, generator=None):
        for cell in self.cells():
            cell.reset_parameters(generator)
        reset_linear(self.Dense_0, generator)

    def forward(self, embeddings: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L, _ = embeddings.shape
        if mask is None:
            lengths = torch.full((B,), L, device=embeddings.device)
        else:
            lengths = mask.long().sum(dim=1).clamp(min=1)
        params = [t for cell in self.cells()
                  for t in cell.torch_params(self.dtype)]
        x = embeddings.to(self.dtype).float()
        h0 = x.new_zeros(self.num_layers, B, self.hidden_size)
        with warnings.catch_warnings():
            # cuDNN copies weights that are not one flat buffer: they are
            # assembled anew each call anyway
            warnings.filterwarnings("ignore", message=".*contiguous chunk")
            # cuDNN keeps what its backward needs only in training mode
            # (no dropout here either way)
            out, _ = torch.gru(x, h0, params, True, self.num_layers, 0.0,
                               torch.is_grad_enabled(), False, True)
        carry = out[torch.arange(B, device=out.device), lengths - 1]
        return dense(self.Dense_0, carry, self.dtype)
