"""The plain reference of the benchmark's recommenders, in float32 PyTorch:
an item encoder of the configuration's family, the additive-attention
user pool and the dot-product score.

It imports nothing of the program. Weights are a dict {name: tensor} under
the names of the program's parameters (so that one draw feeds both); the
shapes come from the configuration's `reference` block
(`parameter_shapes`). Inputs are the fixture's arrays as tensors: token
ids padded with -1.

A family is a module of this package named by the `reference` block's
`family` (`cnn.py`, `bert.py`; a new family is a new file). It gives the
model's `parameter_shapes`, its item and user operators (`items`,
`users`) and their work, counted from the shapes (`item_pool_calls`,
`user_pool_calls`, `item_flops`, `user_flops`, `page_attention`,
`gemm_flops`). What every family shares is here: the dot-product score
and the training loss, cross-entropy with the positive at column 0.
`q` is where the reference rounds (precision.CASTS): identity for the
reference, a lower precision for a control.
"""
import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def family(ref: dict):
    """The module of the configuration's family, found by its name."""
    name = ref["family"]
    key = f"portbench.reference.family_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(HERE, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def scores(user: torch.Tensor, cands: torch.Tensor, q) -> torch.Tensor:
    """(n, H) users x (n, K, H) candidates -> (n, K)."""
    return (q(user)[:, None, :] * q(cands)).sum(dim=-1)


def loss(s: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(s, dim=-1)[:, 0].mean()
