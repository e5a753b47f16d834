from legommenders_tpu_torch.models.predictors.base import BasePredictor
# import modules for registration side effects
from legommenders_tpu_torch.models.predictors import (  # noqa: F401
    attention_heads, cross, ctr, dot, finalmlp, masknet, semantic_heads,
)
