from legommenders_tpu_torch.models.operators.base import BaseOperator
# import modules for registration side effects
from legommenders_tpu_torch.models.operators import (  # noqa: F401
    ada, attention, cnn, fastformer, flatten_ops, gru, iisan, lm_ops, poly,
    pooling, semantic, transformer,
)
