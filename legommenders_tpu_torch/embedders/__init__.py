from legommenders_tpu_torch.embedders.base import BaseEmbedder  # noqa: F401
from legommenders_tpu_torch.embedders import glove, hf  # noqa: F401
