"""Token-embedding tables of local HF checkpoints: BERT / Llama / OPT / GLM.

The port of the JAX package's embedders/hf.py (reference
embedder/{bert,llama,opt,glm}_embedder.py). JAX reads the table through
`transformers.AutoModel`; the port reads the checkpoint's tensors itself
(`hf_loader.load_torch_state_dict`: `model.safetensors` or
`pytorch_model.bin`) and takes the family's word-embedding table under the
names its weight map reads (`hf_loader.word_embeddings`, with or without
the model prefix), exported as float32. It imports no `transformers`.
"""
import numpy as np
import torch

from legommenders_tpu_torch.embedders.base import BaseEmbedder
from legommenders_tpu_torch.models.lm import hf_loader
from legommenders_tpu_torch.utils.registry import EMBEDDERS


class HFEmbedder(BaseEmbedder):
    """The word-embedding table of a local checkpoint of `family`."""
    family = "bert"

    def get_embeddings(self) -> np.ndarray:
        if not self.model_path:
            raise FileNotFoundError(
                f"{self.name()} requires a local HF checkpoint path "
                f"(model_path=...)")
        sd = hf_loader.load_torch_state_dict(self.model_path)
        table = hf_loader.word_embeddings(sd, self.family)
        return table.to(torch.float32).numpy()


@EMBEDDERS.register
class BertBaseEmbedder(HFEmbedder):
    vocab_name = "bert"

    def name(self):
        return "bertbase"


@EMBEDDERS.register
class BertLargeEmbedder(HFEmbedder):
    vocab_name = "bert"

    def name(self):
        return "bertlarge"


@EMBEDDERS.register
class LlamaEmbedder(HFEmbedder):
    vocab_name = "llama"
    family = "llama"

    def name(self):
        return "llama"


@EMBEDDERS.register
class OPTEmbedder(HFEmbedder):
    vocab_name = "opt"
    family = "opt"

    def name(self):
        return "opt"


@EMBEDDERS.register
class GLMEmbedder(HFEmbedder):
    vocab_name = "glm"
    family = "glm"

    def name(self):
        return "glm"
