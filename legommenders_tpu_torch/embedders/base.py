"""Offline embedding export.

The port's copy of the JAX package's embedders/base.py (reference
embedder/base_embedder.py:37-96): an embedder extracts a (vocab_size, dim)
float32 matrix (a GloVe file or an LM's token-embedding table), saved to
`data/embeddings/<name>.npy` beside a generated `config/embed/<name>.yaml`
that an experiment passes as `--embed <name>`.
"""
import os
from typing import Optional, Tuple

import numpy as np

from legommenders_tpu_torch.utils.io import yaml_save
from legommenders_tpu_torch.utils.registry import EMBEDDERS


class BaseEmbedder:
    vocab_name: str = "<vocab_name>"

    def __init__(self, model_path: Optional[str] = None):
        self.model_path = model_path

    def name(self) -> str:
        return self.__class__.__name__.replace("Embedder", "").lower()

    def get_embeddings(self) -> np.ndarray:
        raise NotImplementedError

    def export(self, export_dir: str = "data/embeddings",
               config_dir: str = "config/embed") -> Tuple[str, str]:
        emb = np.asarray(self.get_embeddings(), np.float32)
        os.makedirs(export_dir, exist_ok=True)
        path = os.path.join(export_dir, f"{self.name()}.npy")
        np.save(path, emb)
        cfg = dict(
            name=self.name(),
            transformation="auto",
            transformation_dropout=0.1,
            embeddings=[dict(vocab_name=self.vocab_name, path=path,
                             frozen=True)],
        )
        cfg_path = os.path.join(config_dir, f"{self.name()}.yaml")
        yaml_save(cfg, cfg_path)
        return path, cfg_path


EMBEDDERS.register(BaseEmbedder)
