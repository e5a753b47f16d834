"""GloVe: the text parser and the embedder (the port's copy of the JAX
package's embedders/glove.py; reference embedder/glove_embedder.py:46-151).
`parse_glove_text` reads a local `glove.6B.<dim>d.txt`, or any
word2vec-style text file, into (words, matrix); lines whose width differs
from the first line's are skipped. `GloVeEmbedder` exports that matrix.
No download: the file must be local."""
from typing import List, Optional, Tuple

import numpy as np

from legommenders_tpu_torch.embedders.base import BaseEmbedder
from legommenders_tpu_torch.utils.registry import EMBEDDERS


def parse_glove_text(path: str, dim: Optional[int] = None
                     ) -> Tuple[List[str], np.ndarray]:
    words, vecs = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if dim is None:
                dim = len(parts) - 1
            if len(parts) != dim + 1:
                continue
            words.append(parts[0])
            vecs.append(np.asarray(parts[1:], np.float32))
    return words, np.stack(vecs)


@EMBEDDERS.register
class GloVeEmbedder(BaseEmbedder):
    vocab_name = "glove"

    def __init__(self, model_path: Optional[str] = None, dim: int = 300):
        super().__init__(model_path)
        self.dim = dim
        self._words: Optional[List[str]] = None

    def name(self):
        return "glove"

    def get_vocab(self) -> List[str]:
        if self._words is None:
            self.get_embeddings()
        return self._words

    def get_embeddings(self) -> np.ndarray:
        if not self.model_path:
            raise FileNotFoundError(
                "GloVe source file required (nothing is downloaded): pass "
                "model_path=/path/to/glove.6B.300d.txt")
        self._words, matrix = parse_glove_text(self.model_path, self.dim)
        return matrix
