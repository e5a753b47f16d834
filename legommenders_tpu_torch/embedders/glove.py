"""The GloVe text parser (the port's copy of the JAX package's
embedders/glove.py `parse_glove_text`; reference
embedder/glove_embedder.py:46-151): a local `glove.6B.<dim>d.txt`, or any
word2vec-style text file, read into (words, matrix). Lines whose width
differs from the first line's are skipped. No download: the file must be
local."""
from typing import List, Optional, Tuple

import numpy as np


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
