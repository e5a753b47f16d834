"""Embedding export CLI of the port (the counterpart of the root embed.py;
reference embed.py:11-51).

    python -m legommenders_tpu_torch.embed --model glove \
        --model_path /path/to/glove.6B.300d.txt
    python -m legommenders_tpu_torch.embed --model bertbase \
        --model_path /path/to/bert-base-uncased

Writes data/embeddings/<name>.npy and config/embed/<name>.yaml. Host only:
it runs no kernel and needs no card.
"""
import sys

import legommenders_tpu_torch.embedders  # noqa: F401 (register)
from legommenders_tpu_torch.utils.function import parse_cli
from legommenders_tpu_torch.utils.registry import EMBEDDERS


def main(argv=None):
    cli = parse_cli(argv if argv is not None else sys.argv[1:])
    name = cli.get("model")
    if not name:
        raise SystemExit("--model is required")
    key = name.lower().replace("embedder", "")
    if key not in EMBEDDERS:
        raise SystemExit(f"unknown embedder {name}; known: {EMBEDDERS.keys()}")
    embedder = EMBEDDERS[key](model_path=cli.get("model_path"))
    path, cfg_path = embedder.export()
    print(f"embeddings saved to {path}; config at {cfg_path} "
          f"(verify vocab_name before use)")
    return path, cfg_path


if __name__ == "__main__":
    main(sys.argv[1:])
