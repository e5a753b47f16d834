"""RecBench embedding converter CLI of the port (the counterpart of the
root transfer.py; reference transfer.py:75-163).

Re-orders a RecBench-exported item embedding matrix to the local item
vocab's order and writes an embed YAML:

    python -m legommenders_tpu_torch.transfer --data goodreadsrb \
        --embed_path item-embeds.npy [--item_id_file item_ids.txt]

Host numpy over the port's token store; it needs no card.
"""
import os
import sys

import numpy as np

from legommenders_tpu_torch.data.token_store import TokenStore
from legommenders_tpu_torch.utils.function import parse_cli
from legommenders_tpu_torch.utils.io import yaml_save


def main(argv=None):
    cli = parse_cli(argv if argv is not None else sys.argv[1:])
    for key in ("data", "embed_path"):
        if key not in cli:
            raise SystemExit(f"--{key} is required")
    data_dir = cli.get("data_dir", os.path.join("data", "recbench",
                                                str(cli["data"])))
    items = TokenStore.load(os.path.join(data_dir, "items"))
    vocab = items.vocab_of("item_id")
    assert vocab is not None and vocab.tokens, \
        "items store lacks item_id vocab"

    emb = np.load(cli["embed_path"])
    # source ordering: one item id per line (RecBench export order)
    id_file = cli.get("item_id_file")
    if id_file:
        with open(id_file) as f:
            src_ids = [line.strip() for line in f if line.strip()]
        index = {t: i for i, t in enumerate(src_ids)}
        missing = sum(t not in index for t in vocab.tokens)
        if missing:
            print(f"warning: {missing} items missing from export; "
                  f"zero rows inserted")
        out = np.zeros((len(vocab), emb.shape[1]), np.float32)
        for row, t in enumerate(vocab.tokens):
            if t in index:
                out[row] = emb[index[t]]
    else:
        assert emb.shape[0] == len(vocab), (
            f"embedding rows {emb.shape[0]} != vocab size {len(vocab)}; "
            f"pass --item_id_file for reordering")
        out = emb.astype(np.float32)

    name = f"{cli['data']}-item-embeds"
    out_path = os.path.join("data", "embeddings", f"{name}.npy")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.save(out_path, out)
    cfg = dict(name=name, transformation="auto", transformation_dropout=0.1,
               embeddings=[dict(col_name="item_id", path=out_path,
                                frozen=True)])
    cfg_path = os.path.join("config", "embed", f"{name}.yaml")
    yaml_save(cfg, cfg_path)
    print(f"saved {out_path} {out.shape}; config {cfg_path}")
    return out_path, cfg_path


if __name__ == "__main__":
    main(sys.argv[1:])
