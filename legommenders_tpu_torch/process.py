"""Offline preprocessing CLI of the port (the counterpart of the root
process.py; reference process.py:71-138).

    python -m legommenders_tpu_torch.process --data synthetic \
        [--save_dir DIR] [--regenerate 1]
    python -m legommenders_tpu_torch.process --data mind --raw_dir DIR \
        [--tokenizers glove:/path/glove.txt+bertbase] [--lm_truncate 50]

The processors are the JAX package's: synthetic, mind, oncemind,
xmind-<lang> (`--mind_dir`: the processed MIND store its ids align to)
and the <name>rb RecBench family (parquet; pandas is imported when one
is read). `--tokenizers` adds columns tokenized by each `+`-separated
spec (data/tokenizers.py: `word`, `glove:<path>`, or an HF tokenizer
named in the `.model` dotfile) to a processor that takes
`extra_tokenizers`; an xMIND processor re-tokenizes with the first spec
(JAX process.py:27-47).
"""
import sys

from legommenders_tpu_torch.data.tokenizers import resolve
from legommenders_tpu_torch.utils.function import parse_cli
from legommenders_tpu_torch.utils.registry import PROCESSORS
import legommenders_tpu_torch.data.processors  # noqa: F401 (register)


def main(argv=None):
    cli = parse_cli(argv if argv is not None else sys.argv[1:])
    name = cli.get("data")
    if not name:
        raise SystemExit("--data is required")
    if name.lower() not in PROCESSORS:
        raise SystemExit(
            f"unknown processor {name}; known: {PROCESSORS.keys()}")
    cls = PROCESSORS[name.lower()]
    kwargs = {}
    if cli.get("raw_dir"):
        kwargs["raw_dir"] = cli["raw_dir"]
    if cli.get("save_dir"):
        kwargs["save_dir"] = cli["save_dir"]
    takes = cls.__init__.__code__.co_varnames
    specs = str(cli.get("tokenizers") or "").split("+")
    if cli.get("tokenizers") and "extra_tokenizers" in takes:
        extra = {}
        for spec in specs:
            vocab_name, fn, vocab = resolve(spec)
            extra[vocab_name] = (fn, int(cli.get("lm_truncate", 50)), vocab)
        kwargs["extra_tokenizers"] = extra
    if "tokenize_fn" in takes:
        if cli.get("tokenizers"):
            kwargs["tokenize_fn"] = resolve(specs[0])[1]
        if cli.get("mind_dir"):
            kwargs["mind_dir"] = cli["mind_dir"]
    processor = cls(**kwargs)
    stores = processor.load(regenerate=bool(cli.get("regenerate")))
    for part, store in stores.items():
        print(f"{part}: {len(store)} rows, cols {store.col_names()}")
    return stores


if __name__ == "__main__":
    main(sys.argv[1:])
