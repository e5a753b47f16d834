"""Offline preprocessing CLI of the port (the counterpart of the root
process.py; reference process.py:71-138).

    python -m legommenders_tpu_torch.process --data synthetic \
        [--save_dir DIR] [--regenerate 1]

Knows the processors the port has (synthetic). The LM tokenizers of the
real datasets' processors are ROADMAP.md, queue 1, item 7.
"""
import sys

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
    if cli.get("tokenizers"):
        raise NotImplementedError(
            "--tokenizers: the LM tokenizers are not ported yet "
            "(ROADMAP.md, queue 1, item 7)")
    cls = PROCESSORS[name.lower()]
    kwargs = {}
    if cli.get("raw_dir"):
        kwargs["raw_dir"] = cli["raw_dir"]
    if cli.get("save_dir"):
        kwargs["save_dir"] = cli["save_dir"]
    processor = cls(**kwargs)
    stores = processor.load(regenerate=bool(cli.get("regenerate")))
    for part, store in stores.items():
        print(f"{part}: {len(store)} rows, cols {store.col_names()}")
    return stores


if __name__ == "__main__":
    main(sys.argv[1:])
