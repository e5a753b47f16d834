"""Parameter-size CLI of the port (the counterpart of the root sizer.py;
reference sizer.py:43-92): prints every parameter's name and shape and
the total, in millions.

    python -m legommenders_tpu_torch.sizer --data synthetic --model naml \
        [--device cpu]

The total counts what JAX's `init_params` holds: every parameter, the
frozen ones too (pretrained tables and an LM's frozen lower slice are
parameters without `requires_grad` in the port; JAX keeps them as leaves of
the params tree), each marked here as trainable or frozen.
"""
import sys
from typing import List, Tuple

from legommenders_tpu_torch.cli.base import BaseLego, run_cli


def count(model) -> Tuple[List[Tuple[str, tuple, bool]], int]:
    """(name, shape, trainable) of every parameter, and the total."""
    rows = [(name, tuple(p.shape), p.requires_grad)
            for name, p in model.named_parameters()]
    return rows, sum(p.numel() for p in model.parameters())


class SizerCLI(BaseLego):
    def run(self):
        rows, total = count(self.manager.model)
        for name, shape, trainable in rows:
            print(f"{name:80s} {shape} "
                  f"{'trainable' if trainable else 'frozen'}")
        print(f"total: {total / 1e6:.3f}M params")
        return total


def main(argv=None):
    return run_cli(SizerCLI, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
