"""Representation export CLI of the port (the counterpart of the root
extractor.py; reference extractor.py:58-126): builds the fast-eval repr
cache (the pool kernel on the card) and saves the item and user
representation matrices.

    python -m legommenders_tpu_torch.extractor --data synthetic \
        --model naml --load_sign <sig> [--export_dir data/export] \
        [--device cpu]

`--load_sign` loads checkpoints/<data>/<model>/<sig>.ckpt (the port's or a
JAX one, `runtime/checkpoint.load_auto`); without it the weights are the
fresh ones of the seed. Writes <export_dir>/<signature>.items.npy and
.users.npy, float32 (a bf16 model's reprs are widened).
"""
import os
import sys
from typing import Optional, Tuple

import numpy as np

from legommenders_tpu_torch.cli.base import BaseLego, run_cli
from legommenders_tpu_torch.runtime.checkpoint import load_auto


def extract(manager, out_dir: str, signature: str,
            load_path: Optional[str] = None) -> Tuple[str, str]:
    """The Manager's repr caches, from the weights at `load_path` if given,
    saved under `out_dir`; returns the two paths."""
    m = manager
    if m.cache is None:
        raise SystemExit("extractor requires a cacheable model "
                         "(use_fast_eval + caching-capable operators)")
    if load_path:
        load_auto(load_path, m.model, model_only=True)
    m.prepare_lm_cache()
    m.cache.cache()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for side, reprs in (("items", m.cache.item_repr),
                        ("users", m.cache.user_repr)):
        path = os.path.join(out_dir, f"{signature}.{side}.npy")
        np.save(path, reprs.float().cpu().numpy())
        paths.append(path)
        print(f"saved {path} {tuple(reprs.shape)}")
    return paths[0], paths[1]


class ExtractorCLI(BaseLego):
    def run(self):
        load_sign = self.cli.get("load_sign")
        return extract(
            self.manager, self.cli.get("export_dir", "data/export"),
            self.ph.signature,
            f"{self.ph.dir}/{load_sign}.ckpt" if load_sign else None)


def main(argv=None):
    return run_cli(ExtractorCLI, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
