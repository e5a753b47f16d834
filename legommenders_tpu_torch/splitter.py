"""LM layer pre-caching CLI of the port (the counterpart of the root
splitter.py; reference splitter.py:56-121).

Computes the item LM's lower-layer hidden states for every item once and
keeps them on disk for later layer-split runs:

    python -m legommenders_tpu_torch.splitter --data mind \
        --model bert-naml --layers 0+6+11 [--regenerate 1] [--device cpu]

Negative layers wrap (reference splitter.py:64-75); without `--layers`
the model's own tune_from. For each layer k the model is rebuilt with
`tune_from = k` (its weights drawn from the seed and, where the `.model`
dotfile names a checkpoint, loaded from it, as a Trainer's are), and
`runtime/lm_cache` writes the states after layers 0..k-1 to
cache/<data>/<op>/torch_layer_<k>.<fingerprint>.npy (+ its mask). The
file is keyed by a fingerprint of the item operator's weights: a later
Trainer of the same configuration and seed (or the same LM checkpoint)
reads it instead of building its cache; the lower slice runs the
attention kernel on the card.
"""
import copy
import glob
import os
import sys
from typing import Callable, Dict, List

from legommenders_tpu_torch.cli.base import BaseLego, run_cli
from legommenders_tpu_torch.models.operators.lm_ops import LMOperator
from legommenders_tpu_torch.runtime.lm_cache import cache_dir
from legommenders_tpu_torch.runtime.manager import Manager


def resolve_layers(arg, num_hidden_layers: int) -> List[int]:
    """`0+6+-2` -> [0, 6, num_hidden_layers - 2]."""
    layers = [int(x) for x in str(arg).split("+")]
    return [k if k >= 0 else num_hidden_layers + k for k in layers]


def with_tune_from(model_cfg: dict, layer: int) -> dict:
    cfg = copy.deepcopy(model_cfg)
    config = cfg.setdefault("config", {})
    config["item_config"] = {**(config.get("item_config") or {}),
                             "tune_from": layer}
    return cfg


def layer_files(m: Manager, layer: int, root: str) -> List[str]:
    """The cache files of `layer` under `root` for `m`'s item operator."""
    d = cache_dir(m.data.name, m.model.item_op.transformer_key, root)
    return sorted(glob.glob(os.path.join(d, f"torch_layer_{layer}.*.npy")))


def split(make_manager: Callable[[int], Manager], layers: List[int],
          root: str = "cache", regenerate: bool = False,
          log=print) -> Dict[int, List[str]]:
    """For each layer, `make_manager(layer)` (a Manager whose item operator
    has tune_from = layer) loads its LM weights and writes its cache under
    `root`; returns each layer's cache files."""
    out = {}
    for layer in layers:
        m = make_manager(layer)
        if regenerate:
            for path in layer_files(m, layer, root):
                os.remove(path)
        m.load_lm_weights()
        m.prepare_lm_cache(root=root)
        out[layer] = layer_files(m, layer, root)
        log(f"cached layer {layer}: {out[layer]}")
        del m
    return out


class SplitterCLI(BaseLego):
    def run(self):
        m = self.manager
        op = m.model.item_op
        if not isinstance(op, LMOperator):
            raise SystemExit("--model must use an LM item operator "
                             "(reference splitter.py:66)")
        layers = resolve_layers(
            self.cli.get("layers", op.resolved_tune_from or 1),
            op.num_hidden_layers)
        cfgs = self.raw_configs

        def make_manager(layer: int) -> Manager:
            return Manager(cfgs["data"], with_tune_from(cfgs["model"], layer),
                           cfgs["embed"], cfgs["exp"], data=m.data,
                           device=self.device, seed=self.seed)

        return split(make_manager, layers,
                     regenerate=bool(self.cli.get("regenerate")),
                     log=self.log.info)


def main(argv=None):
    return run_cli(SplitterCLI, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
