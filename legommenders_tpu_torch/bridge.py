"""Weight bridge: a JAX (flax) parameter tree -> the port's state_dict.

The tree is the JAX package's params as nested dicts of numpy arrays
(e.g. `jax.tree_util.tree_map(np.asarray, params)`); this module imports
no JAX. Conversions:
  * Dense `kernel` (in, out)      -> Linear `weight` (out, in);
  * nn.Conv `kernel` (k, in, out) -> Conv1d `weight` (out, in, k);
  * `bias`                        -> `bias`;
  * `eh/emb_<kind>__<name>`       -> `eh.tables.<kind>__<name>`;
  * `eh/tr_<kind>__<name>/...`    -> `eh.transforms.<kind>__<name>....`;
  * AdditiveAttention `proj_kernel` / `proj_bias` / `query` as they are,
    with the flax module name `AdditiveAttention_0` -> `attention`;
  * LayerNorm `scale`             -> `weight`;
  * the decoders' RMSNorm `weight` (modules `input_norm`, `post_norm`,
    `final_norm`) as it is;
  * LoRA `lora_A` (D, r) / `lora_B` (r, F) -> (r, D) / (F, r);
  * BERT's, OPT's, Fastformer's and the Transformer's
    `position_embeddings`,
    `token_type_embeddings`, the ConcatInputer's and the
    FlattenSeqInputer's `special_tokens` (`item_inputer`, `user_inputer`),
    PolyAttention's `context_codes` and the IISAN operators' `gates` as
    they are (their `san_<i>/{fc_up,fc_down,LayerNorm_0}`, `global_proj`,
    `local_proj_<i>` and `linear` are Dense and LayerNorm leaves);
  * the CTR heads' own leaves as they are, by name: CrossNet's and
    GateCrossLayer's `b_<i>`, CrossNetMix's `U_<i>` / `V_<i>` (E, D, r),
    `C_<i>` (E, r, r) and `bias_<i>`, FinalMLP's `w_xy`, Dice's `alpha`
    (a StatelessBatchNorm's `scale` -> `weight` as LayerNorm's);
  * the GRU cell's gates `GRUCell_<i>/{ir,iz,in,hr,hz,hn}` as Dense
    layers (`hr` and `hz` have no bias, as in flax);
  * flax's automatic names (`Dense_0`, `LayerNorm_0`,
    `MultiHeadSelfAttention_0`, `FastSelfAttention_0`, `GRUCell_0`,
    `layer_i/attn/{q,k,v,out}`) and the decoders' (`attn_norm`,
    `ffn_norm`, `{q,k,v,o,gate,up,down}_proj`, `out_proj`, `fc1`, `fc2`)
    as they are: the port names its submodules as flax does. Module paths
    keep their
    names (`item_op/lm/layer_3/attention/query` ->
    `item_op.lm.layer_3.attention.query`); in layer-split mode the frozen
    lower slice `item_op/lm_lower/{embedding stage, layer_0..k-1}` and the
    trained upper slice `item_op/lm/layer_k..` map the same way; so do
    the semantic operator's level clones `user_op/base_<i>/...` and its
    `pool`, and SemanticMixPredictor's `mix_linear` (a Dense).
The same conversion maps a tree of JAX gradients onto the port's
parameter names.
Raises on any key it cannot place and on any parameter of the port that
the tree leaves unset.
"""
import re
from typing import Dict, Mapping

import numpy as np
import torch

_MODULE_NAMES = {"AdditiveAttention_0": "attention"}
_AS_THEY_ARE = ("bias", "proj_kernel", "proj_bias", "query",
                "position_embeddings", "token_type_embeddings",
                "special_tokens", "context_codes", "w_xy", "alpha", "gates")
# numbered leaves of the cross layers: CrossNet / GateCrossLayer `b_<i>`,
# CrossNetMix `U_<i>`, `V_<i>`, `C_<i>`, `bias_<i>`
_NUMBERED = re.compile(r"(b|U|V|C|bias)_\d+")
# the decoders' RMSNorms, whose one parameter flax names `weight`
_RMS_NORMS = ("input_norm", "post_norm", "final_norm")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _place(path, arr):
    """(port key, converted array) for one JAX leaf."""
    *mods, leaf = path
    if mods[:1] == ["eh"] and leaf.startswith("emb_") and len(mods) == 1:
        return f"eh.tables.{leaf[4:]}", arr
    names = []
    for m in mods:
        if mods[:1] == ["eh"] and m.startswith("tr_"):
            names += ["transforms", m[3:]]
        else:
            names.append(_MODULE_NAMES.get(m, m))
    if leaf == "kernel" and arr.ndim == 2:
        leaf, arr = "weight", arr.T
    elif leaf == "kernel" and arr.ndim == 3:
        leaf, arr = "weight", arr.transpose(2, 1, 0)
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "weight" and arr.ndim == 1 and mods and \
            mods[-1] in _RMS_NORMS:
        pass
    elif leaf in ("lora_A", "lora_B"):
        arr = arr.T
    elif leaf not in _AS_THEY_ARE and not _NUMBERED.fullmatch(leaf):
        raise KeyError(f"bridge: no rule for JAX parameter {'/'.join(path)}")
    return ".".join(names + [leaf]), arr


def params_from_jax(tree: Mapping, model: torch.nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """A state_dict for `model` holding the JAX tree's values (f32 CPU
    tensors); load it with `model.load_state_dict`."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    want = model.state_dict()
    out = {}
    for path, arr in _flatten(tree):
        key, conv = _place(path, arr)
        if key not in want:
            raise KeyError(f"bridge: JAX parameter {'/'.join(path)} maps to "
                           f"{key}, which the port does not have")
        if tuple(want[key].shape) != conv.shape:
            raise ValueError(f"bridge: {key} is {tuple(want[key].shape)} in "
                             f"the port, {conv.shape} from JAX")
        out[key] = torch.tensor(conv, dtype=torch.float32)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"bridge: port parameters left unset: {missing}")
    return out
