"""HF checkpoint -> the port's LM slice weights.

The port's copy of the JAX package's models/lm/hf_loader.py. Each map
takes a checkpoint's state dict and returns the slice's parameters under
the port's names, relative to the slice (`layer_3.q_proj.weight`,
`final_norm.weight`, ...). A Linear is (out, in) in HF's layout and the
port's alike, so nothing is transposed (JAX's maps transpose into flax's
(in, out) kernels); the tensors keep the checkpoint's dtype and take the
parameter's when they are loaded. `merge_lm_params` loads a map into a
model's slice (`item_op.lm` or `item_op.lm_lower`), leaving what the
checkpoint does not hold (the LoRA factors, the head) as it is.

Everything is read from local paths; nothing is downloaded.
"""
import os
from typing import Dict, Iterable

import torch

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(model_path: str) -> StateDict:
    """An HF checkpoint's tensors: `model.safetensors` (safetensors is
    imported only then) or `pytorch_model.bin` (torch.load with
    weights_only)."""
    st_path = os.path.join(model_path, "model.safetensors")
    if os.path.isfile(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    bin_path = os.path.join(model_path, "pytorch_model.bin")
    if os.path.isfile(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin under {model_path}")


# the prefixes a family's checkpoint may put before the names its map reads
# (a bare model's state dict has none, a model with a head has its own)
PREFIXES = {
    "bert": ("", "bert."),
    "llama": ("", "model."),
    "opt": ("", "model.", "model.decoder.", "decoder."),
    "glm": ("transformer.encoder.", "encoder.", "transformer.", ""),
}
# the word-embedding table of each family, under those prefixes
WORD_EMBEDDINGS = {
    "bert": "embeddings.word_embeddings.weight",
    "llama": "embed_tokens.weight",
    "opt": "embed_tokens.weight",
    "glm": "embedding.word_embeddings.weight",
}


def word_embeddings(sd: StateDict, family: str) -> torch.Tensor:
    """The (vocab, dim) token-embedding table of a `family` checkpoint."""
    return _getter(sd, PREFIXES[family])(WORD_EMBEDDINGS[family])


def _getter(sd: StateDict, prefixes: Iterable[str]):
    prefixes = tuple(prefixes)

    def g(key: str) -> torch.Tensor:
        for prefix in prefixes:
            if prefix + key in sd:
                return sd[prefix + key]
        raise KeyError(key)
    return g


def bert_slice_params(sd: StateDict, start: int, num_layers: int,
                      embed: bool) -> StateDict:
    """HF `bert.*` names -> a BertEncoderSlice's parameters."""
    g = _getter(sd, PREFIXES["bert"])
    out = {}
    if embed and start == 0:
        out["position_embeddings"] = g("embeddings.position_embeddings.weight")
        out["token_type_embeddings"] = g(
            "embeddings.token_type_embeddings.weight")[:1]
        out["embeddings_norm.weight"] = g("embeddings.LayerNorm.weight")
        out["embeddings_norm.bias"] = g("embeddings.LayerNorm.bias")
    names = {"attention.query": "attention.self.query",
             "attention.key": "attention.self.key",
             "attention.value": "attention.self.value",
             "attention.output": "attention.output.dense",
             "attention_norm": "attention.output.LayerNorm",
             "intermediate": "intermediate.dense",
             "ffn_output": "output.dense",
             "output_norm": "output.LayerNorm"}
    for i in range(start, start + num_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = g(
                    f"encoder.layer.{i}.{theirs}.{leaf}")
    return out


def llama_slice_params(sd: StateDict, start: int, num_layers: int,
                       final_norm: bool) -> StateDict:
    """HF Llama names -> a LlamaDecoderSlice's parameters."""
    g = _getter(sd, PREFIXES["llama"])
    names = {"input_norm": "input_layernorm",
             "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
             "post_norm": "post_attention_layernorm",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj"}
    out = {f"layer_{i}.{ours}.weight": g(f"layers.{i}.{theirs}.weight")
           for i in range(start, start + num_layers)
           for ours, theirs in names.items()}
    if final_norm:
        out["final_norm.weight"] = g("norm.weight")
    return out


def opt_slice_params(sd: StateDict, start: int, num_layers: int,
                     embed_positions: bool, final_norm: bool) -> StateDict:
    """HF OPT names -> an OPTDecoderSlice's parameters."""
    g = _getter(sd, PREFIXES["opt"])
    out = {}
    if embed_positions and start == 0:
        out["position_embeddings"] = g("embed_positions.weight")
    names = {"attn_norm": "self_attn_layer_norm",
             "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
             "ffn_norm": "final_layer_norm", "fc1": "fc1", "fc2": "fc2"}
    for i in range(start, start + num_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = g(
                    f"layers.{i}.{theirs}.{leaf}")
    if final_norm:
        out["final_norm.weight"] = g("final_layer_norm.weight")
        out["final_norm.bias"] = g("final_layer_norm.bias")
    return out


def glm_slice_params(sd: StateDict, start: int, num_layers: int,
                     num_heads: int, num_kv_heads: int,
                     final_norm: bool) -> StateDict:
    """ChatGLM2/3 / GLM-4 names -> a LlamaDecoderSlice's parameters. The
    checkpoint fuses q, k and v into `self_attention.query_key_value`
    ((H + 2 G) d rows: the queries, then G key groups, then G value
    groups) and the SwiGLU's gate and up into `mlp.dense_h_to_4h` (gate
    first); `self_attention.dense` is o_proj; a checkpoint without the qkv
    bias (GLM-4-9B) maps without one."""
    g = _getter(sd, PREFIXES["glm"])
    out = {}
    for i in range(start, start + num_layers):
        p, o = f"layers.{i}.", f"layer_{i}."
        qkv_w = g(p + "self_attention.query_key_value.weight")
        d = qkv_w.shape[1] // num_heads
        q_rows, kv_rows = num_heads * d, num_kv_heads * d
        splits = {"q_proj": slice(0, q_rows),
                  "k_proj": slice(q_rows, q_rows + kv_rows),
                  "v_proj": slice(q_rows + kv_rows, None)}
        try:
            qkv_b = g(p + "self_attention.query_key_value.bias")
        except KeyError:
            qkv_b = None
        for name, rows in splits.items():
            out[o + name + ".weight"] = qkv_w[rows]
            if qkv_b is not None:
                out[o + name + ".bias"] = qkv_b[rows]
        out[o + "input_norm.weight"] = g(p + "input_layernorm.weight")
        out[o + "o_proj.weight"] = g(p + "self_attention.dense.weight")
        out[o + "post_norm.weight"] = g(p + "post_attention_layernorm.weight")
        h4h = g(p + "mlp.dense_h_to_4h.weight")
        ffn = h4h.shape[0] // 2
        out[o + "gate_proj.weight"] = h4h[:ffn]
        out[o + "up_proj.weight"] = h4h[ffn:]
        out[o + "down_proj.weight"] = g(p + "mlp.dense_4h_to_h.weight")
    if final_norm:
        out["final_norm.weight"] = g("final_layernorm.weight")
    return out


@torch.no_grad()
def merge_lm_params(model: torch.nn.Module, mapped: StateDict,
                    path: str = "item_op.lm") -> list:
    """Copy `mapped` (a slice's parameters) into `model`'s submodule at
    `path`, each tensor cast to its parameter's dtype and device; what the
    map does not hold stays. Raises on a name the slice does not have and
    on a shape that differs. Returns the names loaded."""
    slice_ = model.get_submodule(path)
    own = dict(slice_.named_parameters())
    for name, value in mapped.items():
        if name not in own:
            raise KeyError(f"merge_lm_params: {path}.{name} is not a "
                           f"parameter of the model")
        if tuple(own[name].shape) != tuple(value.shape):
            raise ValueError(f"merge_lm_params: {path}.{name} is "
                             f"{tuple(own[name].shape)}, the checkpoint's "
                             f"{tuple(value.shape)}")
        own[name].copy_(value)
    return sorted(mapped)
