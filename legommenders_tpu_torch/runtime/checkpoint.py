"""Checkpointing: model weights + optimizer state + step metadata.

The port of the JAX package's runtime/checkpoint.py single-file path
(reference base_lego.py:228-267: a torch.save of the model's, the
optimizer's and the scheduler's state, best-only policy, model-only load).
The port's own format is one `torch.save` file of
{"model": state_dict, "optimizer": state_dict} (the Trainer's optimizer
state holds its LR scheduler's and its gradient accumulation's), with
`<path>.meta.json` beside it as in JAX.

`load_jax_checkpoint` reads a checkpoint the JAX package's
`save_checkpoint` wrote (flax msgpack) into the port's model: it decodes
flax's msgpack itself (ext type 1 is an ndarray packed as (shape, dtype
name, C-order bytes), `bfloat16` a dtype name numpy does not know, arrays
past 1 GiB split into `__msgpack_chunked_array__` chunks) and puts the
params tree through `bridge.params_from_jax`; it imports no flax, and
`msgpack` only when it runs. The optax state is not read. `load_auto`
tells the two formats apart by their first bytes (a zip archive against a
msgpack map), not by the file name. The orbax sharded pair waits for the
multi-device slice (ROADMAP.md, queue 1, item 8).
"""
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.utils.io import json_load, json_save

_ZIP_MAGIC = b"PK\x03\x04"
# msgpack ext type codes of flax.serialization
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _meta(path: str) -> Optional[dict]:
    meta_path = path + ".meta.json"
    return json_load(meta_path) if os.path.isfile(meta_path) else None


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    meta: Optional[Dict[str, Any]] = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = {"model": model.state_dict()}
    if optimizer is not None:
        blob["optimizer"] = optimizer.state_dict()
    torch.save(blob, path)
    if meta is not None:
        json_save(meta, path + ".meta.json")


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    model_only: bool = False) -> Optional[dict]:
    """Restore the port's checkpoint into `model` (and `optimizer` unless
    `model_only`), each on its own device; returns the meta (or None)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model"])
    if not model_only and optimizer is not None and "optimizer" in blob:
        optimizer.load_state_dict(blob["optimizer"])
    return _meta(path)


# ---------------------------------------------------------------------------
# JAX (flax msgpack) checkpoints
# ---------------------------------------------------------------------------
def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # the upper 16 bits of an f32
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        arr = (bits << 16).view(np.float32)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_jax_checkpoint(path: str) -> dict:
    """The state dict a JAX `save_checkpoint` wrote: {"params": tree,
    "opt_state": ...}, numpy leaves."""
    import msgpack

    with open(path, "rb") as f:
        state = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(state)


def load_jax_checkpoint(path: str, model: torch.nn.Module
                        ) -> Optional[dict]:
    """A JAX msgpack checkpoint's params, through the bridge, into `model`
    (cast to its parameters' dtype and device); returns the meta."""
    state = read_jax_checkpoint(path)
    model.load_state_dict(params_from_jax(state["params"], model))
    return _meta(path)


def load_auto(path: str, model: torch.nn.Module, optimizer=None,
              model_only: bool = False) -> Optional[dict]:
    """The port's checkpoint or a JAX one, told apart by the first bytes
    (a JAX checkpoint gives weights only)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _ZIP_MAGIC:
        return load_checkpoint(path, model, optimizer, model_only)
    if head[:1] and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return load_jax_checkpoint(path, model)
    raise ValueError(f"{path}: neither the port's checkpoint (zip) nor a "
                     f"JAX msgpack checkpoint (map), first bytes {head!r}")
