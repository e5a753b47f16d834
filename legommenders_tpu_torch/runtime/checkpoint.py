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
msgpack map), not by the file name.

Sharded checkpoints (JAX `save_sharded` / `load_sharded` / `save_auto` /
`load_auto` / `params_are_sharded`, :54-130). The card has no orbax, so
the port writes its own sharded form: a directory `<path>.orbax` where
each mp rank of dp row 0 writes `shard_<r>.pt`, its slices of the sharded
parameters and of their Adam state (the replicated ones and the
optimizer's scalars in shard 0 only), with `index.json` (every
parameter's global shape and the dim it is split on, and n_mp) and the
meta at `<path>.orbax.meta.json`, as JAX's orbax path has it. Loading
reassembles each tensor from the shards and cuts it to the target's
layout (`parallel/mesh.model_plan`): a checkpoint written at mp 2 loads
at mp 2, at mp 1 and in one process (the Tester), whole tensors there.

`load_orbax` reads a directory that JAX's `save_sharded` wrote with
orbax's `StandardCheckpointer`: its `_METADATA` lists every leaf of the
saved tree by its keys, and each array lies in the directory's OCDBT
store under its dotted path (`params.params.emb_title`), which
tensorstore's `zarr` driver over an `ocdbt` kvstore reads whole, however
the run sharded it. The params tree goes through `bridge.params_from_jax`
and is cut to the model's layout; the Adam state (optax's count, mu and
nu), where the directory holds it, becomes the torch optimizer's.
tensorstore is imported only there; without it the read stops with a
message that names the package. `load_auto` tells JAX's directory
(`_METADATA`) from the port's (`index.json`) by what is in it.
"""
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from legommenders_tpu_torch.bridge import params_from_jax
from legommenders_tpu_torch.parallel.mesh import (
    barrier, model_plan, shard_slice,
)
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
    plan = model_plan(model)
    model.load_state_dict({k: _fit(v, k, plan)
                           for k, v in blob["model"].items()})
    if not model_only and optimizer is not None and "optimizer" in blob:
        if plan is not None:
            raise ValueError(f"{path}: a whole model's optimizer state does "
                             f"not load into a model placed over mp; load "
                             f"model_only, or a sharded checkpoint")
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


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------
def params_are_sharded(model: torch.nn.Module) -> bool:
    """Whether the model holds mp slices of any parameter (the signal to
    write a sharded checkpoint)."""
    plan = model_plan(model)
    return plan is not None and bool(plan.sharded)


def _optimizer_parts(optimizer):
    """(torch optimizer, its MultiSteps wrapper or None)."""
    inner = getattr(optimizer, "optimizer", None)
    return (inner, optimizer) if inner is not None else (optimizer, None)


def _named_optimizer_state(model, optimizer) -> dict:
    """The optimizer's state by parameter name: per-parameter tensors
    (Adam's moments, a MultiSteps accumulator) keyed by name, the rest as
    it is."""
    inner, multi = _optimizer_parts(optimizer)
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in inner.param_groups for p in g["params"]]
    sd = inner.state_dict()
    out = {"state": {order[i]: st for i, st in sd["state"].items()},
           "groups": [{k: v for k, v in g.items() if k != "params"}
                      for g in sd["param_groups"]]}
    if multi is not None:
        out["scheduler"] = (multi.scheduler.state_dict()
                            if multi.scheduler is not None else None)
        out["mini_step"] = multi.mini_step
        out["acc"] = {names[id(p)]: a for p, a in multi.acc.items()}
    return out


def _per_param(tensor: torch.Tensor, shape) -> bool:
    """A state tensor laid out as its parameter (not Adam's step count)."""
    return tensor.dim() > 0 and tuple(tensor.shape) == tuple(shape)


def save_sharded(path: str, model: torch.nn.Module, optimizer=None,
                 meta: Optional[Dict[str, Any]] = None, mesh=None):
    """The sharded checkpoint directory `path`; every rank of the mesh
    calls it (the mp ranks of the first (dp, sp, pp) cell write, all wait
    at a barrier)."""
    plan = model_plan(model)
    r = mesh.mp_index if mesh is not None else 0
    # the mp ranks of the first (dp, sp, pp) cell: every other cell holds
    # the same slices
    writes = mesh is None or (mesh.dp_index, mesh.sp_index,
                              mesh.pp_index) == (0, 0, 0)
    if writes:
        os.makedirs(path, exist_ok=True)
        named = dict(model.named_parameters())
        state = model.state_dict()
        mine = {k: v for k, v in state.items()
                if r == 0 or k in plan.sharded}
        blob = {"model": mine}
        if optimizer is not None:
            opt = _named_optimizer_state(model, optimizer)
            opt["state"] = {
                k: {sk: sv for sk, sv in st.items()
                    if r == 0 or (k in plan.sharded
                                  and _per_param(sv, named[k].shape))}
                for k, st in opt["state"].items()}
            opt["acc"] = {k: a for k, a in opt.get("acc", {}).items()
                          if r == 0 or k in plan.sharded}
            blob["optimizer"] = opt
        torch.save(blob, os.path.join(path, f"shard_{r}.pt"))
        if r == 0:
            shapes = {}
            for k, v in state.items():
                dim = plan.sharded.get(k)
                shape = list(v.shape)
                if dim is not None:
                    shape[dim] *= plan.n_mp
                shapes[k] = {"shape": shape, "dim": dim}
            json_save({"n_mp": plan.n_mp, "params": shapes},
                      os.path.join(path, "index.json"))
            if meta is not None:
                json_save(meta, path + ".meta.json")
    barrier(mesh)


def _assemble(parts, index: dict, name: str, key=None) -> torch.Tensor:
    """The whole tensor `name` (its state entry `key`) from the shards."""
    got = [p for p in parts if p is not None]
    first = got[0]
    dim = index["params"].get(name, {}).get("dim")
    if dim is None or len(got) == 1:
        return first
    if key is not None and first.dim() == 0:
        return first
    return torch.cat(got, dim=dim)


def _fit(whole: torch.Tensor, name: str, plan) -> torch.Tensor:
    """`whole` cut to the target's slice of `name`."""
    if plan is None or name not in plan.sharded:
        return whole
    return shard_slice(whole, plan.sharded[name], plan.axis)


def load_sharded(path: str, model: torch.nn.Module, optimizer=None
                 ) -> Optional[dict]:
    """Restore a `save_sharded` directory into `model` (and `optimizer`),
    resharded to the model's layout; returns the meta."""
    index = json_load(os.path.join(path, "index.json"))
    shards = [torch.load(os.path.join(path, f"shard_{r}.pt"),
                         map_location="cpu", weights_only=True)
              for r in range(int(index["n_mp"]))]
    plan = model_plan(model)
    state = {}
    for name in shards[0]["model"]:
        whole = _assemble([s["model"].get(name) for s in shards], index,
                          name)
        state[name] = _fit(whole, name, plan)
    model.load_state_dict(state)
    if optimizer is not None and "optimizer" in shards[0]:
        _load_named_optimizer_state(model, optimizer, shards, index, plan)
    meta_path = path + ".meta.json"
    return json_load(meta_path) if os.path.isfile(meta_path) else None


def _load_named_optimizer_state(model, optimizer, shards, index, plan):
    inner, multi = _optimizer_parts(optimizer)
    named = dict(model.named_parameters())
    names = {id(p): n for n, p in named.items()}
    first = shards[0]["optimizer"]
    order = [names[id(p)] for g in inner.param_groups for p in g["params"]]
    state = {}
    for i, name in enumerate(order):
        if name not in first["state"]:
            continue
        st = {}
        for key, v in first["state"][name].items():
            if _per_param(v, named[name].shape) or (
                    name in index["params"]
                    and index["params"][name]["dim"] is not None
                    and v.dim() > 0):
                whole = _assemble([s["optimizer"]["state"].get(name, {})
                                   .get(key) for s in shards], index, name,
                                  key)
                st[key] = _fit(whole, name, plan)
            else:
                st[key] = v
        state[i] = st
    sd = inner.state_dict()
    groups = [{**g, "params": own["params"]}
              for g, own in zip(first["groups"], sd["param_groups"])]
    inner.load_state_dict({"state": state, "param_groups": groups})
    if multi is not None:
        if multi.scheduler is not None and first.get("scheduler"):
            multi.scheduler.load_state_dict(first["scheduler"])
        multi.mini_step = int(first.get("mini_step", 0))
        multi.acc = {}
        for name in first.get("acc", {}):
            whole = _assemble([s["optimizer"]["acc"].get(name)
                               for s in shards], index, name)
            p = named[name]
            multi.acc[p] = _fit(whole, name, plan).to(p.device)


# ---------------------------------------------------------------------------
# JAX's orbax directories
# ---------------------------------------------------------------------------
def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading a checkpoint directory that JAX's orbax wrote needs "
            "the `tensorstore` package, which is not installed") from e
    return tensorstore


def read_orbax(path: str) -> dict:
    """The tree a JAX `save_sharded` wrote at `path` ({"params": ...,
    "opt_state": ...}), numpy leaves, each array read whole from the
    directory's OCDBT store; leaves orbax skipped (None) left out."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    kvstore = {"driver": "ocdbt", "base": f"file://{path}/"}
    tree: dict = {}
    for leaf in json_load(os.path.join(path, "_METADATA"))[
            "tree_metadata"].values():
        if leaf["value_metadata"].get("skip_deserialize"):
            continue
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        arr = ts.open({"driver": "zarr", "kvstore": kvstore,
                       "path": ".".join(keys)}, open=True).result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(arr.read().result())
    return tree


def _adam_node(tree) -> Optional[dict]:
    """The optax Adam state ({count, mu, nu}) inside an opt_state tree."""
    if not isinstance(tree, dict):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for v in tree.values():
        found = _adam_node(v)
        if found is not None:
            return found
    return None


def _wide(tree):
    """Every leaf as f32 (bf16 exactly), the tree's shape kept."""
    if isinstance(tree, dict):
        return {k: _wide(v) for k, v in tree.items()}
    return np.asarray(tree).astype(np.float32)


def load_orbax(path: str, model: torch.nn.Module, optimizer=None
               ) -> Optional[dict]:
    """Restore a directory JAX's orbax wrote into `model` (and, where it
    holds optax's Adam state, into `optimizer`'s Adam moments and step),
    cut to the model's layout; returns the meta."""
    tree = read_orbax(path)
    plan = model_plan(model)
    state = params_from_jax(_wide(tree["params"]), model)
    model.load_state_dict({k: _fit(v, k, plan) for k, v in state.items()})
    adam = _adam_node(tree.get("opt_state"))
    if optimizer is not None and adam is not None:
        inner, _ = _optimizer_parts(optimizer)
        mu = params_from_jax(_wide(adam["mu"]), model)
        nu = params_from_jax(_wide(adam["nu"]), model)
        step = float(np.asarray(adam["count"]))
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            inner.state[p] = {
                "step": torch.tensor(step),
                "exp_avg": _fit(mu[name], name, plan).to(p),
                "exp_avg_sq": _fit(nu[name], name, plan).to(p)}
    return _meta(path)


def save_auto(path: str, model: torch.nn.Module, optimizer=None,
              meta: Optional[Dict[str, Any]] = None, mesh=None) -> str:
    """A model holding mp slices -> the sharded directory `path`.orbax
    (every rank calls it); else one file at `path`, written by the main
    rank. Returns the path written."""
    if params_are_sharded(model):
        opath = path + ".orbax"
        save_sharded(opath, model, optimizer, meta, mesh)
        return opath
    if mesh is None or mesh.is_main:
        save_checkpoint(path, model, optimizer, meta)
    barrier(mesh)
    return path


def load_auto(path: str, model: torch.nn.Module, optimizer=None,
              model_only: bool = False) -> Optional[dict]:
    """`path`.orbax when that directory is there (JAX's rule), resharded to
    the model: the port's sharded form (`index.json`) or JAX's orbax
    directory (`_METADATA`), told apart by what is in it; else the port's
    checkpoint or a JAX one at `path`, told apart by the first bytes (a
    JAX msgpack checkpoint gives weights only)."""
    opath = path + ".orbax"
    if os.path.isdir(opath):
        optimizer = None if model_only else optimizer
        if os.path.isfile(os.path.join(opath, "index.json")):
            return load_sharded(opath, model, optimizer)
        if os.path.isfile(os.path.join(opath, "_METADATA")):
            return load_orbax(opath, model, optimizer)
        raise ValueError(f"{opath}: neither the port's sharded checkpoint "
                         f"(index.json) nor JAX's orbax one (_METADATA)")
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _ZIP_MAGIC:
        return load_checkpoint(path, model, optimizer, model_only)
    if head[:1] and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return load_jax_checkpoint(path, model)
    raise ValueError(f"{path}: neither the port's checkpoint (zip) nor a "
                     f"JAX msgpack checkpoint (map), first bytes {head!r}")
