"""The experiment mesh over torch.distributed: the data-parallel and the
model-parallel axes.

The port of the JAX package's parallel/mesh.py (its `make_mesh`,
`mesh_from_policy`, `initialize_multihost`, `shard_batch` and
`params_shardings`). JAX lays a (dp, mp[, sp][, pp]) `jax.sharding.Mesh`
over `jax.devices()`; the port runs one process per device in a process
group, whose size plays the part of `jax.devices()`:

  * `initialize_multihost` opens the group: NCCL on `cuda` (each process on
    `cuda:LOCAL_RANK`), gloo on the CPU, or the backend asked for (gloo on
    `cuda` lets two ranks share one card, which NCCL refuses). Without a
    coordinator it reads the `torchrun` environment (`env://`);
    `--coordinator host:port --num_processes N --process_id i` is JAX's
    manual launch; a coordinator with a scheme (`file:///...`,
    `tcp://...`) is taken as the init method itself;
  * `mesh_from_policy` reads `exp.policy.mesh` as JAX does (`true`: every
    process, pure dp; `mp`, `catalog_parallel`, `min_rows_to_shard`; dp
    defaults to the rest) and checks it with JAX's messages. JAX reshapes
    the devices to [dp, mp], so rank = dp_index * mp + mp_index. The mesh
    holds two families of subgroups (`dist.new_group`, made once per
    layout by every rank in one order): the mp group of each dp row and
    the dp group of each mp column;
  * `shard_rows` is a batch's rows of this rank's dp index, in place of
    `shard_batch` (the mp ranks of one dp row hold the same rows);
  * `split_batch(mesh)` marks a block whose batch rows are split over dp:
    `models/common.StatelessBatchNorm` then takes its statistics over the
    whole batch, by all-reduces over the dp group, as JAX's statistics
    over a dp-sharded batch are global;
  * `shard_plan` applies JAX's `params_shardings` rules to the port's
    parameter names (the names `bridge.py` maps): `eh.tables.*` (JAX
    `emb_*`) by rows, CrossNetMix's `U_i` / `V_i` / `C_i` by experts, and
    in the `lm` / `lm_lower` scopes Megatron tensor parallelism (TP) of
    the attention and the FFN of every BERT, Llama / GLM and OPT layer;
    `place_model` cuts every sharded parameter to this rank's slice in
    place (the Parameter objects stay, so an optimizer built before keeps
    them, and Adam's moments, made at the first step, follow the slice:
    JAX's `place_opt_state`) and tells the modules their layout;
  * `copy_to_mp` / `reduce_from_mp` are Megatron's f and g operators;
    `reduce_gradients` is the (dp, mp) step's gradient reduction.

Collectives under gloo: all-reduce and broadcast take CUDA tensors; an
all-gather of a CUDA tensor goes through host memory (`all_gather_rows`),
and a reduce-scatter is an all-reduce and a slice (gloo has none). This is
transport only: the model, the kernels and the optimizer stay on the
card. A bf16 tensor is all-reduced in f32 under gloo.

`sp`, `pp` and `pipeline_stages` are ROADMAP.md, queue 1, item 8 and
raise.
"""
import contextlib
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
MP_AXIS = "mp"
NOT_PORTED = ("is a multi-device axis not ported yet (ROADMAP.md, queue 1, "
              "item 8); the port runs exp.policy.mesh's dp and mp axes and "
              "catalog_parallel")


def world() -> tuple:
    """(rank, size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """This process's device on its host: LOCAL_RANK (torchrun), else its
    rank modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank, _ = world()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(n, 1)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda", backend: Optional[str] = None
                         ) -> tuple:
    """Open the default process group once per process (`backend`, by
    default NCCL for `cuda` and gloo for `cpu`) and, on the card, make
    `cuda:LOCAL_RANK` the current device. Returns (rank, size)."""
    if not (dist.is_available() and dist.is_initialized()):
        cuda = torch.device(device).type == "cuda"
        backend = backend or ("nccl" if cuda else "gloo")
        if coordinator_address is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            method = (coordinator_address if "://" in coordinator_address
                      else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=method,
                                    world_size=int(num_processes),
                                    rank=int(process_id))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank())
    return world()


def shutdown():
    """Destroy the default process group, if one is open."""
    _GROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_device(device) -> torch.device:
    """`device` with this process's card index when a group is open and
    the device names none."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and world()[1] > 1):
        return torch.device("cuda", local_rank())
    return device


# --------------------------------------------------------------------- #
# the mesh                                                              #
# --------------------------------------------------------------------- #
# (dp, mp) -> (this rank's dp group, its mp group): made once per layout
_GROUPS: Dict[Tuple[int, int], tuple] = {}


def _subgroups(dp: int, mp: int) -> tuple:
    """This rank's (dp group, mp group) of the [dp, mp] layout. A group
    that is the whole world is None (the default group); every rank makes
    every subgroup, in one order (dist.new_group is collective)."""
    key = (dp, mp)
    if key not in _GROUPS:
        groups = [None, None]
        if dp > 1 and mp > 1:
            rank = dist.get_rank()
            for d in range(dp):
                ranks = [d * mp + m for m in range(mp)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[1] = g
            for m in range(mp):
                ranks = [d * mp + m for d in range(dp)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[0] = g
        _GROUPS[key] = tuple(groups)
    return _GROUPS[key]


@dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: `size` ranks, this one at
    `index`, their process group (None: the default group)."""
    size: int
    index: int
    group: object = field(default=None, compare=False, repr=False)


@dataclass(frozen=True)
class Mesh:
    """The (dp, mp) mesh: `dp * mp` processes, this one at `rank` =
    dp_index * mp + mp_index; `catalog_parallel` routes the Trainer
    through parallel/catalog.py; `min_rows_to_shard` is the table-sharding
    threshold."""
    dp: int
    rank: int
    mp: int = 1
    catalog_parallel: bool = False
    min_rows_to_shard: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        out = {DP_AXIS: self.dp}
        if self.mp > 1:
            out[MP_AXIS] = self.mp
        return out

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _groups(self) -> tuple:
        if not dist.is_initialized():
            return None, None
        return _subgroups(self.dp, self.mp)

    @property
    def dp_axis(self) -> Axis:
        """The dp group of this rank's mp column."""
        return Axis(self.dp, self.dp_index, self._groups()[0])

    @property
    def mp_axis(self) -> Axis:
        """The mp group of this rank's dp row."""
        return Axis(self.mp, self.mp_index, self._groups()[1])

    @property
    def catalog_axis(self) -> Axis:
        """Every rank, (dp, mp) flattened: the catalog rows' axis (JAX
        catalog.catalog_axes)."""
        return Axis(self.size, self.rank, None)


def make_mesh(n_dp: Optional[int] = None, n_mp: int = 1,
              catalog_parallel: bool = False,
              min_rows_to_shard: int = 0) -> Mesh:
    """The (dp, mp) mesh over the process group (all of it by default),
    its subgroups made."""
    rank, size = world()
    if n_dp is None:
        n_dp = size // n_mp
    assert n_dp * n_mp == size, f"{n_dp}x{n_mp}x1x1 != {size} devices"
    mesh = Mesh(int(n_dp), rank, int(n_mp), bool(catalog_parallel),
                int(min_rows_to_shard or 0))
    mesh._groups()
    return mesh


def mesh_from_policy(cfg) -> Mesh:
    """The experiment mesh from `exp.policy.mesh` (JAX mesh.py:163-205):
    `true` means every process, pure dp; a mapping may set `dp` (the
    default: the rest of the group), `mp`, `catalog_parallel` and
    `min_rows_to_shard`. `sp`, `pp` above 1 raise. The processes are the
    group's (one without a group); a policy that wants more raises JAX's
    ValueError, and one that leaves processes idle raises too (JAX would
    use the first devices: a process group has no idle member)."""
    if cfg is True:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ValueError(f"exp.policy.mesh must be a mapping or true, "
                         f"got {cfg!r}")
    for name in ("sp", "pp"):
        if int(cfg.get(name) or 1) > 1:
            raise NotImplementedError(
                f"exp.policy.mesh: {name}={cfg[name]} {NOT_PORTED}")
    _, n = world()
    n_mp = int(cfg.get("mp") or 1)
    n_dp = int(cfg.get("dp") or max(1, n // n_mp))
    need = n_dp * n_mp
    if need > n:
        raise ValueError(
            f"mesh policy wants {n_dp}x{n_mp}x1x1={need} devices, only {n} "
            f"visible")
    if need < n:
        raise ValueError(
            f"mesh policy wants {n_dp}x{n_mp}x1x1={need} devices of a "
            f"process group of {n}: launch {need} processes")
    return make_mesh(n_dp, n_mp, bool(cfg.get("catalog_parallel")),
                     int(cfg.get("min_rows_to_shard") or 0))


# --------------------------------------------------------------------- #
# rows of a batch                                                       #
# --------------------------------------------------------------------- #
def row_slice(n: int, mesh: Mesh) -> slice:
    """This rank's dp rows of n (n divisible by dp)."""
    assert n % mesh.dp == 0, f"{n} rows do not divide over dp={mesh.dp}"
    k = n // mesh.dp
    return slice(mesh.dp_index * k, (mesh.dp_index + 1) * k)


def shard_rows(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's dp rows of every array of a batch (JAX shard_batch: rows
    over dp on the leading axis, replicated over mp)."""
    out = type(batch)(batch)
    for k, v in batch.items():
        out[k] = v[row_slice(len(v), mesh)]
    return out


# --------------------------------------------------------------------- #
# collectives                                                           #
# --------------------------------------------------------------------- #
def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum `t` in place over the axis (nothing at size 1); a bf16 tensor
    sums in f32 under gloo."""
    if axis.size == 1 or not dist.is_initialized():
        return t
    if t.dtype == torch.bfloat16 and _gloo(axis.group):
        wide = t.float()
        dist.all_reduce(wide, group=axis.group)
        return t.copy_(wide)
    dist.all_reduce(t, group=axis.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh,
                    axis: Optional[Axis] = None) -> torch.Tensor:
    """Every rank's (k, ...) rows along `axis` (the dp axis by default),
    in axis order: (size * k, ...). Every rank gives as many rows. Under
    gloo a CUDA tensor goes through host memory (gloo has no CUDA
    all-gather)."""
    axis = axis or mesh.dp_axis
    if axis.size == 1 or not dist.is_initialized():
        return t
    src = t.contiguous()
    if src.is_cuda and _gloo(axis.group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts).to(t.device)


class _CopyToMP(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce over mp backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.axis), None


class _ReduceFromMP(torch.autograd.Function):
    """Megatron's g: all-reduce over mp forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_mp(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The input of column-parallel products: its gradient is summed over
    the mp group (each rank's columns give part of it)."""
    return x if axis is None else _CopyToMP.apply(x, axis)


def reduce_from_mp(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The output of row-parallel products: the ranks' partial sums summed
    over the mp group."""
    return x if axis is None else _ReduceFromMP.apply(x, axis)


def _flat_reduce(grads: List[torch.Tensor], axis: Axis, scale: float):
    """Sum each dtype's grads over the axis in one flat buffer, then
    multiply by `scale`; in place."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for live in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in live])
        all_reduce_(flat, axis)
        if scale != 1.0:
            flat *= scale
        off = 0
        for g in live:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def reduce_gradients(params: List[torch.Tensor], loss: torch.Tensor,
                     mesh: Mesh, partial: Tuple[torch.Tensor, ...] = (),
                     over: Optional[Axis] = None) -> torch.Tensor:
    """The (dp, mp) step's reduction; returns the mean loss. First the
    gradients in `partial` (replicated parameters inside a sharded
    product: each mp rank holds part of their gradient) are summed over
    the mp group; then every gradient and the loss are averaged over the
    dp group (`over`: another axis, the catalog-parallel step's whole
    group), one all-reduce of one flat buffer a gradient dtype, the loss
    in the f32 one. A sharded parameter's gradient is averaged with the
    same shard's on the other dp ranks. A parameter without a gradient
    keeps none, as in one process. Nothing here waits for the device."""
    if not dist.is_initialized():
        return loss
    live_partial = [p.grad for p in partial if p.grad is not None]
    if live_partial and mesh.mp > 1:
        _flat_reduce(live_partial, mesh.mp_axis, 1.0)
    axis = over or mesh.dp_axis
    if axis.size == 1:
        return loss
    lbuf = loss.detach().float().reshape(1)
    grads = [lbuf] + [p.grad for p in params if p.grad is not None]
    _flat_reduce(grads, axis, 1.0 / axis.size)
    return lbuf.reshape(())


def barrier(mesh: Optional[Mesh]):
    if mesh is not None and dist.is_initialized():
        dist.barrier()


# --------------------------------------------------------------------- #
# batch statistics over a split batch                                   #
# --------------------------------------------------------------------- #
_SPLIT_MESH: Optional[Mesh] = None


def split_mesh() -> Optional[Mesh]:
    """The mesh whose dp ranks hold the rows of the batch being computed,
    when there is more than one; else None."""
    return _SPLIT_MESH


@contextlib.contextmanager
def split_batch(mesh: Optional[Mesh]):
    """Mark the block as running on this rank's rows of a batch split over
    `mesh`'s dp axis (nothing is marked at dp 1: the rows are the batch)."""
    global _SPLIT_MESH
    prev = _SPLIT_MESH
    _SPLIT_MESH = mesh if mesh is not None and mesh.dp > 1 else None
    try:
        yield
    finally:
        _SPLIT_MESH = prev


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis; its backward sums the gradients over the axis
    (each rank's loss reaches every rank's input)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.axis), None


def global_var_mean(x: torch.Tensor, axes) -> tuple:
    """(var, mean) of f32 `x` over `axes` and over every dp rank's rows of
    the split batch, the sums all-reduced over the dp group through
    autograd, so that each rank's backward reaches every rank's rows as
    JAX's global statistics do (the mp ranks of a dp row hold the same
    rows: they are counted once). Population variance, two passes (the
    mean first)."""
    axis = _SPLIT_MESH.dp_axis
    count = torch.tensor(float(np.prod([x.shape[a] for a in axes])),
                         device=x.device)
    all_reduce_(count, axis)
    mean = _AllReduceSum.apply(x.sum(dim=axes, keepdim=True), axis) / count
    var = _AllReduceSum.apply(
        ((x - mean) ** 2).sum(dim=axes, keepdim=True), axis) / count
    return var, mean


# --------------------------------------------------------------------- #
# the model-parallel plan (JAX params_shardings, mesh.py:221-278)        #
# --------------------------------------------------------------------- #
# Megatron-style TP of the LM slices: the first product of each pair is
# column-sharded (its bias too), the second row-sharded (its bias
# replicated, added after the all-reduce)
TP_COL_SHARDED = {"query", "key", "value", "q_proj", "k_proj", "v_proj",
                  "intermediate", "fc1", "gate_proj", "up_proj"}
TP_ROW_SHARDED = {"output", "o_proj", "out_proj", "ffn_output", "fc2",
                  "down_proj"}
_MIX_LEAF = re.compile(r"(U|V|C)_\d+")


@dataclass
class ShardPlan:
    """What `place_model` does at mp `n_mp`: `sharded` {parameter name:
    the dim it is split on} (JAX's sharded set, in the port's names and
    layouts); `partial` the replicated parameters whose gradient each mp
    rank holds part of (LoRA factors of a sharded product, CrossNetMix's
    gates and bias); `tables`, `mixes` and `tp` the modules told their
    layout (`tp`: (layer name, attention sharded, FFN sharded))."""
    n_mp: int
    sharded: Dict[str, int] = field(default_factory=dict)
    partial: Tuple[str, ...] = ()
    tables: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    mixes: Tuple[str, ...] = ()
    tp: Tuple[Tuple[str, bool, bool], ...] = ()
    axis: Optional[Axis] = None  # the mp axis, once placed


def shard_plan(model: torch.nn.Module, mesh: Mesh,
               min_rows_to_shard: Optional[int] = None) -> ShardPlan:
    """JAX's `params_shardings` rules on the port's model at `mesh.mp`:
      * an `eh.tables.<kind>__<name>` table (JAX `emb_*`) with rows >=
        max(min_rows_to_shard, n_mp) and rows % n_mp == 0, by rows;
      * a CrossNetMix's `U_i` / `V_i` / `C_i` whose experts divide, by
        experts (its gates and bias replicated, their gradients partial);
      * in the `lm` / `lm_lower` scopes, every BERT, Llama / GLM and OPT
        layer: the column-parallel products (q, k, v, the FFN's first) by
        output features, their biases too; the row-parallel ones (the
        attention output, the FFN's second) by input features; LoRA
        factors and norms replicated. A layer whose
        heads (or kv heads) do not divide by n_mp keeps its attention
        whole, one whose FFN width does not divide its FFN: the same
        result (JAX would shard by the column counts alone).
    Empty at mp 1."""
    from legommenders_tpu_torch.models.embedding import EmbeddingTables
    from legommenders_tpu_torch.models.lm.layers import TP_LAYERS
    from legommenders_tpu_torch.models.predictors.cross import CrossNetMix

    n = mesh.mp
    plan = ShardPlan(n)
    if n <= 1:
        return plan
    min_rows = (mesh.min_rows_to_shard if min_rows_to_shard is None
                else int(min_rows_to_shard))
    partial, mixes, tp = [], [], []
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, EmbeddingTables):
            rows = []
            for key, table in mod.tables.items():
                r = table.shape[0]
                if table.dim() == 2 and r >= max(min_rows, n) and r % n == 0:
                    plan.sharded[f"{prefix}tables.{key}"] = 0
                    rows.append(key)
            if rows:
                plan.tables[name] = tuple(rows)
        elif isinstance(mod, CrossNetMix):
            if mod.num_experts % n:
                continue
            mixes.append(name)
            for pname, p in mod.named_parameters(recurse=False):
                if _MIX_LEAF.fullmatch(pname):
                    plan.sharded[prefix + pname] = 0
                else:
                    partial.append(prefix + pname)
            for gname, _ in mod.named_parameters():
                if gname.startswith("gate_"):
                    partial.append(prefix + gname)
        elif (isinstance(mod, TP_LAYERS)
              and ({"lm", "lm_lower"} & set(name.split(".")))):
            attn, ffn, attn_ok, ffn_ok = mod.tp_pairs(n)
            if not (attn_ok or ffn_ok):
                continue
            tp.append((name, attn_ok, ffn_ok))
            for pairs, ok in ((attn, attn_ok), (ffn, ffn_ok)):
                if not ok:
                    continue
                for dense_name, dense in pairs:
                    col = dense_name.split(".")[-1] in TP_COL_SHARDED
                    full = f"{prefix}{dense_name}."
                    plan.sharded[full + "weight"] = 0 if col else 1
                    if col and dense.bias is not None:
                        plan.sharded[full + "bias"] = 0
                    if dense.lora_r > 0:
                        partial += [full + "lora_A", full + "lora_B"]
    plan.partial = tuple(partial)
    plan.mixes = tuple(mixes)
    plan.tp = tuple(tp)
    return plan


def place_model(model: torch.nn.Module, mesh: Mesh,
                plan: Optional[ShardPlan] = None) -> ShardPlan:
    """Cut every parameter of `plan` (shard_plan's by default) to this
    rank's mp slice in place and tell the modules their layout; the plan
    is kept as `model.shard_plan`. Call it once, on the whole weights,
    before the first optimizer step."""
    plan = plan if plan is not None else shard_plan(model, mesh)
    if plan.n_mp <= 1:
        return plan
    axis = mesh.mp_axis
    mods = dict(model.named_modules())
    for name, rows in plan.tables.items():
        mods[name].shard_rows(rows, axis)
    for name in plan.mixes:
        mods[name].shard_experts(axis)
    for name, attn, ffn in plan.tp:
        mods[name].shard_tp(axis, attn, ffn)
    from legommenders_tpu_torch.models.common import drop_cached_casts
    drop_cached_casts(model)
    plan.axis = axis
    model.shard_plan = plan
    return plan


def model_plan(model: torch.nn.Module) -> Optional[ShardPlan]:
    """The plan a model was placed by (None: whole weights)."""
    plan = getattr(model, "shard_plan", None)
    return plan if isinstance(plan, ShardPlan) and plan.n_mp > 1 else None


def partial_params(model: torch.nn.Module) -> Tuple[torch.Tensor, ...]:
    """The model's parameters whose gradient each mp rank holds part of."""
    plan = model_plan(model)
    if plan is None:
        return ()
    named = dict(model.named_parameters())
    return tuple(named[n] for n in plan.partial if n in named)


def shard_slice(full: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """Rank `axis.index`'s slice of `full` along `dim` (a copy)."""
    k = full.shape[dim] // axis.size
    return full.narrow(dim, axis.index * k, k).clone()
