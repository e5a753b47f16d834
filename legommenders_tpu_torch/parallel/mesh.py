"""The experiment mesh over torch.distributed: the data-parallel, the
model-parallel, the sequence-parallel and the pipeline-parallel axes.

The port of the JAX package's parallel/mesh.py (its `make_mesh`,
`mesh_from_policy`, `initialize_multihost`, `shard_batch`,
`params_shardings` and the ambient sp / pp meshes). JAX lays a
(dp, mp[, sp][, pp]) `jax.sharding.Mesh` over `jax.devices()`; the port
runs one process per device in a process group, whose size plays the part
of `jax.devices()`:

  * `initialize_multihost` opens the group: NCCL on `cuda` (each process on
    `cuda:LOCAL_RANK`), gloo on the CPU, or the backend asked for (gloo on
    `cuda` lets two ranks share one card, which NCCL refuses). Without a
    coordinator it reads the `torchrun` environment (`env://`);
    `--coordinator host:port --num_processes N --process_id i` is JAX's
    manual launch; a coordinator with a scheme (`file:///...`,
    `tcp://...`) is taken as the init method itself;
  * `mesh_from_policy` reads `exp.policy.mesh` as JAX does (`true`: every
    process, pure dp; `mp`, `sp`, `pp`, `catalog_parallel`,
    `min_rows_to_shard`; dp defaults to the rest) and checks it with JAX's
    messages; any of mp, sp and pp may be above 1 at once. JAX reshapes
    the devices to [dp, mp, sp, pp] (sp and pp only where above 1), so
    rank = ((dp_index * mp + mp_index) * sp + sp_index) * pp + pp_index.
    The mesh holds one family of subgroups an axis (`dist.new_group`,
    made once per layout by every rank in one order): the ranks that
    differ only in that axis's index; and the catalog family, the (dp,
    mp) ranks at one (sp, pp) index (JAX's `catalog_axes`: sp and pp
    stay out), over which `catalog_parallel` shards the catalog's rows;
  * `shard_rows` is a batch's rows of this rank's dp index, in place of
    `shard_batch` (the mp, sp and pp ranks of one dp row hold the same
    rows);
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
  * `copy_to_mp` / `reduce_from_mp` are Megatron's f and g operators (over
    any axis: sp's and pp's replicated results are g's too);
    `scatter_seq`, `all_to_all`, `ring_shift` and `gather_grad` are
    the sp and pp axes' differentiable transfers; `reduce_gradients` is
    the step's gradient reduction: the partial gradients summed over mp,
    sp and pp, then every gradient averaged over dp;
  * `sequence_parallel` / `get_sp_mesh` / `set_sp_mesh` and
    `pipeline_parallel` / `get_pp_mesh` / `set_pp_mesh` / `no_pipeline`
    are JAX's ambient meshes: a `sequence_parallel` operator shards its
    sequence under the first, a slice with `pipeline_stages` stages its
    layers under the second (parallel/pipeline.py), and evaluation runs
    the serial stack under `no_pipeline`.
  * `count_collectives` counts the bytes this process's collectives move,
    by kind under the names of XLA's HLO (`all-reduce`, `all-gather`,
    `all-to-all`, `collective-permute`), as the JAX package's
    scaling.collective_volume reads them from the compiled HLO: each
    call's result in the tensor's own dtype. Every collective of the
    port goes through `all_reduce_`, `all_gather_dim`, `_all_to_all` and
    `_shift`; off by default, the counter costs each of them one check of
    a module flag.

Collectives under gloo: all-reduce, broadcast and all-to-all take CUDA
tensors (an all-to-all of CUDA tensors checked on the card: chip_smoke.py
phase 14); an all-gather and a point-to-point send / receive of a CUDA
tensor go through host memory (gloo's send takes a tensor's data pointer
as host memory), and a reduce-scatter is an all-reduce and a slice (gloo
has none). This is
transport only: the model, the kernels and the optimizer stay on the
card. A bf16 tensor is all-reduced in f32 under gloo.

The axes compose because each transfer stays inside its own subgroup: a
row-sharded table's gather and a TP layer's f and g inside the rank's mp
group, an sp transfer inside its sp group, a pipeline shift inside its pp
group; the ranks of one group run the same schedule, so their collectives
meet in one order.
"""
import contextlib
import itertools
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
MP_AXIS = "mp"
SP_AXIS = "sp"
PP_AXIS = "pp"
AXES = (DP_AXIS, MP_AXIS, SP_AXIS, PP_AXIS)
# the catalog family's key in a layout's groups: (dp, mp) at one (sp, pp)
CATALOG = "catalog"


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
def _coords(rank: int, dims: Tuple[int, ...]) -> Tuple[int, ...]:
    """The [dp, mp, sp, pp] indices of `rank` (JAX's reshape order)."""
    out = []
    for n in reversed(dims):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _rank_of(coords, dims) -> int:
    r = 0
    for c, n in zip(coords, dims):
        r = r * n + c
    return r


# (dp, mp, sp, pp) -> {axis or CATALOG: (this rank's group, its global
# ranks)}: made once per layout
_GROUPS: Dict[Tuple[int, ...], Dict[str, tuple]] = {}


def _family(dims: Tuple[int, ...], axes: Tuple[int, ...], rank: int):
    """Every group of ranks that differ only in the indices of `axes` (in
    the [dp, mp, sp, pp] order, the first axis slowest), made in one order
    on every rank (dist.new_group is collective); returns this rank's
    (group, global ranks). A group that is the whole world is None (the
    default group)."""
    size = int(np.prod(dims))
    inner = [range(dims[a]) for a in axes]
    if int(np.prod([dims[a] for a in axes])) == size:
        return None, tuple(range(size))
    rest = [range(m) for i, m in enumerate(dims) if i not in axes]
    mine = None
    for fixed in itertools.product(*rest):
        ranks = []
        for moving in itertools.product(*inner):
            coords, f, m = [], iter(fixed), iter(moving)
            for i in range(len(dims)):
                coords.append(next(m) if i in axes else next(f))
            ranks.append(_rank_of(coords, dims))
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = (g, tuple(ranks))
    return mine


def _subgroups(dims: Tuple[int, ...]) -> Dict[str, tuple]:
    """This rank's group of every axis above 1 of the [dp, mp, sp, pp]
    layout (the ranks that differ from it in that axis's index only), and,
    where dp * mp is above 1, its catalog group (the ranks that differ
    from it in their (dp, mp) indices only)."""
    if dims not in _GROUPS:
        rank = dist.get_rank()
        groups = {}
        for a, n in enumerate(dims):
            if n > 1:
                groups[AXES[a]] = _family(dims, (a,), rank)
        if dims[0] * dims[1] > 1:
            groups[CATALOG] = _family(dims, (0, 1), rank)
        _GROUPS[dims] = groups
    return _GROUPS[dims]


@dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: `size` ranks, this one at
    `index`, their process group (None: the default group) and their
    global ranks in axis order (empty: 0 .. size - 1)."""
    size: int
    index: int
    group: object = field(default=None, compare=False, repr=False)
    ranks: Tuple[int, ...] = field(default=(), compare=False, repr=False)

    def global_rank(self, i: int) -> int:
        """The global rank of the axis's member `i` (modulo its size)."""
        i %= self.size
        return self.ranks[i] if self.ranks else i


@dataclass(frozen=True)
class Mesh:
    """The [dp, mp, sp, pp] mesh: `dp * mp * sp * pp` processes, this one
    at `rank` = ((dp_index * mp + mp_index) * sp + sp_index) * pp +
    pp_index; `catalog_parallel` routes the Trainer through
    parallel/catalog.py; `min_rows_to_shard` is the table-sharding
    threshold."""
    dp: int
    rank: int
    mp: int = 1
    catalog_parallel: bool = False
    min_rows_to_shard: int = 0
    sp: int = 1
    pp: int = 1

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        return self.dp, self.mp, self.sp, self.pp

    @property
    def shape(self) -> Dict[str, int]:
        """dp, then every other axis above 1 (JAX's axis names)."""
        out = {DP_AXIS: self.dp}
        for name, n in zip(AXES[1:], self.dims[1:]):
            if n > 1:
                out[name] = n
        return out

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    @property
    def coords(self) -> Tuple[int, int, int, int]:
        return _coords(self.rank, self.dims)

    @property
    def dp_index(self) -> int:
        return self.coords[0]

    @property
    def mp_index(self) -> int:
        return self.coords[1]

    @property
    def sp_index(self) -> int:
        return self.coords[2]

    @property
    def pp_index(self) -> int:
        return self.coords[3]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def axis(self, name: str) -> Axis:
        """This rank's group along axis `name`."""
        a = AXES.index(name)
        n, i = self.dims[a], self.coords[a]
        if n == 1 or not dist.is_initialized():
            return Axis(n, i)
        group, ranks = _subgroups(self.dims)[name]
        return Axis(n, i, group, ranks)

    @property
    def dp_axis(self) -> Axis:
        """The ranks that differ from this one in their dp index only."""
        return self.axis(DP_AXIS)

    @property
    def mp_axis(self) -> Axis:
        """The ranks that differ from this one in their mp index only."""
        return self.axis(MP_AXIS)

    @property
    def sp_axis(self) -> Axis:
        """The ranks that differ from this one in their sp index only."""
        return self.axis(SP_AXIS)

    @property
    def pp_axis(self) -> Axis:
        """The ranks that differ from this one in their pp index only."""
        return self.axis(PP_AXIS)

    @property
    def catalog_axis(self) -> Axis:
        """The catalog rows' axis (JAX catalog.catalog_axes): this rank's
        (dp, mp) ranks at its (sp, pp) index, (dp, mp) flattened, so the
        sp ranks of one (dp, mp) cell hold the same catalog rows."""
        n = self.dp * self.mp
        i = self.dp_index * self.mp + self.mp_index
        if n == 1 or not dist.is_initialized():
            return Axis(n, i)
        group, ranks = _subgroups(self.dims)[CATALOG]
        return Axis(n, i, group, ranks)


def make_mesh(n_dp: Optional[int] = None, n_mp: int = 1,
              catalog_parallel: bool = False,
              min_rows_to_shard: int = 0, n_sp: int = 1,
              n_pp: int = 1) -> Mesh:
    """The [dp, mp, sp, pp] mesh over the process group (all of it by
    default), its subgroups made."""
    rank, size = world()
    if n_dp is None:
        n_dp = size // (n_mp * n_sp * n_pp)
    assert n_dp * n_mp * n_sp * n_pp == size, \
        f"{n_dp}x{n_mp}x{n_sp}x{n_pp} != {size} devices"
    mesh = Mesh(int(n_dp), rank, int(n_mp), bool(catalog_parallel),
                int(min_rows_to_shard or 0), int(n_sp), int(n_pp))
    if dist.is_initialized():
        _subgroups(mesh.dims)
    return mesh


def mesh_from_policy(cfg) -> Mesh:
    """The experiment mesh from `exp.policy.mesh` (JAX mesh.py:163-205):
    `true` means every process, pure dp; a mapping may set `dp` (the
    default: the rest of the group), `mp`, `sp`, `pp`, `catalog_parallel`
    and `min_rows_to_shard`. The processes are the group's (one without a
    group); a policy that wants more raises JAX's ValueError, and one that
    leaves processes idle raises too (JAX would use the first devices: a
    process group has no idle member). pp with catalog_parallel is
    stopped where JAX stops it, by the Manager."""
    if cfg is True:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ValueError(f"exp.policy.mesh must be a mapping or true, "
                         f"got {cfg!r}")
    _, n = world()
    n_mp = int(cfg.get("mp") or 1)
    n_sp = int(cfg.get("sp") or 1)
    n_pp = int(cfg.get("pp") or 1)
    n_dp = int(cfg.get("dp") or max(1, n // (n_mp * n_sp * n_pp)))
    need = n_dp * n_mp * n_sp * n_pp
    shape = f"{n_dp}x{n_mp}x{n_sp}x{n_pp}"
    if need > n:
        raise ValueError(
            f"mesh policy wants {shape}={need} devices, only {n} visible")
    if need < n:
        raise ValueError(
            f"mesh policy wants {shape}={need} devices of a process group "
            f"of {n}: launch {need} processes")
    return make_mesh(n_dp, n_mp, bool(cfg.get("catalog_parallel")),
                     int(cfg.get("min_rows_to_shard") or 0), n_sp, n_pp)


# --------------------------------------------------------------------- #
# the ambient sp and pp meshes (JAX mesh.py:23-113)                     #
# --------------------------------------------------------------------- #
_SP_MESH: Optional[Mesh] = None
_PP_MESH: Optional[Mesh] = None


def get_sp_mesh() -> Optional[Mesh]:
    return _SP_MESH


def set_sp_mesh(mesh: Optional[Mesh]):
    global _SP_MESH
    _SP_MESH = mesh


def get_pp_mesh() -> Optional[Mesh]:
    return _PP_MESH


def set_pp_mesh(mesh: Optional[Mesh]):
    global _PP_MESH
    _PP_MESH = mesh


@contextlib.contextmanager
def sequence_parallel(mesh: Mesh):
    """Operators flagged `sequence_parallel` shard their sequence over the
    mesh's sp axis inside the block."""
    assert mesh.sp > 1, f"mesh {mesh.shape} lacks a '{SP_AXIS}' axis"
    prev = get_sp_mesh()
    set_sp_mesh(mesh)
    try:
        yield mesh
    finally:
        set_sp_mesh(prev)


@contextlib.contextmanager
def pipeline_parallel(mesh: Mesh):
    """LM slices with `pipeline_stages` stage their layers over the mesh's
    pp axis inside the block."""
    assert mesh.pp > 1, f"mesh {mesh.shape} lacks a '{PP_AXIS}' axis"
    prev = get_pp_mesh()
    set_pp_mesh(mesh)
    try:
        yield mesh
    finally:
        set_pp_mesh(prev)


@contextlib.contextmanager
def no_pipeline():
    """The serial layer stack inside the block (evaluation and the cache
    builds: the same weights and math on every rank)."""
    prev = get_pp_mesh()
    set_pp_mesh(None)
    try:
        yield None
    finally:
        set_pp_mesh(prev)


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
# {kind: bytes} inside `count_collectives`, else None
_COUNTS: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def count_collectives():
    """`with count_collectives() as c:` fills c, {kind: bytes}, with the
    bytes of every collective this process makes inside the block: an
    all-reduce counts its tensor, an all-gather its concatenated output,
    an all-to-all and a shift the tensor received, each in its own dtype
    (a bf16 sum that gloo takes in f32 counts at bf16, what NCCL moves; a
    transfer's host copies and a barrier count nothing). A sum or a
    gather over an axis of size 1 makes no collective and counts nothing.
    A block inside another counts into its own dict only."""
    global _COUNTS
    prev, _COUNTS = _COUNTS, {}
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def _count(kind: str, t: torch.Tensor, times: int = 1):
    _COUNTS[kind] = (_COUNTS.get(kind, 0)
                     + t.numel() * t.element_size() * times)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum `t` in place over the axis (nothing at size 1); a bf16 tensor
    sums in f32 under gloo."""
    if axis.size == 1 or not dist.is_initialized():
        return t
    if _COUNTS is not None:
        _count("all-reduce", t)
    if t.dtype == torch.bfloat16 and _gloo(axis.group):
        wide = t.float()
        dist.all_reduce(wide, group=axis.group)
        return t.copy_(wide)
    dist.all_reduce(t, group=axis.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh,
                    axis: Optional[Axis] = None) -> torch.Tensor:
    """Every rank's (k, ...) rows along `axis` (the dp axis by default),
    in axis order: (size * k, ...). Every rank gives as many rows."""
    if not dist.is_initialized():
        return t
    return all_gather_dim(t, axis or mesh.dp_axis, 0)


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


def _via_host(t: torch.Tensor, axis: Axis) -> bool:
    """Whether a gather or a send of `t` over `axis` goes through host
    memory (gloo takes them on CPU tensors only: its send reads a tensor's
    data pointer as host memory)."""
    return t.is_cuda and _gloo(axis.group)


def all_gather_dim(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every member's `t` (one shape on all) concatenated along `dim`, in
    axis order."""
    if axis.size == 1:
        return t
    src = t.contiguous()
    if _COUNTS is not None:
        _count("all-gather", src, axis.size)
    if _via_host(src, axis):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.device)


def _all_to_all(t: torch.Tensor, axis: Axis, split: int,
                cat: int) -> torch.Tensor:
    """Chunk j of `t` along `split` to member j; the chunks received,
    concatenated along `cat` in member order."""
    send = torch.stack(t.chunk(axis.size, dim=split)).contiguous()
    recv = torch.empty_like(send)
    if _COUNTS is not None:
        _count("all-to-all", recv)
    dist.all_to_all_single(recv, send, group=axis.group)
    return torch.cat(recv.unbind(0), dim=cat)


def _shift(t: torch.Tensor, axis: Axis, offset: int) -> torch.Tensor:
    """Member i's `t` to member i + offset (modulo the size); returns what
    member i - offset sent."""
    src = t.contiguous()
    if _via_host(src, axis):
        src = src.cpu()
    recv = torch.empty_like(src)
    if _COUNTS is not None:
        _count("collective-permute", recv)
    ops = [dist.P2POp(dist.isend, src,
                      axis.global_rank(axis.index + offset), axis.group),
           dist.P2POp(dist.irecv, recv,
                      axis.global_rank(axis.index - offset), axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)


class _ScatterSeq(torch.autograd.Function):
    """This member's chunk along `dim`; its backward gathers the chunks'
    gradients (every member's result reaches the whole input)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return x.chunk(axis.size, dim=dim)[axis.index].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """An all-to-all (split along one dim, concatenated along another);
    its backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, axis, split, cat):
        ctx.axis, ctx.split, ctx.cat = axis, split, cat
        return _all_to_all(x, axis, split, cat)

    @staticmethod
    def backward(ctx, grad):
        return (_all_to_all(grad, ctx.axis, ctx.cat, ctx.split),
                None, None, None)


class _RingShift(torch.autograd.Function):
    """Member i's tensor to member i + offset; the backward shifts the
    gradients the other way."""

    @staticmethod
    def forward(ctx, x, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return _shift(x, axis, offset)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.axis, -ctx.offset), None, None


class _GatherGrad(torch.autograd.Function):
    """Every member's tensor concatenated along `dim`, in axis order; the
    backward sums the gradients over the axis and keeps this member's part
    (each member's loss reads every member's part)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.k = axis, dim, x.shape[dim]
        return all_gather_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.axis)
        return grad.narrow(ctx.dim, ctx.axis.index * ctx.k, ctx.k), None, None


def scatter_seq(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This sp member's positions of a replicated sequence (B, L, ...)."""
    return _ScatterSeq.apply(x, axis, 1)


def all_to_all(x: torch.Tensor, axis: Axis, split: int,
               cat: int) -> torch.Tensor:
    """Differentiable all-to-all over `axis` (JAX lax.all_to_all, tiled)."""
    return _AllToAll.apply(x, axis, split, cat)


def ring_shift(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Differentiable ring shift, member i's tensor to member i + 1 (JAX
    lax.ppermute over i -> i + 1)."""
    return _RingShift.apply(x, axis, 1)


def gather_grad(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Differentiable all-gather along `dim` over `axis`."""
    return x if axis.size == 1 else _GatherGrad.apply(x, axis, dim)


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
                     mesh: Mesh, partial=(),
                     over: Optional[Axis] = None) -> torch.Tensor:
    """The step's reduction; returns the mean loss. First the gradients in
    `partial` ({axis name: parameters}, `partial_params`'s; a sequence is
    mp's) are summed over their axis: over mp the replicated parameters
    inside sharded products, over sp a sequence-sharded operator's (each
    rank's positions give part of it), over pp a staged slice's layers
    (each rank computes its stage's; a layer without a gradient on this
    rank takes zeros). Then every gradient and the loss are averaged over
    the dp group (`over`: another axis, the catalog-parallel step's whole
    group), one all-reduce of one flat buffer a gradient dtype, the loss
    in the f32 one. A sharded parameter's gradient is averaged with the
    same shard's on the other dp ranks. A parameter without a gradient
    keeps none, as in one process. Nothing here waits for the device."""
    if not dist.is_initialized():
        return loss
    if not isinstance(partial, dict):
        partial = {MP_AXIS: partial}
    for name, ps in partial.items():
        axis = mesh.axis(name)
        if axis.size == 1:
            continue
        if name == PP_AXIS:
            for p in ps:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        live = [p.grad for p in ps if p.grad is not None]
        if live:
            _flat_reduce(live, axis, 1.0)
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


def partial_params(model: torch.nn.Module
                   ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """The model's trainable parameters whose gradient each rank of an axis
    holds part of, by axis: mp's (the plan's replicated parameters inside
    sharded products), sp's (each module's `sp_partial_parameters()`: a
    sequence-parallel operator's) and pp's (`pp_partial_parameters()`: a
    staged slice's layers)."""
    out = {}
    plan = model_plan(model)
    if plan is not None:
        named = dict(model.named_parameters())
        out[MP_AXIS] = tuple(named[n] for n in plan.partial if n in named)
    for name in (SP_AXIS, PP_AXIS):
        found = []
        for mod in model.modules():
            hook = getattr(mod, f"{name}_partial_parameters", None)
            if hook is not None:
                found += [p for p in hook() if p.requires_grad]
        if found:
            out[name] = tuple(dict.fromkeys(found))
    return out


def shard_slice(full: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """Rank `axis.index`'s slice of `full` along `dim` (a copy)."""
    k = full.shape[dim] // axis.size
    return full.narrow(dim, axis.index * k, k).clone()
