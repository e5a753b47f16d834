"""The experiment mesh over torch.distributed: the data-parallel axis.

The port of the JAX package's parallel/mesh.py (its `make_mesh`,
`mesh_from_policy`, `initialize_multihost` and `shard_batch`). JAX lays a
(dp, mp[, sp][, pp]) `jax.sharding.Mesh` over `jax.devices()`; the port
runs one process per device in a process group, whose size plays the part
of `jax.devices()`:

  * `initialize_multihost` opens the group: NCCL on `cuda` (each process on
    `cuda:LOCAL_RANK`), gloo on the CPU. Without a coordinator it reads the
    `torchrun` environment (`env://`); `--coordinator host:port
    --num_processes N --process_id i` is JAX's manual launch; a
    coordinator with a scheme (`file:///...`, `tcp://...`) is taken as the
    init method itself;
  * `mesh_from_policy` reads `exp.policy.mesh` as JAX does (`true`: every
    process, pure dp) and checks it with JAX's messages; the dp width must
    be the group's size;
  * `shard_rows` is a batch's rows of this rank, in place of `shard_batch`;
  * `split_batch(mesh)` marks a block whose batch rows are split over dp:
    `models/common.StatelessBatchNorm` then takes its statistics over the
    whole batch, by all-reduces over the group, as JAX's statistics over a
    dp-sharded batch are global.

The model-parallel axis (`mp`: row-sharded tables, expert-sharded
CrossNetMix, Megatron TP of the LM slices), `sp`, `pp` and
`catalog_parallel` are ROADMAP.md, queue 1, item 8 and raise.
"""
import contextlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
NOT_PORTED = ("is a multi-device axis not ported yet (ROADMAP.md, queue 1, "
              "item 8); the port runs exp.policy.mesh's dp axis only")


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
                         device="cuda") -> tuple:
    """Open the default process group once per process (NCCL for `cuda`,
    gloo for `cpu`) and, on the card, make `cuda:LOCAL_RANK` the current
    device. Returns (rank, size)."""
    if not (dist.is_available() and dist.is_initialized()):
        cuda = torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
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


@dataclass(frozen=True)
class Mesh:
    """The dp axis: `dp` processes, this one at `rank`."""
    dp: int
    rank: int

    @property
    def shape(self) -> Dict[str, int]:
        return {DP_AXIS: self.dp}

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(n_dp: Optional[int] = None) -> Mesh:
    """The (dp,) mesh over the process group (all of it by default)."""
    rank, size = world()
    if n_dp is None:
        n_dp = size
    assert n_dp == size, f"{n_dp}x1x1x1 != {size} devices"
    return Mesh(int(n_dp), rank)


def mesh_from_policy(cfg) -> Mesh:
    """The experiment mesh from `exp.policy.mesh` (JAX mesh.py:163-205):
    `true` means every process, pure dp; a mapping may set `dp` (the
    default: the rest of the group). `mp`, `sp`, `pp` above 1 and
    `catalog_parallel` raise. The processes are the group's (one without a
    group); a policy that wants more raises JAX's ValueError, and one that
    leaves processes idle raises too (JAX would use the first devices: a
    process group has no idle member)."""
    if cfg is True:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ValueError(f"exp.policy.mesh must be a mapping or true, "
                         f"got {cfg!r}")
    if cfg.get("catalog_parallel"):
        raise NotImplementedError(
            f"exp.policy.mesh: catalog_parallel {NOT_PORTED}")
    for name in ("mp", "sp", "pp"):
        if int(cfg.get(name) or 1) > 1:
            raise NotImplementedError(
                f"exp.policy.mesh: {name}={cfg[name]} {NOT_PORTED}")
    _, n = world()
    n_dp = int(cfg.get("dp") or n)
    if n_dp > n:
        raise ValueError(
            f"mesh policy wants {n_dp}x1x1x1={n_dp} devices, only {n} "
            f"visible")
    if n_dp < n:
        raise ValueError(
            f"mesh policy wants {n_dp}x1x1x1={n_dp} devices of a process "
            f"group of {n}: launch {n_dp} processes")
    return make_mesh(n_dp)


# --------------------------------------------------------------------- #
# rows of a batch                                                       #
# --------------------------------------------------------------------- #
def row_slice(n: int, mesh: Mesh) -> slice:
    """This rank's rows of n (n divisible by dp)."""
    assert n % mesh.dp == 0, f"{n} rows do not divide over dp={mesh.dp}"
    k = n // mesh.dp
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_rows(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of every array of a batch (JAX shard_batch: rows
    over dp on the leading axis)."""
    out = type(batch)(batch)
    for k, v in batch.items():
        out[k] = v[row_slice(len(v), mesh)]
    return out


# --------------------------------------------------------------------- #
# collectives                                                           #
# --------------------------------------------------------------------- #
def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (k, ...) rows, in rank order: (dp * k, ...). Every rank
    gives as many rows."""
    if mesh.dp == 1 and not dist.is_initialized():
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.dp)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def average_gradients(params: List[torch.Tensor], loss: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """The mean over the group of every parameter's gradient (one
    all-reduce of one flat buffer a gradient dtype, the loss in the f32
    one) and of the loss; returns the mean loss. A parameter without a
    gradient keeps none, as in one process: every rank runs the same model
    on the same code path, so the same parameters have one. Nothing here
    waits for the device."""
    if not dist.is_initialized():
        return loss
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {
        loss.dtype: [loss.detach().reshape(1)]}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for live in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in live])
        dist.all_reduce(flat)
        flat /= mesh.dp
        off = 0
        for g in live:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
    return by_dtype[loss.dtype][0].reshape(())


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
    """Sum over the group; its backward sums the gradients over the group
    (each rank's loss reaches every rank's input)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def global_var_mean(x: torch.Tensor, axes) -> tuple:
    """(var, mean) of f32 `x` over `axes` and over every rank's rows of the
    split batch, the sums all-reduced through autograd, so that each
    rank's backward reaches every rank's rows as JAX's global statistics
    do. Population variance, two passes (the mean first)."""
    count = torch.tensor(float(np.prod([x.shape[a] for a in axes])),
                         device=x.device)
    dist.all_reduce(count)
    mean = _AllReduceSum.apply(x.sum(dim=axes, keepdim=True)) / count
    var = _AllReduceSum.apply(
        ((x - mean) ** 2).sum(dim=axes, keepdim=True)) / count
    return var, mean
