"""Catalog-parallel training: the item catalog sharded over every rank.

The port of the JAX package's parallel/catalog.py (`catalog_axes`,
`pad_catalog`, `place_catalog`, `sharded_catalog_encode`,
`make_catalog_parallel_step`). Two problems at once: the layer-split LM
cache of a large catalog need not fit one device (rank r holds only its
rows), and the whole-catalog encode, replicated under plain dp, costs
each rank 1/n of it.

  * the catalog rows are split over every rank, (dp, mp) flattened, and
    padded to a multiple of the group by repeating the last row (the
    padded rows encode cleanly and are never gathered: occurrence ids
    stay < N);
  * each rank encodes its own rows with the model's own
    `encode_item_content` (paging and remat apply; the catalog gradient
    plans do not, as in JAX: the lookup takes the plain transpose), its
    dropout generator folding the flattened index, so masks differ
    across shards;
  * `gather_catalog` all-gathers the (N, D) reprs; its backward sums
    every rank's cotangent into the owner's rows (an all-reduce and a
    slice: gloo has no reduce-scatter);
  * the user side and the predictor run on the rank's dp rows (the mp
    ranks of a dp row alike), their batch statistics over the dp group;
  * each rank's loss is its own; the gradients and the loss are averaged
    over the whole group, which gives the gradient of the dp mean loss
    for the item side (every rank's loss reaches every shard through the
    gather's backward) and for the user side (each dp row counted mp
    times over n = dp * mp).
Parameters stay whole on every rank (JAX places them replicated).
With `assemble` (the device pipeline's) the batch is assembled in the
step from the step's generator, as the fused dp step does (JAX
catalog.py:133-140, 152-154: catalog_parallel COMPOSES with
device_batching).
"""
from typing import Callable, Dict, Optional, Tuple

import torch

from legommenders_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_, reduce_gradients, shard_rows,
    split_batch,
)
from legommenders_tpu_torch.runtime.steps import (
    neg_sampling_loss, ranking_loss, step_generator,
)

# folded into the item encode's generator with the flattened index, so the
# encode draws apart from the user side's dp-folded generator
_ENCODE_FOLD = 1 << 40


def catalog_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the catalog rows shard over: (dp, mp) flattened."""
    return ("dp", "mp") if mesh.mp > 1 else ("dp",)


def pad_catalog(contents: Dict[str, torch.Tensor], n_dev: int
                ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Every content column's rows padded to a multiple of n_dev by
    repeating the last row. Returns (padded contents, original N)."""
    n = next(iter(contents.values())).shape[0]
    pad = (-n) % n_dev
    if pad == 0:
        return dict(contents), n
    return {c: torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
            for c, a in contents.items()}, n


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a catalog of n rows padded to the group."""
    k = -(-n // mesh.size)
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def place_catalog(contents: Dict[str, torch.Tensor], mesh: Mesh
                  ) -> Tuple[Dict[str, torch.Tensor], int]:
    """This rank's rows of every column, padded (copies: the rank keeps
    only N / n rows). Returns (local contents, original N)."""
    padded, n = pad_catalog(contents, mesh.size)
    rows = local_rows(n, mesh)
    return {c: a[rows].clone() for c, a in padded.items()}, n


class _GatherCatalog(torch.autograd.Function):
    """All-gather of every rank's (k, D) reprs; the backward sums every
    rank's cotangent and keeps this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh, ctx.rows = mesh, local.shape[0]
        return all_gather_rows(local, mesh, mesh.catalog_axis)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.mesh.catalog_axis)
        lo = ctx.mesh.rank * ctx.rows
        return grad[lo:lo + ctx.rows].contiguous(), None


def gather_catalog(local: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """Every rank's reprs, (N, D), the padding dropped."""
    if mesh.size == 1:
        return local[:n]
    return _GatherCatalog.apply(local, mesh)[:n]


def encode_generator(seed: int, step_idx: int, device, mesh: Mesh
                     ) -> torch.Generator:
    """The local encode's dropout generator: the flattened index folded."""
    return step_generator(seed, step_idx, device, _ENCODE_FOLD + mesh.rank)


def sharded_catalog_encode(model, mesh: Mesh) -> Callable:
    """encode(local contents, n, rng) -> (N, D) reprs of the whole
    catalog, each rank having encoded its own rows (`place_catalog`)."""

    def encode(local: Dict[str, torch.Tensor], n: int,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return gather_catalog(model.encode_item_content(local, rng), mesh, n)

    return encode


def make_catalog_parallel_step(model, optimizer, mesh: Mesh,
                               local_contents: Dict[str, torch.Tensor],
                               num_items: int, use_neg_sampling: bool = True,
                               seed: int = 0,
                               assemble: Optional[Callable] = None
                               ) -> Callable:
    """step(inputs, step_idx) -> the group's mean loss, the catalog encode
    sharded over every rank. `local_contents` from `place_catalog`;
    `inputs` this rank's dp rows of the batch (host batches) or, with
    `assemble`, the global batch's (B,) row indices. Rebuilds the catalog
    branch of Legommender.forward around the sharded encode; at dropout 0
    its update is one process's fused step's."""
    encode = sharded_catalog_encode(model, mesh)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    fold = mesh.dp_index

    def loss_fn(batch, rng, enc_rng):
        all_reprs = encode(local_contents, num_items, enc_rng)
        cand = batch["candidates"].clamp(0, num_items - 1)
        hist = batch["history"].clamp(0, num_items - 1)
        user_repr = model.encode_user(all_reprs[hist], batch["mask"], rng)
        scores = model.predictor(user_repr, all_reprs[cand], rng)
        if use_neg_sampling:
            return neg_sampling_loss(scores)
        return ranking_loss(scores, batch["label"])

    def step(inputs, step_idx: int):
        if assemble is None:
            device = next(iter(inputs.values())).device
            batch = inputs
            rng = step_generator(seed, step_idx, device, fold)
        else:
            device = next(model.parameters()).device
            rng = step_generator(seed, step_idx, device)
            batch = shard_rows(assemble(inputs, rng), mesh)
            if fold:
                rng = step_generator(seed, step_idx, device, fold)
        optimizer.zero_grad(set_to_none=True)
        with split_batch(mesh):
            loss = loss_fn(batch, rng,
                           encode_generator(seed, step_idx, device, mesh))
        loss.backward()
        loss = reduce_gradients(params, loss.detach(), mesh,
                                over=mesh.catalog_axis)
        optimizer.step()
        return loss

    return step
