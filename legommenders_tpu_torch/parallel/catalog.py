"""Catalog-parallel training and evaluation: the item catalog sharded
over the (dp, mp) ranks.

The port of the JAX package's parallel/catalog.py (`catalog_axes`,
`pad_catalog`, `place_catalog`, `sharded_catalog_encode`,
`make_catalog_parallel_step`). Two problems at once: the layer-split LM
cache of a large catalog need not fit one device (rank r holds only its
rows), and the whole-catalog encode, replicated under plain dp, costs
each rank 1/n of it.

  * the catalog rows are split over the catalog axis (`Mesh.catalog_axis`:
    the (dp, mp) ranks at this rank's sp index, (dp, mp) flattened; JAX's
    sp and pp stay out, so the sp ranks of one (dp, mp) cell hold the same
    rows) and padded to a multiple of it by repeating the last row (the
    padded rows encode cleanly and are never gathered: occurrence ids
    stay < N);
  * each rank encodes its own rows with the model's own
    `encode_item_content` (paging and remat apply; the catalog gradient
    plans do not, as in JAX: the lookup takes the plain transpose), its
    dropout generator folding the flattened (dp, mp) index, so masks
    differ across shards and agree over sp;
  * `gather_catalog` all-gathers the (N, D) reprs over the catalog axis;
    its backward sums the axis's cotangents into the owner's rows (an
    all-reduce and a slice: gloo has no reduce-scatter);
  * the user side and the predictor run on the rank's dp rows (the mp and
    sp ranks of a dp row alike; a `sequence_parallel` user operator
    shards its sequence over sp), their batch statistics over the dp
    group;
  * each rank's loss is its own; a sequence-parallel operator's partial
    gradients are summed over sp, then the gradients and the loss are
    averaged over the catalog axis, which gives the gradient of the dp
    mean loss for the item side (every rank's loss reaches every shard
    through the gather's backward) and for the user side (each dp row
    counted mp times over n = dp * mp);
  * evaluation (`runtime/evaluator.py`, `runtime/trainer.py`'s
    `simple_dev`): where the catalog's contents are held by rows (a
    layer-split LM's cache), each rank encodes its rows in eval mode and
    `gather_catalog` gives every rank the whole (N, D) reprs, from which
    the pages score as in one process.
Parameters stay whole on every rank (JAX places them replicated).
With `assemble` (the device pipeline's) the batch is assembled in the
step from the step's generator, as the fused dp step does (JAX
catalog.py:133-140, 152-154: catalog_parallel COMPOSES with
device_batching).
"""
from typing import Callable, Dict, Optional, Tuple

import torch

from legommenders_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_, partial_params, reduce_gradients,
    shard_rows, split_batch,
)
from legommenders_tpu_torch.runtime.steps import (
    neg_sampling_loss, ranking_loss, step_generator,
)

# folded into the item encode's generator with the flattened index, so the
# encode draws apart from the user side's dp-folded generator
_ENCODE_FOLD = 1 << 40


def catalog_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the catalog rows shard over: (dp, mp) flattened; sp
    and pp stay out."""
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
    """This rank's rows of a catalog of n rows padded to the catalog
    axis."""
    axis = mesh.catalog_axis
    k = -(-n // axis.size)
    return slice(axis.index * k, (axis.index + 1) * k)


def place_catalog(contents: Dict[str, torch.Tensor], mesh: Mesh
                  ) -> Tuple[Dict[str, torch.Tensor], int]:
    """This rank's rows of every column, padded (copies: the rank keeps
    only N / n rows, n = dp * mp). Returns (local contents, original N)."""
    padded, n = pad_catalog(contents, mesh.catalog_axis.size)
    rows = local_rows(n, mesh)
    return {c: a[rows].clone() for c, a in padded.items()}, n


class _GatherCatalog(torch.autograd.Function):
    """All-gather of the catalog axis's (k, D) reprs; the backward sums
    the axis's cotangents and keeps this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, local, axis):
        ctx.axis, ctx.rows = axis, local.shape[0]
        return all_gather_rows(local, None, axis)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.axis)
        lo = ctx.axis.index * ctx.rows
        return grad[lo:lo + ctx.rows].contiguous(), None


def gather_catalog(local: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The catalog axis's reprs, (N, D), the padding dropped."""
    axis = mesh.catalog_axis
    if axis.size == 1:
        return local[:n]
    return _GatherCatalog.apply(local, axis)[:n]


def encode_generator(seed: int, step_idx: int, device, mesh: Mesh
                     ) -> torch.Generator:
    """The local encode's dropout generator: the flattened (dp, mp) index
    folded."""
    return step_generator(seed, step_idx, device,
                          _ENCODE_FOLD + mesh.catalog_axis.index)


def sharded_catalog_encode(model, mesh: Mesh) -> Callable:
    """encode(local contents, n, rng) -> (N, D) reprs of the whole
    catalog, each rank having encoded its own rows (`place_catalog`)."""

    def encode(local: Dict[str, torch.Tensor], n: int,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return gather_catalog(model.encode_item_content(local, rng), mesh, n)

    return encode


def catalog_loss(model, batch: Dict[str, torch.Tensor],
                 all_reprs: torch.Tensor, use_neg_sampling: bool = True,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """The catalog branch of the loss over the whole catalog's reprs (JAX
    make_catalog_parallel_step's loss_fn): the candidates' and the clicks'
    rows gathered, the user side and the predictor on them."""
    n = all_reprs.shape[0]
    cand = batch["candidates"].clamp(0, n - 1)
    hist = batch["history"].clamp(0, n - 1)
    user_repr = model.encode_user(all_reprs[hist], batch["mask"], rng)
    scores = model.predictor(user_repr, all_reprs[cand], rng)
    if use_neg_sampling:
        return neg_sampling_loss(scores)
    return ranking_loss(scores, batch["label"])


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
    partial = partial_params(model)
    fold = mesh.dp_index

    def loss_fn(batch, rng, enc_rng):
        all_reprs = encode(local_contents, num_items, enc_rng)
        return catalog_loss(model, batch, all_reprs, use_neg_sampling, rng)

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
        loss = reduce_gradients(params, loss.detach(), mesh, partial,
                                over=mesh.catalog_axis)
        optimizer.step()
        return loss

    return step
