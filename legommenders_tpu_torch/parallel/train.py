"""Training over the [dp, mp, sp, pp] mesh.

The port of the JAX package's parallel/train.py (`place_opt_state`,
`make_sharded_train_step(_folded)`). JAX shards the batch rows over `dp`,
places the parameters by `params_shardings` and lets XLA insert the
collectives; here every rank runs `runtime/steps`' forward and backward
on its dp rows of the global batch (the mp ranks of one dp row on the
same rows) over a model placed by `parallel/mesh.place_model` (its
sharded parameters are this rank's slices, its TP layers, sharded tables
and expert-sharded mixtures do their own collectives over mp; a
sequence-parallel operator shards its sequence over sp; a staged LM slice
runs its stage over pp). After the backward `mesh.reduce_gradients` sums
the partial gradients over their axis (the replicated parameters inside
sharded products over mp, a sequence-parallel operator's over sp, the
staged layers' over pp), then averages every gradient and the loss over
dp, before the optimizer step; every
rank applies the same update to the same weights (a sharded parameter's
to its slice). A sharded parameter is the local shard itself, so Adam's
moments follow it (JAX's `place_opt_state`): no rank holds a moment of
another rank's rows. `MultiSteps` keeps its meaning: it accumulates the
reduced gradients.

One reduction after the backward, not DistributedDataParallel: the loss
runs parts of the model outside its `forward` (the whole-catalog encode,
the catalog gradient plans), and frozen parameters (an LM's lower slice,
frozen tables) have no gradient to bucket.
"""
from typing import Callable, Dict, Optional

import torch

from legommenders_tpu_torch.parallel.mesh import (
    Mesh, partial_params, reduce_gradients, shard_rows, split_batch,
)
from legommenders_tpu_torch.runtime.steps import make_loss_fn, step_generator


def make_mesh_train_step_folded(model, item_contents: Dict[str, torch.Tensor],
                                optimizer, mesh: Mesh,
                                use_neg_sampling: bool = True, seed: int = 0,
                                assemble: Optional[Callable] = None
                                ) -> Callable:
    """step(inputs, step_idx) -> the group's mean loss.

    `inputs` is this rank's dp rows of the global batch on the device
    (host batches), or, with `assemble` (the device pipeline's), the
    global batch's (B,) row indices: every rank assembles the whole batch
    from the step's generator, as one process does, and keeps its dp
    rows. Dropout draws from the step generator with the dp index folded
    in (dp index 0's is one process's, continued after the batch's draws
    where it assembled); the mp ranks of a dp row draw alike."""
    loss_fn = make_loss_fn(model, item_contents, use_neg_sampling)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    partial = partial_params(model)
    fold = mesh.dp_index

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
            loss = loss_fn(batch, rng)
        loss.backward()
        loss = reduce_gradients(params, loss.detach(), mesh, partial)
        optimizer.step()
        return loss

    return step
