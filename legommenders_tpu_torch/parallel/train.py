"""Data-parallel training over the process group.

The port of the JAX package's parallel/train.py for the dp axis
(`make_sharded_train_step_folded`). JAX shards the batch rows over `dp`
and XLA all-reduces the gradients; here every rank runs
`runtime/steps.make_train_step_folded`'s forward and backward on its rows
of the global batch, then one flat all-reduce a gradient dtype averages
the gradients (and the loss) over the group before the replicated
optimizer step, so that every rank applies the same update to the same
weights. `MultiSteps` keeps its meaning: it accumulates the averaged
gradients.

One all-reduce after the backward, not DistributedDataParallel: the loss
runs parts of the model outside its `forward` (the whole-catalog encode,
the catalog gradient plans), and frozen parameters (an LM's lower slice,
frozen tables) have no gradient to bucket.
"""
from typing import Callable, Dict, Optional

import torch

from legommenders_tpu_torch.parallel.mesh import (
    Mesh, average_gradients, shard_rows, split_batch,
)
from legommenders_tpu_torch.runtime.steps import make_loss_fn, step_generator


def make_dp_train_step_folded(model, item_contents: Dict[str, torch.Tensor],
                              optimizer, mesh: Mesh,
                              use_neg_sampling: bool = True, seed: int = 0,
                              assemble: Optional[Callable] = None
                              ) -> Callable:
    """step(inputs, step_idx) -> the group's mean loss.

    `inputs` is this rank's rows of the global batch on the device (host
    batches), or, with `assemble` (the device pipeline's), the global
    batch's (B,) row indices: every rank assembles the whole batch from
    the step's generator, as one process does, and keeps its rows. Dropout
    draws from the step generator with the rank folded in (rank 0's is one
    process's, continued after the batch's draws where it assembled)."""
    loss_fn = make_loss_fn(model, item_contents, use_neg_sampling)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(inputs, step_idx: int):
        if assemble is None:
            device = next(iter(inputs.values())).device
            batch = inputs
            rng = step_generator(seed, step_idx, device, mesh.rank)
        else:
            device = next(model.parameters()).device
            rng = step_generator(seed, step_idx, device)
            batch = shard_rows(assemble(inputs, rng), mesh)
            if mesh.rank:
                rng = step_generator(seed, step_idx, device, mesh.rank)
        optimizer.zero_grad(set_to_none=True)
        with split_batch(mesh):
            loss = loss_fn(batch, rng)
        loss.backward()
        loss = average_gradients(params, loss.detach(), mesh)
        optimizer.step()
        return loss

    return step
