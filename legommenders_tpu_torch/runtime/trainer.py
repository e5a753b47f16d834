"""Trainer — the full train -> dev -> test loop.

The port of the JAX package's runtime/trainer.py (reference
trainer.py:74-322): the epoch loop with gradient accumulation, loss
logging every `check_interval` steps, `epoch_batch` truncation, dev
evaluation each epoch (the metric through the Evaluator, or the loss only
with `simple_dev`), early stopping by Monitor, the best checkpoint saved
(or, without a checkpoint path, the best weights cloned in memory) and
reloaded before the test. The optimizer is Adam with two LR groups when
`item_lr` is set (the item operator's pretrained parameters at `item_lr`,
reference base_lego.py:175-209) and linear warmup (:211-223).

optax semantics the port keeps:
  * `optax.linear_schedule(0, lr, n)` is read at the update count, which
    starts at 0: the first update moves nothing but still feeds Adam's
    moments. A LambdaLR of `linear_warmup(n)`, stepped after each real
    update, reads the same values;
  * `optax.MultiSteps(opt, k)`: the Welford mean of k gradients is applied
    on the k-th mini-step and nothing in between; only real updates
    advance the schedule and Adam's count; the accumulation carries over
    an `epoch_batch` cut. The step index that seeds dropout counts every
    mini-step.

Training takes host batches by default (TrainBatcher, the native negative
sampler, a Prefetcher that moves each batch to the device in its thread,
`steps.make_train_step_folded`), or, with the policy's `device_batching`,
the device pipeline (`DeviceTrainPipeline.make_fused_train_step`).

`session` (JAX trainer.py:45-75, 410-425) ties the run to a lego-server
experiment: looked up at init (its signature and seed must be the run's,
and it must not be completed, or the run stops), registered with this
pid, and completed by `test()` with the log and the metrics as JSON; an
unreachable server leaves the run offline.

Under the Manager's mesh (JAX trainer.py:132-175, 225-310) every rank
builds the same global batch from the same seed and trains on its dp rows
(`parallel/train.make_mesh_train_step_folded`: partial gradients summed
over mp, then every gradient averaged over dp before the optimizer step);
the batch size must divide by dp. At mp > 1 `init` places the model by
`parallel/mesh.shard_plan` (after the layer-split LM cache is built with
the whole weights, as JAX builds it before `_place_on_mesh`): tables
row-sharded, CrossNetMix expert-sharded, the LM slices Megatron-TP'd,
Adam's moments following the slices. `catalog_parallel` routes the step
through `parallel/catalog.make_catalog_parallel_step` (parameters whole,
the catalog's rows sharded over the (dp, mp) ranks); where a layer-split
LM's cache is held by rows, the full-forward evaluation and `simple_dev`
read the reprs each rank encodes of its rows, gathered. At sp > 1 `init`
activates the ambient sp mesh (JAX trainer.py:159-163):
`sequence_parallel` user operators shard their sequence over sp in
training and in the evaluation that runs under it, and the step sums
their partial gradients over sp. At pp > 1 it activates the ambient pp
mesh: the LM slice's layers train in GPipe stages and the step sums
their gradients over pp; dev, test and the caches run the serial stack
(`no_pipeline`). The axes compose (mp with sp, mp with pp, sp with pp,
sp with catalog_parallel). Checkpoints go through `save_auto`: a sharded
model writes the sharded directory (every mp rank of the first (dp, sp,
pp) cell its shard), a whole one a file that rank 0 writes; the others
wait at a barrier. Rank 0 alone talks to the lego-server; the dev metric
is the same on every rank, so early stopping decides alike.
"""
import json
import time
from typing import Callable, Dict, List, Optional

import torch

from legommenders_tpu_torch.data.device_pipeline import DeviceTrainPipeline
from legommenders_tpu_torch.data.pipeline import (
    Prefetcher, TrainBatcher, device_batches, on_current_stream,
)
from legommenders_tpu_torch.runtime import steps
from legommenders_tpu_torch.runtime.checkpoint import load_auto, save_auto
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.parallel.catalog import (
    catalog_loss, encode_generator, make_catalog_parallel_step,
    sharded_catalog_encode,
)
from legommenders_tpu_torch.parallel.mesh import (
    barrier, no_pipeline, place_model, set_pp_mesh, set_sp_mesh, shard_rows,
)
from legommenders_tpu_torch.parallel.train import make_mesh_train_step_folded
from legommenders_tpu_torch.runtime.metrics import MetricPool
from legommenders_tpu_torch.utils.logging import get_logger
from legommenders_tpu_torch.utils.meaner import Meaner
from legommenders_tpu_torch.utils.monitor import Monitor, Signal
from legommenders_tpu_torch.utils.timer import Timer


def linear_warmup(n_warmup: int) -> Callable[[int], float]:
    """The LR factor at update count c: optax.linear_schedule(0, lr,
    n_warmup) over lr, i.e. min(c / n_warmup, 1); 1 without warmup."""
    if n_warmup <= 0:
        return lambda c: 1.0
    return lambda c: min(c / n_warmup, 1.0)


class MultiSteps:
    """optax.MultiSteps over a torch optimizer and its LR scheduler.

    `step()` adds the parameters' gradients to their running (Welford)
    mean; on every `every_k`-th call the mean becomes the gradient, the
    optimizer steps and then the scheduler; in between nothing moves.
    With every_k 1 it is the optimizer and the scheduler stepped together.
    `zero_grad` and `param_groups` are the optimizer's, so
    `steps.make_train_step` takes it as an optimizer. Returns from `step()`
    whether the parameters moved."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scheduler=None, every_k: int = 1):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc: Dict[torch.Tensor, torch.Tensor] = {}

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        if self.every_k > 1:
            n = self.mini_step
            for p in self._params():
                acc = self.acc.get(p)
                if p.grad is None and acc is None:
                    continue
                if acc is None:
                    acc = self.acc[p] = torch.zeros_like(p.grad)
                grad = p.grad if p.grad is not None else torch.zeros_like(acc)
                acc.add_((grad - acc) / (n + 1))
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            for p in self._params():
                p.grad = self.acc.pop(p, None)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return True

    def state_dict(self) -> dict:
        params = self._params()
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": (self.scheduler.state_dict()
                              if self.scheduler is not None else None),
                "mini_step": self.mini_step,
                "acc": [self.acc.get(p) for p in params]}

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and state["scheduler"] is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = int(state["mini_step"])
        self.acc = {p: a.to(p.device) for p, a in
                    zip(self._params(), state["acc"]) if a is not None}


def param_groups(model, lr: float, item_lr: Optional[float]) -> List[dict]:
    """The trainable parameters in Adam's groups: with `item_lr`, the item
    operator's pretrained parameters (their module path holds `item_op` and
    one of the operator's get_pretrained_parameter_names(), as JAX's
    label_fn decides) at item_lr and the rest at lr; empty groups left
    out."""
    item, other = [], []
    signals = []
    if item_lr:
        getter = getattr(model.item_op, "get_pretrained_parameter_names",
                         None)
        signals = list(getter()) if getter else []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        parts = name.split(".")
        in_item = "item_op" in parts and any(s in parts for s in signals)
        (item if in_item else other).append(p)
    groups = [{"params": other, "lr": float(lr), "name": "other"}]
    if item:
        groups.append({"params": item, "lr": float(item_lr), "name": "item"})
    return [g for g in groups if g["params"]]


def build_optimizer(model, policy: dict) -> MultiSteps:
    """optax.adam (betas 0.9 / 0.999, eps 1e-8) over the policy's groups,
    linear warmup over `n_warmup` updates, MultiSteps over
    `accumulate_batch` mini-steps."""
    opt = torch.optim.Adam(
        param_groups(model, float(policy["lr"]), policy.get("item_lr")),
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, linear_warmup(int(policy.get("n_warmup") or 0)))
    return MultiSteps(opt, sched, int(policy.get("accumulate_batch") or 1))


class Trainer:
    def __init__(self, manager: Manager, seed: int = 2023,
                 ckpt_path: Optional[str] = None, log=None,
                 session: Optional[str] = None,
                 lm_cache_root: Optional[str] = "cache",
                 timer: Optional[Timer] = None,
                 signature: Optional[str] = None):
        """Runs on its Manager's device. `lm_cache_root` is where a
        layer-split LM's lower-slice cache is kept (None: built on the
        device, nothing written). With a `timer`, every step is timed up
        to the device's end of it ("step"): the device is synchronized
        after each step. `prefetch_wait_s` sums the time the loop waited
        for host batches; `epochs` holds each epoch's mean loss, dev value
        and seconds, `losses` every step's loss (read where the loop reads
        them, once per logging interval). `session` is a lego-server
        experiment, whose signature must equal `signature` where one is
        given."""
        self.m = manager
        self.seed = seed
        self.ckpt_path = ckpt_path
        self.log = log or get_logger("trainer")
        self.mesh = manager.mesh
        self.is_main = self.mesh is None or self.mesh.is_main
        self.server = None
        self.session = session
        if session and self.is_main:
            self._connect(session, signature)
        self.lm_cache_root = lm_cache_root
        self.timer = timer
        policy = self.m.policy
        self.optimizer = build_optimizer(self.m.model, policy)
        self.evaluator = self.m.evaluator()
        # simple_dev monitors the raw dev loss (minimize), otherwise the
        # dev metric's own direction (reference trainer.py:164)
        self.monitor = Monitor(
            patience=self.m.patience,
            minimize=bool(policy.get("simple_dev"))
            or MetricPool.is_minimize(self.m.dev_metric))
        self.initialized = False
        self.global_step = 0
        self.prefetch_wait_s = 0.0
        self.epochs: List[dict] = []
        self.losses: List[float] = []

    def _connect(self, session: str, signature: Optional[str]):
        """Look the experiment up, check it and register this pid
        (reference trainer.py:88-121)."""
        from legommenders_tpu_torch.utils.server import (
            ExperimentBody, Server,
        )
        server = Server.auto_auth()
        if not server.active:
            return
        resp = server.get_experiment_info(session)
        if not resp.ok:
            self.log.warning(
                f"lego-server lookup for session {session} failed "
                f"({resp.msg}); continuing offline")
            return
        exp = ExperimentBody(resp.body)
        if signature and exp.signature != signature:
            raise SystemExit(f"signature mismatch: local {signature} != "
                             f"server {exp.signature}")
        if exp.seed is not None and int(exp.seed) != self.seed:
            raise SystemExit(f"seed mismatch: local {self.seed} != "
                             f"server {exp.seed}")
        if exp.is_completed:
            raise SystemExit(f"experiment {session} is already completed")
        server.register_experiment(session)
        self.server = server

    # ------------------------------------------------------------------ #
    def init(self):
        """Pretrained LM weights (where the `.model` dotfile names them)
        and the layer-split LM cache. The model's weights were drawn when
        the Manager built it."""
        if self.initialized:
            return
        self.m.load_lm_weights(log=self.log)
        # under dp, rank 0 builds (and writes) a cache on disk first and
        # the others then read it
        first = self.is_main or self.lm_cache_root is None
        prepared = first and self.m.prepare_lm_cache(root=self.lm_cache_root)
        barrier(self.mesh)
        if not first:
            prepared = self.m.prepare_lm_cache(root=self.lm_cache_root)
        if prepared:
            self.log.info("LM layer-split cache prepared")
        mesh = self.mesh
        if mesh is not None and mesh.mp > 1 and not mesh.catalog_parallel:
            place_model(self.m.model, mesh)
        if mesh is not None and mesh.sp > 1:
            set_sp_mesh(mesh)
        if mesh is not None and mesh.pp > 1:
            set_pp_mesh(mesh)
        if mesh is not None:
            self.log.info(f"mesh policy active: {mesh.shape}"
                          + (" (catalog-parallel)"
                             if mesh.catalog_parallel else ""))
        n_params = sum(p.numel() for p in self.m.model.parameters())
        self.log.info(f"initialized {n_params / 1e6:.2f}M params")
        self.initialized = True

    # ------------------------------------------------------------------ #
    def dev(self) -> float:
        if self.m.policy.get("simple_dev"):
            return self._simple_dev_loss()
        return self.evaluator.evaluate("dev")[self.m.dev_metric]

    @torch.no_grad()
    @no_pipeline()
    def _simple_dev_loss(self) -> float:
        """Loss-only dev (reference trainer.py:126-153, simple_dev): the
        training loss over the dev split's batches, with dropout drawn from
        one fixed generator for every batch, as JAX passes one fixed key.
        Where the catalog is held by rows (catalog_parallel with a
        layer-split LM's cache) it is the catalog-parallel step's loss
        without the backward: each rank encodes its rows once, from one
        fixed generator, the reprs are gathered, and every rank takes the
        loss of each whole dev batch over them."""
        reprs = None
        if self.m.catalog_held_by_rows:
            reprs = sharded_catalog_encode(self.m.model, self.mesh)(
                self.m.catalog_contents(), self.m.num_items,
                encode_generator(0, 0, self.m.device, self.mesh))
        if not hasattr(self, "_dev_batcher"):
            self._dev_loss_fn = steps.make_loss_fn(
                self.m.model, self.m.contents.columns,
                self.m.lego_cfg.use_neg_sampling)
            self._dev_batcher = TrainBatcher(
                self.m.data, int(self.m.policy["batch_size"]),
                neg_count=self.m.lego_cfg.neg_count,
                use_neg_sampling=self.m.lego_cfg.use_neg_sampling,
                seed=self.seed, phase="dev")
        meaner = Meaner()
        for batch in Prefetcher(device_batches(
                self._dev_batcher.epoch(shuffle=False), self.m.device),
                depth=4):
            on_current_stream(batch)
            rng = steps.step_generator(0, 0, self.m.device)
            if reprs is None:
                meaner.add(float(self._dev_loss_fn(batch, rng)))
            else:
                meaner.add(float(catalog_loss(
                    self.m.model, batch, reprs,
                    self.m.lego_cfg.use_neg_sampling, rng)))
        return meaner.mean

    # ------------------------------------------------------------------ #
    def _sync(self):
        if self.m.device.type == "cuda":
            torch.cuda.synchronize(self.m.device)

    def train(self) -> Dict[str, float]:
        policy = self.m.policy
        self.init()
        model, device = self.m.model, self.m.device
        cfg = self.m.lego_cfg
        mesh = self.mesh
        device_batching = bool(policy.get("device_batching"))
        if mesh is not None and int(policy["batch_size"]) % mesh.dp:
            raise SystemExit(
                f"policy.batch_size {policy['batch_size']} must divide by "
                f"mesh dp={mesh.dp}")
        if device_batching:
            dpipe = DeviceTrainPipeline(
                self.m.data, int(policy["batch_size"]),
                neg_count=cfg.neg_count,
                use_neg_sampling=cfg.use_neg_sampling, seed=self.seed,
                device=device)
        assemble = dpipe.assemble if device_batching else None
        if mesh is not None and mesh.catalog_parallel:
            step_fn = make_catalog_parallel_step(
                model, self.optimizer, mesh, self.m.catalog_contents(),
                self.m.num_items, cfg.use_neg_sampling, seed=self.seed,
                assemble=assemble)
        elif mesh is not None:
            step_fn = make_mesh_train_step_folded(
                model, self.m.contents.columns, self.optimizer, mesh,
                cfg.use_neg_sampling, seed=self.seed, assemble=assemble)
        elif device_batching:
            step_fn = dpipe.make_fused_train_step(
                model, self.m.contents.columns, self.optimizer,
                seed=self.seed)
        else:
            step_fn = steps.make_train_step_folded(
                model, self.m.contents.columns, self.optimizer,
                cfg.use_neg_sampling, seed=self.seed)
        epoch_batch = int(policy.get("epoch_batch") or 0)
        check_interval = int(policy.get("check_interval") or -2)
        timer = self.timer

        best_dev = None
        best_state = None  # in-memory best when there is no checkpoint path
        for epoch in range(int(policy["epoch"])):
            if self.m.cache is not None:
                self.m.cache.clean()
            meaner = Meaner()
            t0 = time.time()
            if device_batching:
                num_batches = len(dpipe)
                step_inputs = dpipe.epoch_indices()
            else:
                batcher = self.m.train_batcher(self.seed + epoch)
                num_batches = len(batcher)
                batches = batcher.epoch()
                if mesh is not None:
                    batches = (shard_rows(b, mesh) for b in batches)
                step_inputs = Prefetcher(
                    device_batches(batches, device), depth=4)
            if epoch_batch:
                num_batches = min(num_batches, epoch_batch)
            interval = (num_batches // (-check_interval)
                        if check_interval < 0 else check_interval) or 1
            pending = []  # device-side losses; read once per interval

            for i, jb in enumerate(step_inputs):
                if epoch_batch and i >= epoch_batch:
                    if isinstance(step_inputs, Prefetcher):
                        step_inputs.close()
                    break
                if not device_batching:
                    on_current_stream(jb)
                self.global_step += 1
                if timer is not None:
                    timer.start("step")
                loss = step_fn(jb, self.global_step)
                if timer is not None:
                    self._sync()
                    timer.stop("step")
                pending.append(loss)
                if (i + 1) % interval == 0:
                    self._read(pending, meaner)
                    self.log.info(
                        f"epoch {epoch} [{i + 1}/{num_batches}] "
                        f"loss {meaner.mean:.4f}")
            if isinstance(step_inputs, Prefetcher):
                self.prefetch_wait_s += step_inputs.wait_s
            self._read(pending, meaner)
            dt = time.time() - t0
            dev_value = self.dev()
            self.log.info(
                f"epoch {epoch}: loss {meaner.mean:.4f}, "
                f"dev {self.m.dev_metric} {dev_value:.4f}, {dt:.1f}s")
            self.epochs.append({"epoch": epoch, "loss": meaner.mean,
                                "dev": float(dev_value), "s": dt})

            signal = self.monitor.push(dev_value)
            if signal == Signal.BEST:
                best_dev = dev_value
                if self.ckpt_path:
                    save_auto(self.ckpt_path, model, self.optimizer,
                              meta={"epoch": epoch, "dev": float(dev_value)},
                              mesh=mesh)
                else:
                    # the optimizer updates the parameters in place: keep
                    # copies, not the state_dict's references
                    best_state = {k: v.detach().clone()
                                  for k, v in model.state_dict().items()}
            elif signal == Signal.STOP:
                self.log.info(f"early stop at epoch {epoch}")
                break

        if best_dev is not None:
            if self.ckpt_path:
                load_auto(self.ckpt_path, model, model_only=True)
            elif best_state is not None:
                model.load_state_dict(best_state)
        return {"best_dev": best_dev if best_dev is not None
                else float("nan")}

    def _read(self, pending: list, meaner: Meaner):
        """The pending device-side losses into `losses` and the mean."""
        for loss_i in pending:
            self.losses.append(float(loss_i))
            meaner.add(self.losses[-1])
        pending.clear()

    # ------------------------------------------------------------------ #
    def test(self) -> Dict[str, float]:
        res = self.evaluator.evaluate("test")
        self.log.info("test: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()))
        if self.server is not None:
            # the performance rides as a JSON string (reference
            # trainer.py:269-273)
            self.server.complete_experiment(
                self.session, self._log_text(), json.dumps(res))
        return res

    def _log_text(self) -> str:
        """The run's log file, where the logger mirrors to one."""
        for h in self.log.handlers:
            path = getattr(h, "baseFilename", None)
            if path:
                try:
                    with open(path) as f:
                        return f.read()
                except OSError:
                    pass
        return ""

    def run(self) -> Dict[str, float]:
        self.train()
        return self.test()
