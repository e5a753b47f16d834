"""Manager — glue between configs, data, model and the runtime.

The port of the JAX package's runtime/manager.py without the mesh and
pipeline parts (reference loader/manager.py:121-431). It builds the
dataset, the model from the model config (the item operator built on
`device`, where a decoder's billions of parameters are drawn fast, and
every parameter then drawn on `device` from a torch.Generator of that
device seeded with `seed`), the repr cache, the host batchers and
evaluators, for a layer-split LM item operator the lower slice's cache
(`prepare_lm_cache`), and an LM's weights from a local HF checkpoint
(`load_lm_weights`). The policy is the exp config's `policy` over
DEFAULT_POLICY; the dev metric and the patience come from
its `store`. `exp.policy.mesh` (JAX manager.py:47-113) gives the
[dp, mp, sp, pp] mesh over the process group (`parallel/mesh.py`;
launched by `torchrun`, the group is opened here from its environment):
every rank builds the same whole model from the same seed on its own
card (the Trainer then places it by `shard_plan` at mp > 1), and the
repr cache and the evaluator split their rows over the ranks. Under
`catalog_parallel` (`catalog_parallel` true) the layer-split LM cache is
built by rows: rank r encodes and holds only its N / n padded rows
(`catalog_contents`), never the whole cache, and writes nothing to
disk. At pp > 1 the item
operator's `pipeline_stages` is set to pp (`_apply_pp_policy`, JAX's
checks and messages).
"""
import inspect
import os
from typing import Optional

import torch

from legommenders_tpu_torch.config.dotfiles import ModelInit
from legommenders_tpu_torch.data.dataset import LegoData
from legommenders_tpu_torch.data.pipeline import EvalBatcher, TrainBatcher
from legommenders_tpu_torch.models.common import drop_cached_casts
from legommenders_tpu_torch.models.lm import hf_loader
from legommenders_tpu_torch.models.lego_config import DTYPE_NAMES, LegoConfig
from legommenders_tpu_torch.models.operators.lm_ops import LMOperator
from legommenders_tpu_torch.parallel.catalog import place_catalog
from legommenders_tpu_torch.parallel.mesh import (
    initialize_multihost, mesh_from_policy, process_device, world,
)
from legommenders_tpu_torch.runtime.cacher import ReprCache
from legommenders_tpu_torch.runtime.lm_cache import (
    load_or_build_iisan_cache, load_or_build_lm_cache,
)
from legommenders_tpu_torch.runtime.evaluator import Evaluator
from legommenders_tpu_torch.utils.device import resolve_device
from legommenders_tpu_torch.utils.logging import get_logger

DEFAULT_POLICY = dict(
    epoch=50, lr=1e-3, item_lr=None, batch_size=64, n_warmup=0,
    check_interval=-2, simple_dev=False, epoch_batch=0, accumulate_batch=1,
)
DEFAULT_METRICS = ["GAUC", "MRR", "NDCG@1", "NDCG@5", "NDCG@10"]


class Manager:
    def __init__(self, data_cfg: Optional[dict] = None,
                 model_cfg: Optional[dict] = None,
                 embed_cfg: Optional[dict] = None,
                 exp_cfg: Optional[dict] = None,
                 data: Optional[LegoData] = None,
                 dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        self.exp_cfg = dict(exp_cfg or {})
        self.policy = {**DEFAULT_POLICY, **(self.exp_cfg.get("policy") or {})}
        self.mesh = None
        mesh_cfg = self.policy.get("mesh")
        if mesh_cfg:
            if "WORLD_SIZE" in os.environ and world()[1] == 1:
                initialize_multihost(device=resolve_device(device))
            self.mesh = mesh_from_policy(mesh_cfg)
        self.catalog_parallel = bool(self.mesh is not None
                                     and self.mesh.catalog_parallel)
        self._catalog_contents = None
        self.device = process_device(resolve_device(device))
        store = self.exp_cfg.get("store") or {}
        self.dev_metric = store.get("metric", "GAUC")
        self.patience = int(store.get("patience", 5))
        self.metrics = list(self.exp_cfg.get("metrics") or DEFAULT_METRICS)
        dtype = DTYPE_NAMES.get(str(self.policy.get("dtype") or "").lower(),
                                dtype)

        model_cfg = dict(model_cfg or {})
        if self.mesh is not None and self.mesh.pp > 1:
            model_cfg = self._apply_pp_policy(model_cfg, self.mesh.pp)

        self.data = data if data is not None else LegoData.from_config(data_cfg)
        self.lego_cfg = LegoConfig.from_configs(
            self.data, model_cfg, embed_cfg, dtype=dtype)
        self.model, self.contents = self.lego_cfg.build(self.device)
        self.model.to(self.device).eval()
        self.model.reset_parameters(
            torch.Generator(device=self.device).manual_seed(seed))

        self.cache = None
        if self.lego_cfg.use_fast_eval and self._caching_allowed():
            self.cache = ReprCache(
                self.model, self.contents.columns, self.data.history_matrix(),
                page_size=self.lego_cfg.cache_page_size, device=self.device,
                mesh=self.mesh)
            if self.catalog_parallel:
                self.cache.set_local_contents(self.catalog_contents())

    def _apply_pp_policy(self, model_cfg: dict, n_pp: int) -> dict:
        """Route `exp.policy.mesh.pp` to the LM slice (JAX
        manager.py:82-113): the item operator's `pipeline_stages` defaults
        to pp (an explicit item_config.pipeline_stages must equal it). An
        operator without the knob, or catalog_parallel, stops the run."""
        from legommenders_tpu_torch.utils.registry import OPERATORS

        if self.catalog_parallel:
            raise SystemExit(
                "exp.policy.mesh: pp > 1 cannot combine with "
                "catalog_parallel (the catalog shard_map cannot nest the "
                "pipeline shard_map) — pick one")
        meta = dict(model_cfg.get("meta") or {})
        item_name = meta.get("item")
        item_cls = OPERATORS[item_name] if item_name in OPERATORS else None
        if (item_cls is None or "pipeline_stages" not in
                inspect.signature(item_cls.__init__).parameters):
            raise SystemExit(
                f"exp.policy.mesh.pp={n_pp} requires an LM item operator "
                f"with a pipeline_stages knob; meta.item={item_name!r} "
                f"has none")
        cfg = dict(model_cfg.get("config") or {})
        icfg = dict(cfg.get("item_config") or {})
        stages = int(icfg.get("pipeline_stages") or 0)
        if stages and stages != n_pp:
            raise SystemExit(
                f"item_config.pipeline_stages={stages} != mesh pp={n_pp}")
        icfg["pipeline_stages"] = n_pp
        cfg["item_config"] = icfg
        return {**model_cfg, "config": cfg}

    def prepare_lm_cache(self, root: Optional[str] = "cache") -> bool:
        """Layer-split LM caching (JAX runtime/manager.py:116-144): if the
        item operator is an LMOperator with `tune_from`, build (or, with a
        cache `root`, load) the lower slice's hidden states and add them to
        `self.contents.columns` (and the repr cache's contents) on the
        manager's device, in the operator's lm_dtype; for an IISAN operator
        its LM's pooled states of the selected layers (f32). `root=None`
        builds on the device and writes nothing. Returns whether it did."""
        op = self.model.item_op
        if not isinstance(op, LMOperator) or not op.use_lm_cache:
            return False
        contents = dict(self.contents.columns)
        if self.catalog_parallel:
            # this rank's rows only, built here, nothing on disk
            contents = dict(self.catalog_contents())
            root = None
        if getattr(op, "is_iisan", False):
            # every layer's pooled states once; the selected ones kept
            extra = load_or_build_iisan_cache(
                self.model, contents,
                data_name=self.data.name, operator_name=op.transformer_key,
                selected_layers=op.get_selected_layers(),
                page_size=self.lego_cfg.cache_page_size, root=root)
            frozen = op.lm
        else:
            extra = load_or_build_lm_cache(
                self.model, contents,
                data_name=self.data.name, operator_name=op.transformer_key,
                layer=op.resolved_tune_from,
                page_size=self.lego_cfg.cache_page_size, root=root,
                device_dtype=op.lm_dtype)
            frozen = op.lm_lower
        if self.catalog_parallel:
            self._catalog_contents = {**contents, **extra}
            if self.cache is not None:
                self.cache.set_local_contents(self._catalog_contents)
        else:
            self.contents.columns.update(extra)
            if self.cache is not None:
                self.cache.item_contents.update(extra)
        # nothing runs the frozen slice after this: its kept casts go
        drop_cached_casts(frozen)
        return True

    @property
    def catalog_held_by_rows(self) -> bool:
        """Whether no rank holds the whole catalog's contents: under
        catalog_parallel a layer-split LM's cache is built of each rank's
        own rows only (`catalog_contents`)."""
        return self.catalog_parallel and bool(
            getattr(self.model.item_op, "use_lm_cache", False))

    @property
    def num_items(self) -> int:
        """The catalog's rows."""
        return len(next(iter(self.contents.columns.values())))

    def catalog_contents(self) -> dict:
        """Catalog-parallel: this rank's padded rows of every content
        column (with the layer-split LM cache's, where it was prepared)."""
        if self._catalog_contents is None:
            self._catalog_contents, _ = place_catalog(
                dict(self.contents.columns), self.mesh)
        return self._catalog_contents

    def _caching_allowed(self) -> bool:
        """JAX manager.py:146-151: every operator allows caching, the
        items have content (an id-only model's item reprs are its table)
        and the user operator is not flatten-mode."""
        model = self.model
        user_cls = type(model.user_op)
        return bool(model.use_item_content
                    and type(model.item_op).allow_caching
                    and user_cls.allow_caching and not user_cls.flatten_mode)

    # ------------------------------------------------------------------ #
    def train_batcher(self, seed: int = 2023) -> TrainBatcher:
        return TrainBatcher(
            self.data, batch_size=int(self.policy["batch_size"]),
            neg_count=self.lego_cfg.neg_count,
            use_neg_sampling=self.lego_cfg.use_neg_sampling, seed=seed)

    @property
    def eval_batch_size(self) -> int:
        """Eval batches are gathers + the predictor on the cached path, so
        4x the train batch unless the policy sets `eval_batch_size`."""
        return int(self.policy.get("eval_batch_size")
                   or 4 * int(self.policy["batch_size"]))

    def eval_batcher(self, phase: str) -> EvalBatcher:
        return EvalBatcher(self.data, phase, self.eval_batch_size)

    def evaluator(self) -> Evaluator:
        return Evaluator(self.model, self.data, self.metrics,
                         cache=self.cache, device=self.device,
                         item_contents=self.contents.columns,
                         batch_size=self.eval_batch_size, mesh=self.mesh,
                         local_contents=(self.catalog_contents
                                         if self.catalog_held_by_rows
                                         else None))

    def load_lm_weights(self, log=None) -> bool:
        """Pretrained LM weights for the item operator, from the local
        checkpoint the `.model` dotfile names under the operator's
        transformer_key (JAX manager.py:175-238): the family's map
        (models/lm/hf_loader.py) into the trainable slice `lm` and, in
        layer-split mode, the lower slice `lm_lower`; the LoRA factors and
        the head keep their init. Without an entry the LM runs from its
        random init, with a warning, as in JAX. Returns whether weights
        were loaded."""
        log = log or get_logger("manager")
        op = self.model.item_op
        if not isinstance(op, LMOperator):
            return False
        path = ModelInit.get(op.transformer_key)
        if not path or not os.path.isdir(path):
            log.warning(
                f"no local HF checkpoint for '{op.transformer_key}' "
                f"(.model dotfile) — LM runs from RANDOM init")
            return False
        sd = hf_loader.load_torch_state_dict(path)
        # (start, layers, trainable slice) -> that slice's parameters
        maps = {
            "bert": lambda s, k, top: hf_loader.bert_slice_params(
                sd, s, k, embed=s == 0),
            "llama": lambda s, k, top: hf_loader.llama_slice_params(
                sd, s, k, final_norm=top),
            "opt": lambda s, k, top: hf_loader.opt_slice_params(
                sd, s, k, embed_positions=s == 0, final_norm=top),
            "glm": lambda s, k, top: hf_loader.glm_slice_params(
                sd, s, k, op.num_attention_heads,
                op.num_kv_heads or op.num_attention_heads, final_norm=top)}
        if op.hf_family not in maps:
            log.warning(f"no HF mapping for family {type(op).__name__}")
            return False
        start, n = op.resolved_tune_from, op.num_hidden_layers
        slice_params = maps[op.hf_family]
        # an IISAN operator's `lm` is its frozen whole LM, without the
        # trainable slice's final norm
        top = not getattr(op, "is_iisan", False)
        hf_loader.merge_lm_params(self.model, slice_params(
            start, n - start, top), "item_op.lm")
        if start > 0:
            hf_loader.merge_lm_params(self.model, slice_params(
                0, start, False), "item_op.lm_lower")
        log.info(f"loaded HF weights for {op.transformer_key} from {path}")
        return True
