"""LegoConfig — component wiring: configs -> a ready Legommender module.

The port of the JAX package's models/lego_config.py:53-297 (reference
model/lego_config.py:57-256) for models whose user operator pools click
vectors: content-based ones (NAML: CNN / Ada / Dot; bert-naml: BertBase /
Ada / Dot; the news zoo; the CTR heads over the Pooling item operator)
and, with `use_item_content: false`, the id-only ones, whose items are
rows of an item-id table (JAX :146-150, 166-181: no item operator or
inputer, the table `data.cm.col_vocabs[history_col]` or "item_id" with
`data.num_items` rows, the user's input width the embedding width). It
holds the hyper-parameters (the training ones too: neg_count,
use_neg_sampling, item_page_size, item_page_remat, full_catalog_encode;
layer-split mode is item_config's `tune_from`), instantiates the
operator/predictor classes with merged configs (`lm_dtype` given as a
string, "bf16"/"f32"), builds the item inputer at the embedding width (its
special tokens are parameters), runs the matching/ranking compatibility
checks and registers the inputer vocabs into the embedding hub. For a
content model, unless `full_catalog_encode` is "off", it builds the
catalog gradient plans (ops/catalog_grad.py, JAX :244-262) from the
content columns on the device, the very tensors the Manager hands to the
training and evaluation entry points, and the HistoryGradPlan from the
history matrix. An item operator that declares `num_cols` / `cols` gets
the item columns' count / specs (CNNCat builds a block per column); a
predictor that declares `input_dim` gets the user representation's width
(MINER's projection, the CTR heads' layers), which must then equal the
item representation's. A flatten-mode user operator (FlattenTransformer,
FlattenFastformer, Semantic) gets its own inputer over the item columns
(JAX :183-229), and the model no history plan; one whose inputer reads
user-store columns (SCMix) gets it over `data.user_inputs`, whose columns
the batches carry (`user_batch_cols`), at the embedding width. A semantic
operator gets a level per code of the first item column
(`num_semantic_layers`), SemanticMixPredictor the count of its pair
scores (`num_pairs`: the item operator's output levels times the user's
codes).
"""
import inspect
import logging
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from legommenders_tpu_torch.data.dataset import LegoData
from legommenders_tpu_torch.models.embedding import EmbeddingHub
from legommenders_tpu_torch.models.item_table import ItemContentTable
from legommenders_tpu_torch.models.legommender import Legommender
from legommenders_tpu_torch.ops.catalog_grad import (
    HistoryGradPlan, build_catalog_plans,
)
from legommenders_tpu_torch.utils.function import combine_config
from legommenders_tpu_torch.utils.registry import OPERATORS, PREDICTORS

# populate the registries (decorator side effects)
import legommenders_tpu_torch.models.operators  # noqa: F401
import legommenders_tpu_torch.models.predictors  # noqa: F401

# keys combine_config injects; their absence from a class is expected
_INJECTED_KEYS = ("hidden_size", "input_dim", "num_cols", "cols",
                  "lm_dtype")
# dtype names of the configs (policy dtype, item_config.lm_dtype)
DTYPE_NAMES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
               "f32": torch.float32, "float32": torch.float32,
               "f16": torch.float16, "float16": torch.float16}


def init_fields(cls) -> set:
    """The keyword arguments `cls.__init__` takes: its own, and those of
    its bases' `__init__` where it passes on `**kwargs`."""
    known = set()
    for c in cls.__mro__:
        if "__init__" not in vars(c):
            continue
        params = inspect.signature(c.__init__).parameters.values()
        known |= {p.name for p in params if p.kind not in (
            p.VAR_KEYWORD, p.VAR_POSITIONAL)} - {"self"}
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            break
    return known


def _filter_fields(cfg: dict, cls, what: str) -> dict:
    """Keep the keys `cls.__init__` takes; WARN about the rest — a silently
    dropped YAML key is a config no-op the user can't see otherwise."""
    known = init_fields(cls)
    dropped = [k for k in cfg if k not in known and k not in _INJECTED_KEYS]
    if dropped:
        logging.getLogger("legommenders_tpu_torch").warning(
            "%s (%s): ignoring unknown config keys %s — declared fields "
            "are %s", what, cls.__name__, dropped, sorted(known))
    return {k: v for k, v in cfg.items() if k in known}


@dataclass
class LegoConfig:
    data: LegoData
    item_operator: Optional[str] = None       # meta.item, e.g. "CNN"
    user_operator: str = "Ada"                # meta.user
    predictor: str = "Dot"                    # meta.predictor
    hidden_size: int = 64
    item_hidden_size: Optional[int] = None
    embedding_dim: Optional[int] = None
    neg_count: int = 4
    use_neg_sampling: bool = True
    use_item_content: bool = True
    use_fast_eval: bool = True
    item_page_size: int = 0
    item_page_remat: str = "full"   # "full" | "none" | "ffn" | "dots"
    full_catalog_encode: str = "auto"
    cache_page_size: int = 512
    item_config: dict = field(default_factory=dict)
    user_config: dict = field(default_factory=dict)
    predictor_config: dict = field(default_factory=dict)
    embed_config: dict = field(default_factory=dict)   # resolved embed yaml
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_configs(cls, data: LegoData, model_cfg: dict,
                     embed_cfg: Optional[dict] = None,
                     dtype: torch.dtype = torch.float32) -> "LegoConfig":
        meta = model_cfg.get("meta") or {}
        cfg = model_cfg.get("config") or {}
        return cls(
            data=data,
            item_operator=meta.get("item"),
            user_operator=meta.get("user", "Ada"),
            predictor=meta.get("predictor", "Dot"),
            hidden_size=int(cfg.get("hidden_size", 64)),
            item_hidden_size=cfg.get("item_hidden_size"),
            embedding_dim=cfg.get("embedding_dim"),
            neg_count=int(cfg.get("neg_count", 4)),
            use_neg_sampling=bool(cfg.get("use_neg_sampling", True)),
            use_item_content=bool(cfg.get("use_item_content", True)),
            use_fast_eval=bool(cfg.get("use_fast_eval", True)),
            item_page_size=int(cfg.get("item_page_size") or 0),
            item_page_remat=str(cfg.get("item_page_remat", "full")),
            full_catalog_encode=str(cfg.get("full_catalog_encode", "auto")),
            cache_page_size=int(cfg.get("cache_page_size", 512)),
            item_config=dict(cfg.get("item_config") or {}),
            user_config=dict(cfg.get("user_config") or {}),
            predictor_config=dict(cfg.get("predictor_config") or {}),
            embed_config=dict(embed_cfg or {}),
            dtype=dtype,
        )

    # ------------------------------------------------------------------ #
    def build(self, device="cpu") -> Tuple[Legommender, ItemContentTable]:
        """The model (on the CPU but for the item operator, which is on
        `device`; parameters from the default init) and the item content
        table on `device`."""
        data = self.data
        if self.use_item_content and not self.item_operator:
            raise ValueError("use_item_content requires meta.item")
        item_hidden = int(self.item_hidden_size or self.hidden_size)
        emb_dim = int(self.embedding_dim or self.hidden_size)

        hub = EmbeddingHub(
            embedding_dim=emb_dim,
            transformation=self.embed_config.get("transformation", "auto"),
            transformation_dropout=float(
                self.embed_config.get("transformation_dropout", 0.0) or 0.0),
        )
        for entry in self.embed_config.get("embeddings") or []:
            path = entry["path"]
            arr = np.load(path) if isinstance(path, str) else np.asarray(path)
            hub.load_pretrained(
                arr,
                vocab_name=entry.get("vocab_name"),
                col_name=entry.get("col_name"),
                frozen=bool(entry.get("frozen", True)),
            )

        contents = ItemContentTable.from_data(data, device=device)
        item_cols = tuple(
            (col, contents.col_vocabs[col], contents.seq_lens()[col])
            for col, _ in data.item_inputs
        )
        for col, vocab, _ in item_cols:
            v = data.items.vocab_of(col)
            fitted_size = len(v) if v else int(data.items[col].max()) + 1
            if not hub.has(vocab):
                hub.register_vocab(vocab, fitted_size)
            elif hub.size_of(vocab) < fitted_size:
                # reference raises on vocab-size conflicts
                # (embedding_hub.py:346-360)
                raise ValueError(
                    f"pretrained embedding for vocab '{vocab}' has "
                    f"{hub.size_of(vocab)} rows but the fitted vocab has "
                    f"{fitted_size} tokens; re-export the embedding")
        item_id_vocab = data.cm.col_vocabs.get(data.cm.history_col, "item_id")
        if not self.use_item_content and not hub.has(item_id_vocab):
            hub.register_vocab(item_id_vocab, data.num_items)

        user_op_cls = OPERATORS[self.user_operator]
        pred_cls = PREDICTORS[self.predictor]
        flatten = bool(user_op_cls.flatten_mode)
        user_from_user_cols = flatten and bool(getattr(
            user_op_cls.inputer_class, "consumes_user_cols", False))
        user_cols = ()
        if user_from_user_cols:
            # the user operator reads user-store columns of the batch
            # (SemanticMix), registered as the item columns are (JAX
            # :209-224)
            if not getattr(data, "user_inputs", None):
                raise ValueError(f"{self.user_operator} needs user-side "
                                 f"input columns (data config user.inputs)")
            cols = []
            for col, _ in data.user_inputs:
                v = data.users.vocab_of(col)
                vocab = v.name if v else col
                arr = data.users[col]
                cols.append((col, vocab, arr.shape[1] if arr.ndim > 1 else 1))
                if not hub.has(vocab):
                    hub.register_vocab(vocab, len(v) if v
                                       else int(arr.max()) + 1)
            user_cols = tuple(cols)
        eh = hub.build(self.dtype)

        item_op = item_inputer = None
        if self.use_item_content:
            item_op, item_inputer = self._item_side(item_cols, item_hidden,
                                                    emb_dim, eh, device)
            item_dim = item_op.output_dim
        else:
            item_dim = eh.dim_of(item_id_vocab, "history")

        ucfg = combine_config(
            {k: v for k, v in self.user_config.items()
             if k != "inputer_config"},
            hidden_size=self.hidden_size,
            input_dim=emb_dim if user_from_user_cols else item_dim)
        ucfg = _filter_fields(ucfg, user_op_cls, "user_config")
        if ("num_semantic_layers" in init_fields(user_op_cls)
                and "num_semantic_layers" not in ucfg and item_cols):
            # a semantic operator has a level per code of an item
            ucfg["num_semantic_layers"] = item_cols[0][2]
        user_op = user_op_cls(dtype=self.dtype, **ucfg)

        user_inputer = None
        if flatten:
            # the user operator reads the history's item columns itself,
            # flattened by its own inputer, or the batch's user columns
            # (JAX :201-229)
            u_inputer_cfg = _filter_fields(
                dict(self.user_config.get("inputer_config") or {}),
                user_op_cls.inputer_class, "user_config.inputer_config")
            u_cols = user_cols or item_cols
            col, vocab, _ = u_cols[0]
            user_inputer = user_op_cls.inputer_class(
                cols=u_cols, dtype=self.dtype, dim=eh.dim_of(vocab, col),
                **u_inputer_cfg)

        pcfg = combine_config(dict(self.predictor_config),
                              hidden_size=self.hidden_size)
        pcfg = _filter_fields(pcfg, pred_cls, "predictor_config")
        if "input_dim" in inspect.signature(pred_cls.__init__).parameters:
            # a head with its own layers over the user and item reprs
            if user_op.output_dim != item_dim:
                raise ValueError(
                    f"{self.predictor}: the user repr is "
                    f"{user_op.output_dim} wide, the item repr {item_dim}")
            pcfg["input_dim"] = user_op.output_dim
        if "num_pairs" in init_fields(pred_cls):
            # SemanticMix: (item levels) x (user codes) pair scores
            levels = item_op.output_levels(item_cols) if item_op else 1
            pcfg["num_pairs"] = levels * (user_cols[0][2] if user_cols else 1)
        predictor = pred_cls(dtype=self.dtype, **pcfg)

        # compatibility checks (reference lego_config.py:217-224)
        if self.use_neg_sampling and not predictor.allow_matching:
            raise ValueError(
                f"{self.predictor} does not support matching "
                f"(neg-sampling) mode")
        if not self.use_neg_sampling and not predictor.allow_ranking:
            raise ValueError(f"{self.predictor} does not support ranking mode")

        # the gather-reduce embedding backward of the whole-catalog encode,
        # and the history gather's, built on the contents' device
        catalog_plans = history_plan = None
        if self.use_item_content and self.full_catalog_encode != "off":
            catalog_plans = build_catalog_plans(
                {c: contents.columns[c] for c, _, _ in item_cols},
                contents.col_vocabs, eh.specs) or None
            hm = None if flatten else data.history_matrix()
            if hm is not None and getattr(hm, "ndim", 0) == 2:
                history_plan = HistoryGradPlan(np.asarray(hm),
                                               contents.num_items,
                                               device=device)

        model = Legommender(
            eh=eh,
            item_op=item_op,
            user_op=user_op,
            predictor=predictor,
            item_inputer=item_inputer,
            user_inputer=user_inputer,
            item_page_size=self.item_page_size,
            item_page_remat=self.item_page_remat,
            full_catalog_encode=self.full_catalog_encode,
            catalog_plans=catalog_plans,
            catalog_history_plan=history_plan,
            item_id_vocab=item_id_vocab,
            user_batch_cols=tuple(c for c, _, _ in user_cols),
        )
        return model, contents

    def _item_side(self, item_cols, item_hidden: int, emb_dim: int, eh,
                   device):
        """The item operator, built on `device` (an LM's constructor draws
        its weights, a decoder's billions of them), and its inputer (at
        the embedding width: its special tokens are parameters)."""
        item_op_cls = OPERATORS[self.item_operator]
        icfg = combine_config(
            {k: v for k, v in self.item_config.items()
             if k != "inputer_config"},
            hidden_size=item_hidden, input_dim=emb_dim)
        icfg = _filter_fields(icfg, item_op_cls, "item_config")
        op_params = init_fields(item_op_cls)
        if "num_cols" in op_params:
            icfg["num_cols"] = len(item_cols)
        if "cols" in op_params:
            icfg["cols"] = item_cols
        # YAML configs express dtypes as strings ("bf16")
        if isinstance(icfg.get("lm_dtype"), str):
            icfg["lm_dtype"] = DTYPE_NAMES[icfg["lm_dtype"].lower()]
        with torch.device(device):
            item_op = item_op_cls(dtype=self.dtype, **icfg)
        inputer_cfg = dict(self.item_config.get("inputer_config") or {})
        inputer_cfg = _filter_fields(inputer_cfg, item_op_cls.inputer_class,
                                     "item_config.inputer_config")
        col, vocab, _ = item_cols[0]
        item_inputer = item_op_cls.inputer_class(
            cols=item_cols, dtype=self.dtype, dim=eh.dim_of(vocab, col),
            **inputer_cfg)
        return item_op, item_inputer
