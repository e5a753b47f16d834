"""Legommender — the composed model, for serving and for training.

The port of the JAX package's models/legommender.py: an item (content)
operator, a user (behavior) operator and a click predictor over shared
embedding tables (reference model/legommender.py:55-263).

  * `item_inputer` is a submodule: an inputer with parameters (the
    special tokens of ConcatInputer) keeps them in the model's state_dict;
  * `encode_item_content`: token-id contents {col: (..., L)} -> item
    vectors (..., D); in layer-split LM mode the contents carry the cached
    lower-slice hidden states under LM_HIDDEN_KEY and the item operator
    runs its upper slice over them (JAX :91-161). With `item_page_size` the
    flattened rows are encoded in pages; under `item_page_remat: full`
    each page is a torch.utils.checkpoint region (recomputed in the
    backward, only its output kept), under `none` every page keeps its
    activations, under `ffn` a page's checkpoint keeps the outputs of
    the FFN's second dense layers (`lm.remat.FFNStash`, JAX
    `save_only_these_names(FFN_OUT_TAG)`) and under `dots` it is a
    selective checkpoint that keeps every matrix product's (`DOT_OPS`,
    JAX `dots_saveable`); the rest is recomputed, the attention kernel
    included (JAX `_encode_paged`, :163-213). A page gathers its rows
    inside the region, as JAX gathers inside the scan body;
  * `encode_item_lower`: the offline split of layer-split mode (:215-223);
  * `encode_user`: click vectors (B, S, D) + mask (B, S) -> (B, D);
  * `score_cached`: precomputed reprs -> scores (B, K);
  * `forward`: the JAX `__call__` (:281-357). For content models: with
    `full_catalog_encode` "on", or "auto" while num_items <= 2 B (K + S),
    the whole catalog is encoded once and candidates and clicks are
    gathered from it; otherwise candidates and clicks are encoded per
    occurrence in one pass. Without item content (`use_item_content`
    false: no item operator or inputer) candidates and clicks are rows of
    the item-id table (`item_id_embedding`, ids clipped into it); the
    clicks are not masked before the user operator, as in JAX. In
    flatten mode (a FlattenTransformer / FlattenFastformer / Semantic
    user) the candidates are encoded per occurrence and the user operator
    reads the clicks' tokens through its own `user_inputer`
    (`encode_user_flatten`), or, with `user_batch_cols` (SCMix), those
    columns of the batch (JAX :295-310). An item operator's output may be
    a stack (SCSimple over the codes: (..., C, D)); its rank is kept.
`rng` is the explicit dropout generator of a training forward; None is
eval mode (JAX `training=False`). A paged forward draws one seed per page
from it before the page runs and gives the page a generator of its own
made from that seed: torch.utils.checkpoint restores only torch's default
generators, so a page that drew from `rng` itself would draw other masks
when it is recomputed in the backward.

The catalog gradient plans (ops/catalog_grad.py, JAX :71-80, 91-122,
312-343): `catalog_plans` ({col: CatalogGradPlan}) route the embedding
backward of the whole-catalog encode through gather-reduce segment sums
for each column whose runtime tensor is the one its plan was built from
(the others take the plain lookup, with a warning);
`catalog_history_plan` (HistoryGradPlan) carries the history gather of a
training forward (a dropout generator given) whose batch has `user_id`.
Neither changes a forward's values; neither applies to a paged encode.
"""
import contextlib
import functools
import logging
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

from legommenders_tpu_torch.models.embedding import (
    EmbeddingTables, PlannedTables,
)
from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.models.lm.remat import FFN_DENSE_OP, FFNStash
from legommenders_tpu_torch.models.operators.base import BaseOperator
from legommenders_tpu_torch.models.operators.lm_ops import (
    LM_HIDDEN_KEY, LM_MASK_KEY,
)
from legommenders_tpu_torch.models.predictors.base import BasePredictor
from legommenders_tpu_torch.ops import catalog_grad
from legommenders_tpu_torch.parallel.mesh import get_pp_mesh
from legommenders_tpu_torch.utils import spans

REMAT_POLICIES = ("full", "none", "dots", "ffn")
_aten = torch.ops.aten
# the matrix products a `dots` page keeps (JAX dots_saveable keeps every
# dot_general); the attention kernel launches outside the dispatcher and
# is recomputed, as JAX recomputes the Pallas call
DOT_OPS = frozenset((_aten.mm.default, _aten.addmm.default,
                     _aten.bmm.default, _aten.baddbmm.default,
                     FFN_DENSE_OP))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# each page checkpoint's `context_fn` by policy (`full`: none)
PAGE_CONTEXTS = {
    "ffn": lambda: FFNStash().contexts(),
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy)}


class Legommender(nn.Module):
    def __init__(self, eh: EmbeddingTables, item_op: Optional[BaseOperator],
                 user_op: BaseOperator, predictor: BasePredictor,
                 item_inputer: Optional[BaseInputer],
                 user_inputer: Optional[BaseInputer] = None,
                 item_page_size: int = 0,
                 item_page_remat: str = "full",
                 full_catalog_encode: str = "auto",
                 catalog_plans: Optional[dict] = None,
                 catalog_history_plan=None, item_id_vocab: str = "item_id",
                 user_batch_cols: tuple = ()):
        super().__init__()
        if item_page_remat not in REMAT_POLICIES:
            raise ValueError(f"item_page_remat={item_page_remat!r}: one of "
                             f"{REMAT_POLICIES}")
        if full_catalog_encode not in ("auto", "on", "off"):
            raise ValueError(f"full_catalog_encode={full_catalog_encode!r}: "
                             f"auto, on or off")
        self.eh = eh
        self.item_op = item_op
        self.user_op = user_op
        self.predictor = predictor
        self.item_inputer = item_inputer
        self.user_inputer = user_inputer
        self.item_page_size = int(item_page_size or 0)
        self.item_page_remat = item_page_remat
        self.full_catalog_encode = full_catalog_encode
        self.catalog_plans = catalog_plans
        self.catalog_history_plan = catalog_history_plan
        self.item_id_vocab = item_id_vocab
        self.user_batch_cols = tuple(user_batch_cols)
        self._warned_dead = set()

    @property
    def use_item_content(self) -> bool:
        """Items are encoded from their content; else they are rows of the
        item-id table."""
        return self.item_op is not None

    @property
    def flatten_mode(self) -> bool:
        """The user operator reads the flattened click history (its own
        inputer over the clicks' item columns), not click vectors."""
        return bool(type(self.user_op).flatten_mode)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for part in (self.eh, self.item_inputer, self.item_op,
                     self.user_inputer, self.user_op, self.predictor):
            if part is not None:
                part.reset_parameters(generator)

    # ------------------------------------------------------------------ #
    # item side                                                          #
    # ------------------------------------------------------------------ #
    def _encode_flat(self, flat: Dict[str, torch.Tensor],
                     rng: Optional[torch.Generator] = None,
                     catalog: bool = False) -> torch.Tensor:
        """One inputer + item-operator pass over flattened (M, ...) rows;
        `catalog`: the rows are the whole catalog, as the plans were built
        from it."""
        if LM_HIDDEN_KEY in flat:
            return self.item_op(flat[LM_HIDDEN_KEY], flat[LM_MASK_KEY],
                                rng=rng)
        eh = self.eh
        if catalog and self.catalog_plans:
            # a plan applies only where the runtime column is the matrix
            # it was built from; a swapped column takes the plain lookup
            live = {c: p for c, p in self.catalog_plans.items()
                    if c in flat and p.matches_source(flat[c])}
            dead = tuple(c for c in self.catalog_plans
                         if c in flat and c not in live)
            catalog_grad.record_trace(live, dead)
            if dead and dead not in self._warned_dead:
                self._warned_dead.add(dead)
                logging.getLogger("legommenders_tpu_torch").warning(
                    f"catalog-grad plan INACTIVE for columns {list(dead)}: "
                    f"runtime column is not the baked matrix — embedding "
                    f"backward falls back to the plain lookup")
            if live:
                eh = PlannedTables(self.eh, live)
        emb, mask = self.item_inputer.get_embeddings(eh, flat, rng)
        return self.item_op(emb, mask, rng=rng)

    def encode_item_content(self, contents: Dict[str, torch.Tensor],
                            rng: Optional[torch.Generator] = None,
                            catalog: bool = False) -> torch.Tensor:
        """contents: {col: (..., L)} token ids (and, in layer-split mode,
        LM_HIDDEN_KEY (..., L, D) / LM_MASK_KEY (..., L)) -> (..., D) item
        vectors. Leading dims are flattened for the operator pass and
        restored; contents with one leading dim pass as they are (the
        catalog plans know their tensors by identity). `catalog`: the
        contents are the whole catalog (the plans apply unless paged)."""
        lm_mode = LM_HIDDEN_KEY in contents
        first = (contents[LM_HIDDEN_KEY] if lm_mode
                 else next(iter(contents.values())))
        lead = first.shape[:-2] if lm_mode else first.shape[:-1]
        flat = {c: a if len(lead) == 1
                else a.reshape((-1,) + tuple(a.shape[len(lead):]))
                for c, a in contents.items()}
        M = flat[LM_HIDDEN_KEY if lm_mode else next(iter(flat))].shape[0]
        P = self.item_page_size
        if P > 0 and M > P:
            out = self._encode_paged(flat, M, P, rng)
        else:
            out = self._encode_flat(flat, rng, catalog)
        return out.reshape(*lead, *out.shape[1:])

    def _encode_page(self, flat: Dict[str, torch.Tensor], M: int, P: int,
                     page: int, seed: Optional[int]) -> torch.Tensor:
        """Rows page*P .. page*P+P-1 (clipped to M: the tail re-encodes the
        last row), gathered here, with a generator made from `seed`."""
        device = next(iter(flat.values())).device
        ids = (page * P + torch.arange(P, device=device)).clamp(max=M - 1)
        rows = {c: a.index_select(0, ids) for c, a in flat.items()}
        rng = None
        if seed is not None:
            rng = torch.Generator(device=device)
            rng.manual_seed(seed)
        return self._encode_flat(rows, rng)

    def _encode_paged(self, flat: Dict[str, torch.Tensor], M: int, P: int,
                      rng: Optional[torch.Generator]) -> torch.Tensor:
        n_pages = -(-M // P)
        seeds = [None] * n_pages
        if rng is not None:
            seeds = torch.randint(0, 2 ** 62, (n_pages,), generator=rng,
                                  device=rng.device).tolist()
        policy = self.item_page_remat
        remat = policy != "none" and torch.is_grad_enabled()
        kw = ({"context_fn": PAGE_CONTEXTS[policy]}
              if policy in PAGE_CONTEXTS else {})
        # a staged LM's recompute makes the pp transfers again: every
        # stage must run it whole, in the same order
        staged = get_pp_mesh() is not None
        outs = []
        for page, seed in enumerate(seeds):
            fn = functools.partial(self._encode_page, flat, M, P, page, seed)
            with (set_checkpoint_early_stop(False) if staged
                  else contextlib.nullcontext()):
                outs.append(checkpoint(fn, use_reentrant=False,
                                       preserve_rng_state=False, **kw)
                            if remat else fn())
        return torch.cat(outs)[:M]

    def encode_item_page(self, contents: Dict[str, torch.Tensor]
                         ) -> torch.Tensor:
        """Cache-building entry: one page of items -> (P, D), eval mode."""
        return self.encode_item_content(contents)

    def encode_item_lower(self, contents: Dict[str, torch.Tensor]):
        """Offline LM split: inputer embeddings -> lower-slice hidden
        states. Returns (hidden (N, L, D), mask (N, L))."""
        emb, mask = self.item_inputer.get_embeddings(self.eh, contents)
        return self.item_op.encode_lower(emb, mask), mask

    def item_id_embedding(self, item_ids: torch.Tensor,
                          rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """Rows of the item-id table (JAX :229-231), ids clipped into it;
        the column is the batch key "history", as JAX's LegoConfig fixes
        it (lego_config.py:278-281) whatever the data names the column."""
        return self.eh.embed(item_ids, self.item_id_vocab, "history", rng)

    # ------------------------------------------------------------------ #
    # user side and scoring                                              #
    # ------------------------------------------------------------------ #
    def encode_user(self, clicks: torch.Tensor, mask: torch.Tensor,
                    rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """clicks (B, S, D) click vectors + mask (B, S) -> user repr."""
        return self.user_op(clicks, mask, rng=rng)

    def encode_user_flatten(self, contents: Dict[str, torch.Tensor],
                            rng: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
        """Flatten mode: the clicks' item columns {col: (B, S, L)}, -1
        where a click is padded -> the user repr, through the user
        operator's own inputer (JAX :242-247)."""
        emb, mask = self.user_inputer.get_embeddings(self.eh, contents, rng)
        return self.user_op(emb, mask, rng=rng)

    def score_cached(self, user_repr: torch.Tensor,
                     item_repr: torch.Tensor) -> torch.Tensor:
        """Fast-eval path: precomputed reprs -> scores (B, K)."""
        return self.predictor(user_repr, item_repr)

    def _user_and_score(self, clicks: torch.Tensor, click_mask: torch.Tensor,
                        item_repr: torch.Tensor,
                        rng: Optional[torch.Generator]) -> torch.Tensor:
        """The user encode and the predictor, each a span of its own."""
        user_repr = spans.region(
            "lego.user_encode",
            lambda c: self.encode_user(c, click_mask, rng), clicks)
        return self._score(user_repr, item_repr, rng)

    def _score(self, user_repr: torch.Tensor, item_repr: torch.Tensor,
               rng: Optional[torch.Generator]) -> torch.Tensor:
        return spans.region("lego.score",
                            lambda u, i: self.predictor(u, i, rng),
                            user_repr, item_repr)

    def forward(self, batch: Dict[str, torch.Tensor],
                item_contents: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None,
                item_reprs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw scores (B, K) for a batch of candidates and histories (the
        pipeline's fixed batch keys); K = 1 + negatives (matching) or 1
        (ranking). `item_reprs`, the whole catalog's (N, D) reprs encoded
        beforehand, takes the place of the item encode (catalog-parallel
        evaluation, where no rank holds the contents they come from)."""
        cand_ids = batch["candidates"]                  # (B, K)
        hist_ids = batch["history"]                     # (B, S)
        click_mask = batch["mask"]                      # (B, S)
        if not self.use_item_content:
            item_repr = self.item_id_embedding(cand_ids, rng)
            clicks = self.item_id_embedding(hist_ids, rng)
            return self._user_and_score(clicks, click_mask, item_repr, rng)
        (B, K), S = cand_ids.shape, hist_ids.shape[1]
        num_items = next(iter(item_contents.values())).shape[0]
        safe_cand = cand_ids.clamp(0, num_items - 1)
        safe_hist = hist_ids.clamp(0, num_items - 1)
        if self.flatten_mode:
            # candidates encoded per occurrence; the user operator reads
            # the clicks' tokens, padded clicks' all -1 (JAX :295-310)
            if item_reprs is not None:
                item_repr = item_reprs[safe_cand]
            else:
                cand = {c: a[safe_cand] for c, a in item_contents.items()}
                item_repr = spans.region(
                    "lego.item_encode",
                    lambda: self.encode_item_content(cand, rng))
            if self.user_batch_cols:
                # the user side reads its own batch columns (SemanticMix)
                hist = {c: batch[c] for c in self.user_batch_cols}
            else:
                hist = {c: torch.where(click_mask[..., None] > 0,
                                       a[safe_hist], -1)
                        for c, a in item_contents.items()}
            user_repr = spans.region(
                "lego.user_encode",
                lambda: self.encode_user_flatten(hist, rng))
            return self._score(user_repr, item_repr, rng)
        use_catalog = item_reprs is not None or (
            self.full_catalog_encode == "on" or (
                self.full_catalog_encode == "auto"
                and num_items <= 2 * B * (K + S)))
        if use_catalog:
            # every item encoded once, occurrences gathered
            all_reprs = (item_reprs if item_reprs is not None
                         else spans.region(
                             "lego.item_encode",
                             lambda: self.encode_item_content(
                                 item_contents, rng, catalog=True)))
            item_repr = all_reprs[safe_cand]
            hp = self.catalog_history_plan
            uid = batch.get("user_id")
            use_hp = (hp is not None and rng is not None and uid is not None
                      and item_reprs is None
                      and hp.matches(hist_ids.shape, num_items))
            catalog_grad.record_history(use_hp)
            if use_hp:
                # the ids of batch["history"], read from the plan's matrix;
                # its backward sums by user, then by the static ids
                clicks = hp.take(all_reprs, uid)
            else:
                clicks = all_reprs[safe_hist]
        else:
            # one item-operator pass over candidates + clicks
            all_ids = torch.cat([safe_cand.reshape(-1), safe_hist.reshape(-1)])
            contents = {c: a[all_ids] for c, a in item_contents.items()}
            reprs = spans.region(
                "lego.item_encode",
                lambda: self.encode_item_content(contents, rng))
            item_repr = reprs[:B * K].reshape(B, K, -1)
            clicks = reprs[B * K:].reshape(B, S, -1)
        return self._user_and_score(clicks, click_mask, item_repr, rng)
