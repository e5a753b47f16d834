"""Embedding hub: unified vocab/feature-keyed embedding tables.

The port of the JAX package's models/embedding.py:25-208 (EmbedSpec,
EmbeddingTables, EmbeddingHub), itself after reference
loader/embedding_hub.py:121-385:
  * tables keyed by vocab name AND by feature (column) name, lookup
    precedence feature > vocab;
  * pretrained `.npy` matrices, frozen (no grad) or trainable;
  * a Linear (+ dropout, drawn from the forward's generator) transform
    after lookup when the table dim differs from the model dim or the
    policy is 'linear';
  * token ids clipped into the table (UNSET = -1 reads row 0; the caller
    masks pad positions);
  * `embed(..., plan=)` and `PlannedTables`: a static full-catalog lookup
    takes its column's ops/catalog_grad.CatalogGradPlan (the same forward,
    a scatter-free backward; JAX embedding.py:87-141);
  * `shard_rows` (JAX `shard_axis`, :55-70): under the mesh's mp axis a
    table holds rows / n_mp rows (parallel/mesh.place_model) and `embed`
    looks it up owner-computes (parallel/embed_sharded.sharded_lookup),
    its backward adding into the owned rows only. A sharded table takes
    no catalog gradient plan: a plan's per-row sums span the whole table,
    so its lookup takes the plain transpose, as JAX's catalog-parallel
    step does (parallel/catalog.py:144).
"""
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from legommenders_tpu_torch.models.common import dropout, reset_linear
from legommenders_tpu_torch.parallel.embed_sharded import sharded_lookup
from legommenders_tpu_torch.parallel.mesh import shard_slice


@dataclass(frozen=True)
class EmbedSpec:
    name: str                       # vocab or feature (column) name
    kind: str                       # 'vocab' | 'feature'
    size: int                       # rows
    dim: int                        # table dim (pretrained dim if loaded)
    frozen: bool = False
    has_pretrained: bool = False
    transform: bool = False         # project dim -> target_dim after lookup
    target_dim: int = 0
    transform_dropout: float = 0.0

    @property
    def param_name(self) -> str:
        return f"{self.kind}__{self.name}"


class EmbeddingTables(nn.Module):
    """Every table of the model. Parameters: `tables.<kind>__<name>`
    (size, dim) and `transforms.<kind>__<name>.{weight,bias}`."""

    def __init__(self, specs: Tuple[EmbedSpec, ...],
                 pretrained: Optional[Dict[str, np.ndarray]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.specs = tuple(specs)
        self.pretrained = dict(pretrained or {})
        self.dtype = dtype
        self.tables = nn.ParameterDict()
        self.transforms = nn.ModuleDict()
        for spec in self.specs:
            self.tables[spec.param_name] = nn.Parameter(
                torch.empty(spec.size, spec.dim),
                requires_grad=not spec.frozen)
            if spec.transform:
                self.transforms[spec.param_name] = nn.Linear(
                    spec.dim, spec.target_dim)
        self._by_name = {(s.kind, s.name): s for s in self.specs}
        # param_name -> the mp axis its rows are sharded over
        self.row_shards = {}
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for spec in self.specs:
                table = self.tables[spec.param_name]
                if spec.has_pretrained:
                    arr = np.asarray(self.pretrained[spec.param_name],
                                     np.float32)
                    if arr.shape != (spec.size, spec.dim):
                        raise ValueError(
                            f"pretrained {spec.param_name}: {arr.shape} != "
                            f"({spec.size}, {spec.dim})")
                    table.copy_(torch.from_numpy(arr))
                else:
                    table.normal_(0.0, 0.02, generator=generator)
        for layer in self.transforms.values():
            reset_linear(layer, generator)

    def shard_rows(self, keys, axis):
        """Keep this rank's rows of each table in `keys` (param names) and
        look them up owner-computes over `axis` from now on."""
        for key in keys:
            table = self.tables[key]
            table.data = shard_slice(table.data, 0, axis)
            self.row_shards[key] = axis

    def _spec(self, vocab_name: str, col_name: Optional[str]) -> EmbedSpec:
        if col_name is not None and ("feature", col_name) in self._by_name:
            return self._by_name[("feature", col_name)]
        if ("vocab", vocab_name) in self._by_name:
            return self._by_name[("vocab", vocab_name)]
        raise KeyError(f"no embedding table for vocab={vocab_name} col={col_name}")

    def dim_of(self, vocab_name: str, col_name: Optional[str] = None) -> int:
        """Width of the vectors `embed` returns for this vocab/column."""
        spec = self._spec(vocab_name, col_name)
        return spec.target_dim if spec.transform else spec.dim

    def embed(self, ids: torch.Tensor, vocab_name: str,
              col_name: Optional[str] = None,
              rng: Optional[torch.Generator] = None,
              plan=None) -> torch.Tensor:
        """Lookup with UNSET-safe clipping; the caller masks pad positions.
        `plan` (ops/catalog_grad.CatalogGradPlan) routes the backward of a
        static full-catalog lookup through its gather-reduce segment sum;
        it applies only to a trainable table of the shape it was built for
        (the content was checked by the caller, `matches_source`)."""
        spec = self._spec(vocab_name, col_name)
        table = self.tables[spec.param_name]
        axis = self.row_shards.get(spec.param_name)
        if axis is not None:
            out = sharded_lookup(table, ids.clamp(0, spec.size - 1),
                                 axis).to(self.dtype)
        elif (plan is not None and not spec.frozen
                and plan.matches(ids.shape, spec.size)):
            out = plan.take(table).to(self.dtype)
        else:
            safe = ids.clamp(0, spec.size - 1)
            out = nn.functional.embedding(safe, table).to(self.dtype)
        if spec.transform:
            layer = self.transforms[spec.param_name]
            out = nn.functional.linear(out, layer.weight.to(self.dtype),
                                       layer.bias.to(self.dtype))
            out = dropout(out, spec.transform_dropout, rng)
        return out


class PlannedTables:
    """A view of EmbeddingTables that hands each column's catalog gradient
    plan to `embed`: the inputers stay unaware of plans, and Legommender
    passes this view on the full-catalog encode only."""

    def __init__(self, eh: EmbeddingTables, plans: Dict[str, object]):
        self._eh = eh
        self._plans = plans or {}

    def embed(self, ids, vocab_name, col_name=None, rng=None):
        return self._eh.embed(ids, vocab_name, col_name, rng,
                              plan=self._plans.get(col_name))

    def dim_of(self, vocab_name, col_name=None):
        return self._eh.dim_of(vocab_name, col_name)


class EmbeddingHub:
    """Collects table registrations on the Python side before module creation
    (mirrors the reference's registration flow: register_vocab /
    load_pretrained_embedding, embedding_hub.py:239-360)."""

    def __init__(self, embedding_dim: int, transformation: str = "auto",
                 transformation_dropout: float = 0.0):
        self.embedding_dim = embedding_dim
        self.transformation = transformation
        self.transformation_dropout = transformation_dropout
        self._specs: Dict[Tuple[str, str], EmbedSpec] = {}
        self.pretrained: Dict[str, np.ndarray] = {}

    def register_vocab(self, name: str, size: int, dim: Optional[int] = None):
        key = ("vocab", name)
        if key in self._specs:
            if self._specs[key].size != size:
                raise ValueError(
                    f"vocab size conflict for '{name}': "
                    f"{self._specs[key].size} vs {size}")
            return
        self._specs[key] = EmbedSpec(
            name=name, kind="vocab", size=size,
            dim=dim or self.embedding_dim)
        self._apply_transform_policy(key)

    def load_pretrained(self, array: np.ndarray, vocab_name: str = None,
                        col_name: str = None, frozen: bool = True):
        if (vocab_name is None) == (col_name is None):
            raise ValueError("load_pretrained: give exactly one of "
                             "vocab_name/col_name")
        kind = "vocab" if vocab_name else "feature"
        name = vocab_name or col_name
        arr = np.asarray(array, np.float32)
        spec = EmbedSpec(name=name, kind=kind, size=arr.shape[0],
                         dim=arr.shape[1], frozen=frozen, has_pretrained=True)
        self._specs[(kind, name)] = spec
        self.pretrained[spec.param_name] = arr
        self._apply_transform_policy((kind, name))

    def _apply_transform_policy(self, key):
        spec = self._specs[key]
        needs = (self.transformation == "linear") or (
            self.transformation == "auto" and spec.dim != self.embedding_dim)
        if needs:
            self._specs[key] = EmbedSpec(
                **{**spec.__dict__, "transform": True,
                   "target_dim": self.embedding_dim,
                   "transform_dropout": self.transformation_dropout})

    def has(self, vocab_name: str) -> bool:
        return ("vocab", vocab_name) in self._specs

    def size_of(self, vocab_name: str) -> int:
        return self._specs[("vocab", vocab_name)].size

    def build(self, dtype: torch.dtype = torch.float32) -> EmbeddingTables:
        specs = tuple(sorted(self._specs.values(), key=lambda s: s.param_name))
        return EmbeddingTables(specs, dict(self.pretrained), dtype)
