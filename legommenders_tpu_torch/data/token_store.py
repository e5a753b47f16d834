"""Columnar token store — fixed-shape numpy arrays per column.

Replaces UniTok datasets + the reference's LegoUT wrapper (SURVEY.md L0;
loader/ut/lego_ut.py:48-288). Design difference, deliberate and TPU-first:
every sequence column is a dense `(N, max_len)` int32 matrix padded with the
`UNSET = -1` sentinel (the reference's pad sentinel, loader/env.py), so a
whole store can be shipped to device memory and indexed by gather inside
`jit` — there is no per-row python object graph.

Capabilities mirrored from LegoUT:
  * save/load of {columns, vocabs, meta} to a directory;
  * `truncate(col, max_len)` (UniTok `retruncate`);
  * string-lambda filters with persistent legal-index caching keyed by the
    filter set (lego_ut.py:161-244);
  * `select(indices)` row subsetting and `union` column merge.
"""
import hashlib
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from legommenders_tpu_torch.data.vocab import Vocab, VocabHub
from legommenders_tpu_torch.utils.io import json_load, json_save

UNSET = -1  # pad sentinel inside sequence columns (reference loader/env.py)


class TokenStore:
    def __init__(
        self,
        columns: Optional[Dict[str, np.ndarray]] = None,
        col_vocab: Optional[Dict[str, str]] = None,
        vocab_hub: Optional[VocabHub] = None,
        key_col: Optional[str] = None,
        lineage: tuple = (),
    ):
        self.columns: Dict[str, np.ndarray] = columns or {}
        self.col_vocab: Dict[str, str] = col_vocab or {}
        self.vocab_hub = vocab_hub or VocabHub()
        self.key_col = key_col
        # history of row-subsetting operations — part of the filter-cache
        # key so cached indices are only reused for an identical pipeline
        self.lineage: tuple = lineage

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        for arr in self.columns.values():
            return int(arr.shape[0])
        return 0

    def __contains__(self, col: str) -> bool:
        return col in self.columns

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col]

    def col_names(self) -> List[str]:
        return list(self.columns)

    def vocab_of(self, col: str) -> Optional[Vocab]:
        name = self.col_vocab.get(col)
        return self.vocab_hub.get(name) if name else None

    def vocab_name(self, col: str) -> Optional[str]:
        return self.col_vocab.get(col)

    def max_len(self, col: str) -> int:
        arr = self.columns[col]
        return int(arr.shape[1]) if arr.ndim == 2 else 1

    # ------------------------------------------------------------------
    def add_seq_column(self, name: str, rows: Sequence[Sequence[int]],
                      vocab: Union[str, Vocab], max_len: Optional[int] = None):
        """Pad a ragged list of token-id rows into (N, max_len) with UNSET."""
        if max_len is None:
            max_len = max((len(r) for r in rows), default=1) or 1
        out = np.full((len(rows), max_len), UNSET, dtype=np.int32)
        for i, r in enumerate(rows):
            r = list(r)[:max_len]
            if r:
                out[i, : len(r)] = np.asarray(r, dtype=np.int32)
        self.columns[name] = out
        self._bind_vocab(name, vocab)
        return self

    def add_scalar_column(self, name: str, values: Sequence,
                          vocab: Union[str, Vocab, None] = None,
                          dtype=np.int32):
        self.columns[name] = np.asarray(values, dtype=dtype)
        if vocab is not None:
            self._bind_vocab(name, vocab)
        return self

    def _bind_vocab(self, col: str, vocab: Union[str, Vocab]):
        if isinstance(vocab, Vocab):
            self.vocab_hub.add(vocab)
            self.col_vocab[col] = vocab.name
        else:
            self.col_vocab[col] = vocab

    # ------------------------------------------------------------------
    def lengths(self, col: str) -> np.ndarray:
        arr = self.columns[col]
        if arr.ndim == 1:
            return np.ones(arr.shape[0], dtype=np.int32)
        return (arr != UNSET).sum(axis=1).astype(np.int32)

    def replicate(self, src: str, dst: str, lazy: bool = False):
        """Alias a column under a new name (UniTok `replicate`, used by the
        data-config `->`/`-->` syntax, reference loader/manager.py:176-183).

        `lazy` shares the underlying array (safe: every mutation here
        replaces column arrays, never writes in place); deep copies it.
        The vocab binding is shared either way, so a feature-keyed
        pretrained table can still override it per column."""
        arr = self.columns[src]
        self.columns[dst] = arr if lazy else arr.copy()
        if src in self.col_vocab:
            self.col_vocab[dst] = self.col_vocab[src]
        self.lineage = self.lineage + (
            f"replicate:{src}->{dst}:{'lazy' if lazy else 'deep'}",)
        return self

    def truncate(self, col: str, max_len: int):
        """UniTok `retruncate` equivalent: clip a sequence column.
        Replaces the column array (no in-place mutation of shared arrays)
        and records the operation in the lineage."""
        arr = self.columns[col]
        if arr.ndim == 2 and arr.shape[1] > max_len:
            self.columns[col] = np.ascontiguousarray(arr[:, :max_len])
        elif arr.ndim == 2 and arr.shape[1] < max_len:
            pad = np.full((arr.shape[0], max_len - arr.shape[1]), UNSET, np.int32)
            self.columns[col] = np.concatenate([arr, pad], axis=1)
        self.lineage = self.lineage + (f"truncate:{col}:{max_len}",)
        return self

    def view(self) -> "TokenStore":
        """Shallow copy: shares column arrays but owns its dicts/lineage,
        so truncation/union on the view never mutates a StoreHub-cached
        original."""
        return TokenStore(dict(self.columns), dict(self.col_vocab),
                          self.vocab_hub, self.key_col, self.lineage)

    def select(self, indices: np.ndarray, tag: str = "select") -> "TokenStore":
        cols = {k: np.ascontiguousarray(v[indices]) for k, v in self.columns.items()}
        return TokenStore(cols, dict(self.col_vocab), self.vocab_hub,
                          self.key_col,
                          lineage=self.lineage + (f"{tag}:{len(indices)}",))

    def union(self, other: "TokenStore", cols: Optional[List[str]] = None):
        """Merge columns of another store of identical row order
        (reference: manager.py applies `union` for user columns)."""
        for name in cols or other.col_names():
            self.columns[name] = other.columns[name]
            if name in other.col_vocab:
                self.col_vocab[name] = other.col_vocab[name]
                self.vocab_hub.add(other.vocab_hub.get(other.col_vocab[name]))
        return self

    # ------------------------------------------------------------------
    # Filters with persistent caching (parity: lego_ut.py:161-244).
    # ------------------------------------------------------------------
    def filter(self, col: str, fn: Union[str, Callable],
               cache_dir: Optional[str] = None) -> np.ndarray:
        """Return legal row indices where fn(row_value) is truthy.

        `fn` may be a python callable or a `"lambda x: ..."` string (the
        reference eval's these, lego_ut.py:236). For sequence columns the
        value passed is the un-padded id list.

        Persistent caching only applies to STRING filters (a callable's
        identity can't be fingerprinted); the key covers the filter string,
        the store's row count AND its lineage of prior subsetting
        operations, so stale indices are never reused after an upstream
        filter changes.
        """
        key = None
        if cache_dir is not None and isinstance(fn, str):
            blob = f"{col}::{fn}::{len(self)}::{'|'.join(self.lineage)}"
            key = hashlib.md5(blob.encode()).hexdigest()[:16]
            cpath = os.path.join(cache_dir, "filters", f"{key}.npy")
            if os.path.isfile(cpath):
                return np.load(cpath)

        func = eval(fn) if isinstance(fn, str) else fn  # noqa: S307 (parity)
        arr = self.columns[col]
        if arr.ndim == 1:
            mask = np.fromiter((bool(func(v)) for v in arr), dtype=bool,
                               count=arr.shape[0])
        else:
            lens = self.lengths(col)
            mask = np.fromiter(
                (bool(func(list(arr[i, : lens[i]]))) for i in range(arr.shape[0])),
                dtype=bool, count=arr.shape[0],
            )
        indices = np.nonzero(mask)[0].astype(np.int64)
        if key is not None:
            os.makedirs(os.path.join(cache_dir, "filters"), exist_ok=True)
            np.save(os.path.join(cache_dir, "filters", f"{key}.npy"), indices)
        return indices

    # ------------------------------------------------------------------
    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        np.savez_compressed(os.path.join(directory, "columns.npz"), **self.columns)
        meta = {
            "key_col": self.key_col,
            "col_vocab": self.col_vocab,
            "dtypes": {k: str(v.dtype) for k, v in self.columns.items()},
        }
        json_save(meta, os.path.join(directory, "meta.json"))
        vdir = os.path.join(directory, "vocabs")
        for name in set(self.col_vocab.values()):
            if name in self.vocab_hub:
                self.vocab_hub.get(name).save(vdir)
        return directory

    @classmethod
    def load(cls, directory: str, vocab_hub: Optional[VocabHub] = None) -> "TokenStore":
        meta = json_load(os.path.join(directory, "meta.json"))
        data = np.load(os.path.join(directory, "columns.npz"))
        columns = {k: data[k] for k in data.files}
        hub = vocab_hub or VocabHub()
        vdir = os.path.join(directory, "vocabs")
        for name in set(meta["col_vocab"].values()):
            if name not in hub and os.path.isfile(os.path.join(vdir, f"{name}.vocab")):
                hub.add(Vocab.load(vdir, name))
        return cls(columns, meta["col_vocab"], hub, meta.get("key_col"))


class StoreHub:
    """Process-wide memo cache path -> TokenStore (reference: ut_hub.py:34-56)."""

    _cache: Dict[str, TokenStore] = {}

    @classmethod
    def get(cls, path: str, vocab_hub: Optional[VocabHub] = None) -> TokenStore:
        path = os.path.abspath(path)
        if path not in cls._cache:
            cls._cache[path] = TokenStore.load(path, vocab_hub)
        return cls._cache[path]

    @classmethod
    def clear(cls):
        cls._cache.clear()
