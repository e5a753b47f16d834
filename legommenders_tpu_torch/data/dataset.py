"""LegoData — runtime dataset container: items/users/interaction stores.

Replaces the reference's Manager data-side responsibilities
(loader/manager.py:229-266): loading the item/user/interaction stores,
truncating history, applying per-column filters, and binding the ColumnMap
to fitted vocabs.
"""
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from legommenders_tpu_torch.data.column_map import ColumnMap
from legommenders_tpu_torch.data.token_store import StoreHub, TokenStore, UNSET
from legommenders_tpu_torch.data.vocab import VocabHub


def apply_replication(specs: List[Tuple[str, Optional[int]]],
                      store: TokenStore) -> List[Tuple[str, Optional[int]]]:
    """Resolve `src -> dst` (deep) / `src --> dst` (lazy) replication specs
    against a store (reference loader/manager.py:176-183).

    Deliberate divergence: the reference tests `"->" in col` FIRST, so its
    lazy `-->` branch is unreachable (`"a --> b".split("->")` leaves a
    stray dash); here `-->` is matched first and both forms work."""
    out = []
    for col, max_len in specs:
        if "-->" in col:
            src, dst = map(str.strip, col.split("-->"))
            store.replicate(src, dst, lazy=True)
            col = dst
        elif "->" in col:
            src, dst = map(str.strip, col.split("->"))
            store.replicate(src, dst, lazy=False)
            col = dst
        out.append((col, max_len))
    return out


def parse_input_specs(inputs) -> List[Tuple[str, Optional[int]]]:
    """Parse data-config item input specs.

    YAML `- title@glove: 30` arrives as {"title@glove": 30}; `- category`
    as "category" (reference: config/data/mind.yaml item.inputs).
    """
    specs: List[Tuple[str, Optional[int]]] = []
    for entry in inputs or []:
        if isinstance(entry, str):
            specs.append((entry, None))
        elif isinstance(entry, dict):
            for col, max_len in entry.items():
                specs.append((col, int(max_len) if max_len else None))
        else:
            raise ValueError(f"bad input spec: {entry!r}")
    return specs


class LegoData:
    def __init__(
        self,
        items: TokenStore,
        users: TokenStore,
        inters: Dict[str, TokenStore],
        column_map: ColumnMap,
        item_inputs: List[Tuple[str, Optional[int]]],
        user_inputs: Optional[List[Tuple[str, Optional[int]]]] = None,
        name: str = "data",
    ):
        self.name = name
        self.items = items
        self.users = users
        self.inters = inters  # phase -> store, phases: train/dev/test
        self.cm = column_map
        self.item_inputs = item_inputs
        # user-side input columns (reference lego_config user_inputs) —
        # consumed by SemanticMix-style user inputers; batchers emit them
        self.user_inputs = user_inputs or []
        self.cm.bind_vocabs(users, inters.get("train") or next(iter(inters.values())))

    # ------------------------------------------------------------------
    @property
    def num_items(self) -> int:
        return len(self.items)

    @property
    def num_users(self) -> int:
        return len(self.users)

    def history_matrix(self) -> np.ndarray:
        """(num_users, S) int32 with UNSET padding."""
        return self.users[self.cm.history_col]

    def neg_matrix(self) -> Optional[np.ndarray]:
        col = self.cm.neg_col
        if col and col in self.users:
            return self.users[col]
        return None

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, data_cfg, vocab_hub: Optional[VocabHub] = None) -> "LegoData":
        """Build from a resolved data config (config/data/*.yaml layout,
        reference: config/data/mind.yaml)."""
        cfg = data_cfg.raw() if hasattr(data_cfg, "raw") else dict(data_cfg)
        hub = vocab_hub or VocabHub()

        items = StoreHub.get(cfg["item"]["ut"], hub).view()
        users = StoreHub.get(cfg["user"]["ut"], hub).view()
        cm = ColumnMap.from_config(cfg.get("column_map"))

        truncate = cfg["user"].get("truncate")
        if truncate:
            users.truncate(cm.history_col, int(truncate))

        inters = {}
        phase_keys = {"train": "train", "dev": "dev", "test": "test"}
        for phase, key in phase_keys.items():
            path = cfg["inter"].get(key)
            if path:
                store = StoreHub.get(path, hub).view()
                filters = cfg["inter"].get("filters") or {}
                for col, fns in filters.items():
                    for fn in fns if isinstance(fns, list) else [fns]:
                        # filter applies on user-joined columns: history lives
                        # in the user store; interaction stores carry user ids
                        if col in store:
                            idx = store.filter(col, fn, cache_dir=path)
                            store = store.select(
                                idx, tag=f"filter:{col}:{fn}")
                        elif col in users:
                            legal_users = set(
                                users.filter(col, fn, cache_dir=cfg["user"]["ut"]).tolist()
                            )
                            uids = store[cm.user_col]
                            mask = np.fromiter(
                                (int(u) in legal_users for u in uids),
                                dtype=bool, count=len(uids),
                            )
                            store = store.select(
                                np.nonzero(mask)[0],
                                tag=f"userfilter:{col}:{fn}")
                inters[phase] = store

        specs = parse_input_specs(cfg["item"].get("inputs"))
        specs = apply_replication(specs, items)
        for col, max_len in specs:
            if max_len and col in items:
                items.truncate(col, max_len)

        u_specs = parse_input_specs(cfg["user"].get("inputs"))
        u_specs = apply_replication(u_specs, users)
        for col, max_len in u_specs:
            if max_len and col in users:
                users.truncate(col, max_len)

        return cls(items, users, inters, cm, specs, user_inputs=u_specs,
                   name=cfg.get("name", "data"))
