"""Central interaction-schema mapping (reference: loader/column_map.py:24-109)."""
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ColumnMap:
    item_col: str = "item_id"
    user_col: str = "user_id"
    history_col: str = "history"
    neg_col: Optional[str] = "neg"
    label_col: str = "click"
    group_col: str = "user_id"
    mask_col: str = "__clicks_mask__"
    # bound later from fitted stores (col -> vocab name),
    # parity: column_map.set_column_vocab (loader/column_map.py:80-109)
    col_vocabs: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_config(cls, cfg: dict) -> "ColumnMap":
        cfg = dict(cfg or {})
        known = {k: cfg[k] for k in
                 ("item_col", "user_col", "history_col", "neg_col",
                  "label_col", "group_col", "mask_col") if k in cfg}
        return cls(**known)

    def bind_vocabs(self, user_store, inter_store):
        if self.history_col in user_store.col_vocab:
            self.col_vocabs[self.history_col] = user_store.vocab_name(self.history_col)
        for col in (self.item_col, self.user_col):
            if col in inter_store.col_vocab:
                self.col_vocabs[col] = inter_store.vocab_name(col)
        return self
