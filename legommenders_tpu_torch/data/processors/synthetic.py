"""Synthetic mini-dataset fixture: a few hundred items/users standing in for
MIND (SURVEY.md §4 test strategy). Generated with a *planted preference
structure* so models can actually learn: items and users live in latent
topic clusters and click probability depends on topic agreement — AUC well
above 0.5 is achievable, which lets tests assert learning, not just shapes.
"""
from typing import Dict

import numpy as np

from legommenders_tpu_torch.data.processors.base import BaseProcessor
from legommenders_tpu_torch.data.token_store import TokenStore, UNSET
from legommenders_tpu_torch.data.vocab import Vocab
from legommenders_tpu_torch.utils.registry import PROCESSORS


@PROCESSORS.register
class SyntheticProcessor(BaseProcessor):
    name = "synthetic"

    def __init__(
        self,
        raw_dir=None,
        save_dir=None,
        num_items: int = 400,
        num_users: int = 200,
        num_topics: int = 8,
        vocab_size: int = 500,
        title_len: int = 16,
        history_len: int = 20,
        inters_per_user: int = 30,
        seed: int = 2023,
    ):
        super().__init__(raw_dir, save_dir)
        self.num_items = num_items
        self.num_users = num_users
        self.num_topics = num_topics
        self.vocab_size = vocab_size
        self.title_len = title_len
        self.history_len = history_len
        self.inters_per_user = inters_per_user
        self.seed = seed

    def build(self) -> Dict[str, TokenStore]:
        rng = np.random.default_rng(self.seed)
        T, N, U, V = self.num_topics, self.num_items, self.num_users, self.vocab_size

        word_vocab = Vocab("word", tokens=[f"w{i}" for i in range(V)])
        cat_vocab = Vocab("category", tokens=[f"c{i}" for i in range(T)])
        item_vocab = Vocab("item_id", tokens=[f"i{i}" for i in range(N)])
        user_vocab = Vocab("user_id", tokens=[f"u{i}" for i in range(U)])

        # each topic owns a band of the word vocab; titles mostly draw from
        # the item's topic band
        item_topic = rng.integers(0, T, N)
        band = V // T
        titles = np.empty((N, self.title_len), np.int32)
        for i in range(N):
            lo = item_topic[i] * band
            topical = rng.integers(lo, lo + band, self.title_len)
            noise = rng.integers(0, V, self.title_len)
            use_noise = rng.random(self.title_len) < 0.2
            titles[i] = np.where(use_noise, noise, topical)
        title_lens = rng.integers(self.title_len // 2, self.title_len + 1, N)
        title_rows = [titles[i, : title_lens[i]].tolist() for i in range(N)]

        items = TokenStore(vocab_hub=self.vocab_hub, key_col="item_id")
        items.add_seq_column("title", title_rows, word_vocab, self.title_len)
        items.add_scalar_column("category", item_topic.astype(np.int32), cat_vocab)
        items.add_scalar_column("item_id", np.arange(N, dtype=np.int32), item_vocab)

        # user topic mixtures -> click prob by topic agreement
        user_pref = rng.dirichlet(np.ones(T) * 0.3, U)  # (U, T)

        def click_prob(u, item_ids):
            return 0.05 + 0.9 * user_pref[u, item_topic[item_ids]]

        histories, inter_rows = [], {"train": [], "valid": [], "test": []}
        for u in range(U):
            h_len = int(rng.integers(3, self.history_len + 1))
            # history: sample items proportional to the user's preference
            probs = click_prob(u, np.arange(N))
            probs = probs / probs.sum()
            hist = rng.choice(N, size=h_len, replace=False, p=probs)
            histories.append(hist.tolist())

            cands = rng.integers(0, N, self.inters_per_user * 3)
            labels = (rng.random(len(cands)) < click_prob(u, cands)).astype(np.int32)
            # impression group id: unique per (user, phase-chunk)
            for k, (c, l) in enumerate(zip(cands, labels)):
                phase = ("train", "valid", "test")[min(k // self.inters_per_user, 2)]
                inter_rows[phase].append((u, int(c), int(l), u))

        users = TokenStore(vocab_hub=self.vocab_hub, key_col="user_id")
        users.add_scalar_column("user_id", np.arange(U, dtype=np.int32), user_vocab)
        users.add_seq_column("history", histories, item_vocab, self.history_len)

        stores: Dict[str, TokenStore] = {"items": items, "users": users}
        for phase, rows in inter_rows.items():
            arr = np.asarray(rows, np.int32)
            st = TokenStore(vocab_hub=self.vocab_hub)
            st.add_scalar_column("user_id", arr[:, 0], user_vocab)
            st.add_scalar_column("item_id", arr[:, 1], item_vocab)
            st.add_scalar_column("click", arr[:, 2])
            st.add_scalar_column("imp_id", arr[:, 3])
            stores[phase] = st

        negs = self.aggregate_negatives(
            U, [stores["train"], stores["valid"]],
            "user_id", "item_id", "click", self.max_neg_store,
        )
        users.add_seq_column(
            "neg", [[x for x in row if x != UNSET] for row in negs],
            item_vocab, negs.shape[1],
        )
        return stores

    def as_lego_data(self, neg_col: str = "neg"):
        """Convenience: build in-memory LegoData without touching disk."""
        from legommenders_tpu_torch.data.column_map import ColumnMap
        from legommenders_tpu_torch.data.dataset import LegoData

        stores = self.build()
        cm = ColumnMap(group_col="imp_id", neg_col=neg_col)
        return LegoData(
            items=stores["items"],
            users=stores["users"],
            inters={"train": stores["train"], "dev": stores["valid"],
                    "test": stores["test"]},
            column_map=cm,
            item_inputs=[("title", None), ("category", None)],
            name="synthetic",
        )
