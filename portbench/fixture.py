"""The benchmark's data, made from one seed: a vectorised copy of the click
model of `legommenders_tpu_torch/data/processors/synthetic.py`
(`SyntheticProcessor`), sized by a configuration's `data` block.

Items and users live in latent topics. An item's title draws its tokens
from its topic's band of the vocabulary (a fifth of them from anywhere);
its category is its topic. A user's preference over topics is
Dirichlet(0.3); the probability that user u clicks item i is
0.05 + 0.9 * pref[u, topic(i)]. Histories and training clicks are drawn
in proportion to it (with replacement: at 65,238 items a repeat is rare,
where the processor loops over the users to draw without one); each
user's true negatives are drawn in proportion to one minus it; a test
impression shows uniformly drawn candidates, each clicked with that
probability.

Every size that sets the work (title lengths, history lengths, negative
counts, candidates an impression) is a fixed multiset spread evenly over
its range and shuffled by the seed, so every seed makes the same amount of
work in another order. Each part draws from a stream of its own
(`numpy.random.SeedSequence(seed).spawn`), so a part is the same whichever
other parts a traffic mix asks for.

`make` returns plain numpy arrays (UNSET = -1 pads sequences); the
reference reads those. `lego_data` wraps them in the port's LegoData.
"""
import numpy as np

UNSET = -1
PARTS = ("items", "users", "train", "test")


def spread(n: int, lo: int, hi: int, rng) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi], shuffled by rng."""
    vals = lo + (np.arange(n, dtype=np.int64) * (hi - lo + 1)) // max(n, 1)
    return rng.permutation(vals)


def _padded(lengths: np.ndarray, width: int, values: np.ndarray) -> np.ndarray:
    """(n, width) int32: row r holds values[r, :lengths[r]], UNSET after."""
    keep = np.arange(width)[None, :] < lengths[:, None]
    return np.where(keep, values, UNSET).astype(np.int32)


class _TopicSampler:
    """Draws items in proportion to w[u, topic(item)]: a topic by its
    weight times its item count, then an item of that topic uniformly."""

    def __init__(self, item_topic: np.ndarray, num_topics: int):
        self.order = np.argsort(item_topic, kind="stable")
        self.count = np.bincount(item_topic, minlength=num_topics)
        self.start = np.concatenate([[0], np.cumsum(self.count)[:-1]])

    def draw(self, weights: np.ndarray, k: int, rng) -> np.ndarray:
        """weights (n, T) -> (n, k) item ids."""
        p = weights * self.count[None, :]
        cum = np.cumsum(p / p.sum(axis=1, keepdims=True), axis=1)
        r = rng.random((weights.shape[0], k))
        topic = np.minimum((cum[:, None, :] < r[:, :, None]).sum(axis=2),
                           len(self.count) - 1)
        within = (rng.random(topic.shape) * self.count[topic]).astype(np.int64)
        return self.order[self.start[topic] + within]


def make(data: dict, phases, seed: int) -> dict:
    """The arrays of the parts a traffic mix needs (`phases`: "train",
    "test"); items and users always. Sizes from the configuration's
    `data` block."""
    streams = dict(zip(PARTS, (np.random.default_rng(s) for s in
                               np.random.SeedSequence(int(seed)).spawn(
                                   len(PARTS)))))
    N, U, V, T = (int(data[k]) for k in ("items", "users", "vocab",
                                         "topics"))
    t_lo, t_hi = data["title_tokens"]
    h_lo, h_hi = data["history"]

    rng = streams["items"]
    topic = rng.integers(0, T, N)
    band = V // T
    topical = topic[:, None] * band + rng.integers(0, band, (N, t_hi))
    noise = rng.integers(0, V, (N, t_hi))
    tokens = np.where(rng.random((N, t_hi)) < 0.2, noise, topical)
    out = {"title": _padded(spread(N, t_lo, t_hi, rng), t_hi, tokens),
           "category": topic.astype(np.int32)}
    sampler = _TopicSampler(topic, T)

    rng = streams["users"]
    pref = rng.dirichlet(np.full(T, 0.3), U)
    click = 0.05 + 0.9 * pref                       # (U, T)
    out["history"] = _padded(spread(U, h_lo, h_hi, rng), h_hi,
                             sampler.draw(click, h_hi, rng))

    if "train" in phases:
        rng = streams["train"]
        n = int(data["train_clicks"])
        users = rng.integers(0, U, n)
        items = np.empty(n, np.int64)
        # in blocks: the draw holds (rows, T) probabilities
        for s in range(0, n, 65536):
            items[s:s + 65536] = sampler.draw(click[users[s:s + 65536]], 1,
                                              rng)[:, 0]
        out["train_user"] = users.astype(np.int32)
        out["train_item"] = items.astype(np.int32)
        n_lo, n_hi = data["negatives"]
        out["neg"] = _padded(spread(U, n_lo, n_hi, rng), n_hi,
                             sampler.draw(1.0 - click, n_hi, rng))

    if "test" in phases:
        rng = streams["test"]
        n_imp = int(data["test_impressions"])
        c_lo, c_hi = data["candidates"]
        counts = spread(n_imp, c_lo, c_hi, rng)
        imp = np.repeat(np.arange(n_imp), counts)
        users = rng.integers(0, U, n_imp)[imp]
        items = rng.integers(0, N, len(imp))
        p = click[users, topic[items]]
        out["test_user"] = users.astype(np.int32)
        out["test_item"] = items.astype(np.int32)
        out["test_click"] = (rng.random(len(imp)) < p).astype(np.int32)
        out["test_imp"] = imp.astype(np.int32)
    return out


def lego_data(arrays: dict, data: dict):
    """The port's LegoData over `arrays` (train and test phases where
    made): item columns title and category, the users' history and
    negatives, the interaction stores."""
    from legommenders_tpu_torch.data.column_map import ColumnMap
    from legommenders_tpu_torch.data.dataset import LegoData
    from legommenders_tpu_torch.data.token_store import TokenStore
    from legommenders_tpu_torch.data.vocab import Vocab, VocabHub

    hub = VocabHub()
    for name, size in (("word", data["vocab"]), ("category", data["topics"]),
                       ("item_id", data["items"]),
                       ("user_id", data["users"])):
        hub.add(Vocab(name, size=int(size)))
    N, U = int(data["items"]), int(data["users"])
    items = TokenStore({"title": arrays["title"],
                        "category": arrays["category"],
                        "item_id": np.arange(N, dtype=np.int32)},
                       {"title": "word", "category": "category",
                        "item_id": "item_id"}, hub, key_col="item_id")
    ucols = {"user_id": np.arange(U, dtype=np.int32),
             "history": arrays["history"]}
    uvocab = {"user_id": "user_id", "history": "item_id"}
    if "neg" in arrays:
        ucols["neg"] = arrays["neg"]
        uvocab["neg"] = "item_id"
    users = TokenStore(ucols, uvocab, hub, key_col="user_id")

    def store(user, item, click, group):
        return TokenStore({"user_id": user, "item_id": item, "click": click,
                           "imp_id": group},
                          {"user_id": "user_id", "item_id": "item_id"}, hub)

    inters = {}
    if "train_user" in arrays:
        n = len(arrays["train_user"])
        inters["train"] = store(arrays["train_user"], arrays["train_item"],
                                np.ones(n, np.int32),
                                np.arange(n, dtype=np.int32))
    if "test_user" in arrays:
        inters["test"] = store(arrays["test_user"], arrays["test_item"],
                               arrays["test_click"], arrays["test_imp"])
    cm = ColumnMap(group_col="imp_id", neg_col="neg")
    return LegoData(items=items, users=users, inters=inters, column_map=cm,
                    item_inputs=[("title", None), ("category", None)],
                    name="portbench")
