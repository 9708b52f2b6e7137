"""Recommendation models (port of
``analytics_zoo_tpu.models.recommendation``): ref models/recommendation/
``NeuralCF`` (NeuralCF.scala:43, buildModel:54-95: MF tower ⊙ + MLP tower,
concat, softmax head), ``WideAndDeep`` (WideAndDeep.scala:80 with
``ColumnFeatureInfo``), ``SessionRecommender`` (a GRU over the session,
optionally with a history MLP), and the ``Recommender`` base with the
recommend-for-user/item utilities. The models are built layer for layer
as in the JAX package, so the weights map 1:1 (``interop``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from analytics_zoo_tpu_torch.autograd.variable import Variable
from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model
from analytics_zoo_tpu_torch.keras.layers import (
    GRU,
    Activation,
    Dense,
    Embedding,
    Flatten,
    Merge,
)
from analytics_zoo_tpu_torch.models.common import ZooModel


@dataclasses.dataclass
class UserItemFeature:
    """Ref recommendation/utils.py UserItemFeature — one (user, item) pair
    (with optional label) to score."""

    user_id: int
    item_id: int
    label: int = 0


@dataclasses.dataclass
class UserItemPrediction:
    """Ref recommendation/utils.py UserItemPrediction. Dict-style access
    (``p["user_id"]``) is kept for callers written against the plain-dict
    era of ``predict_user_item_pair``."""

    user_id: int
    item_id: int
    prediction: int
    probability: float

    def __getitem__(self, key):
        if not isinstance(key, str) or key not in self.__dataclass_fields__:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key):
        # without this, `"probability" in p` falls back to the legacy
        # iteration protocol and calls __getitem__(0)
        return isinstance(key, str) and key in self.__dataclass_fields__

    def __iter__(self):
        return iter(self.__dataclass_fields__)

    def keys(self):
        """dict.keys over the prediction record fields."""
        return self.__dataclass_fields__.keys()

    def values(self):
        """dict.values over the prediction record fields."""
        return [getattr(self, k) for k in self.__dataclass_fields__]

    def items(self):
        """dict.items over the prediction record fields."""
        return [(k, getattr(self, k)) for k in self.__dataclass_fields__]

    def get(self, key, default=None):
        """dict.get over the prediction record fields."""
        return getattr(self, key) if key in self else default


class Recommender(ZooModel):
    """Ref Recommender.scala — shared prediction utilities.

    Models consume (user_id, item_id) int pairs as a (batch, 2) array and
    produce class probabilities (label 0 = negative, 1..k ratings).
    """

    def predict_user_item_pair(self, user_item, batch_size: int = 1024):
        """Score (user, item) pairs -> UserItemPrediction list (ref same name).
        """
        if not isinstance(user_item, np.ndarray):
            # any sequence/iterable: UserItemFeature records or (u, i) rows
            user_item = np.asarray(
                [[p.user_id, p.item_id] if isinstance(p, UserItemFeature)
                 else list(p) for p in user_item], np.int32).reshape(-1, 2)
        if len(user_item) == 0:
            return []
        probs = self.predict(user_item, batch_size=batch_size)
        classes = np.argmax(probs, axis=-1)
        return [
            UserItemPrediction(int(u), int(i), int(c), float(probs[r, c]))
            for r, ((u, i), c) in enumerate(zip(user_item, classes))
        ]

    def recommend_for_user(self, user_item: np.ndarray, max_items: int = 5):
        """Top-N items for each user (ref recommendForUser)."""
        preds = self.predict_user_item_pair(user_item)
        by_user = {}
        for p in preds:
            by_user.setdefault(p["user_id"], []).append(p)
        out = {}
        for u, items in by_user.items():
            items.sort(key=lambda p: (p["prediction"], p["probability"]),
                       reverse=True)
            out[u] = items[:max_items]
        return out

    def recommend_for_item(self, user_item: np.ndarray, max_users: int = 5):
        """Top-N users for each item (ref recommendForItem)."""
        preds = self.predict_user_item_pair(user_item)
        by_item = {}
        for p in preds:
            by_item.setdefault(p["item_id"], []).append(p)
        out = {}
        for i, users in by_item.items():
            users.sort(key=lambda p: (p["prediction"], p["probability"]),
                       reverse=True)
            out[i] = users[:max_users]
        return out


class NeuralCF(Recommender):
    """Neural Collaborative Filtering (ref NeuralCF.scala:43).

    Two towers over (user, item) ids: a GMF tower (embedding elementwise
    product) and an MLP tower (concat embeddings through hidden layers),
    concatenated into a softmax head. ``include_mf`` mirrors the reference
    flag; ``mf_embed`` the MF embedding size (default 20).
    """

    def __init__(self, user_count: int, item_count: int, class_num: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20):
        super().__init__()
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        self.user_embed = user_embed
        self.item_embed = item_embed
        self.hidden_layers = tuple(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = mf_embed
        self.model = self.build_model()

    def build_model(self) -> Model:
        pair = Input(shape=(2,), name="user_item")
        user = pair.index_select(1, 0)  # (batch,)
        item = pair.index_select(1, 1)
        # +1: reference uses 1-based ids (LookupTable); keep row 0 unused.
        mlp_u = Embedding(self.user_count + 1, self.user_embed,
                          name="mlp_user_embed")(user)
        mlp_i = Embedding(self.item_count + 1, self.item_embed,
                          name="mlp_item_embed")(item)
        mlp = Merge(mode="concat")([mlp_u, mlp_i])
        for h in self.hidden_layers:
            mlp = Dense(h, activation="relu")(mlp)
        if self.include_mf:
            mf_u = Embedding(self.user_count + 1, self.mf_embed,
                             name="mf_user_embed")(user)
            mf_i = Embedding(self.item_count + 1, self.mf_embed,
                             name="mf_item_embed")(item)
            mf = Merge(mode="mul")([mf_u, mf_i])
            merged = Merge(mode="concat")([mf, mlp])
        else:
            merged = mlp
        out = Dense(self.class_num, activation="softmax")(merged)
        return Model(pair, out, name="neural_cf")

    def config(self):
        return {"user_count": self.user_count, "item_count": self.item_count,
                "class_num": self.class_num, "user_embed": self.user_embed,
                "item_embed": self.item_embed,
                "hidden_layers": list(self.hidden_layers),
                "include_mf": self.include_mf, "mf_embed": self.mf_embed}


@dataclasses.dataclass
class ColumnFeatureInfo:
    """Ref WideAndDeep.scala ColumnFeatureInfo — declares which input columns
    feed the wide (cross/base), indicator, embedding and continuous slots."""

    wide_base_dims: Sequence[int] = ()
    wide_cross_dims: Sequence[int] = ()
    indicator_dims: Sequence[int] = ()
    embed_in_dims: Sequence[int] = ()
    embed_out_dims: Sequence[int] = ()
    continuous_cols: int = 0

    @property
    def wide_dim(self) -> int:
        """Total width of the wide (cross-product) feature space."""
        return int(sum(self.wide_base_dims) + sum(self.wide_cross_dims))

    @property
    def indicator_dim(self) -> int:
        """Total one-hot width of the indicator columns."""
        return int(sum(self.indicator_dims))


class WideAndDeep(Recommender):
    """Wide & Deep (ref WideAndDeep.scala:80).

    Inputs (list, all batch-first):
      [wide multi-hot (wide_dim,), indicator (indicator_dim,),
       embed ids (n_embed,), continuous (n_cont,)]
    present according to ``model_type`` in {"wide", "deep", "wide_n_deep"}.
    """

    def __init__(self, model_type: str, class_num: int,
                 column_info: ColumnFeatureInfo,
                 hidden_layers: Sequence[int] = (40, 20, 10)):
        super().__init__()
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"model_type must be wide|deep|wide_n_deep, "
                             f"got {model_type}")
        self.model_type = model_type
        self.class_num = class_num
        self.column_info = column_info
        self.hidden_layers = tuple(hidden_layers)
        self.model = self.build_model()

    def build_model(self) -> Model:
        info = self.column_info
        inputs: List[Variable] = []
        towers: List[Variable] = []

        if self.model_type in ("wide", "wide_n_deep"):
            wide = Input(shape=(info.wide_dim,), name="wide")
            inputs.append(wide)
            towers.append(Dense(self.class_num, name="wide_linear")(wide))

        if self.model_type in ("deep", "wide_n_deep"):
            deep_parts: List[Variable] = []
            if info.indicator_dim:
                ind = Input(shape=(info.indicator_dim,), name="indicator")
                inputs.append(ind)
                deep_parts.append(ind)
            if info.embed_in_dims:
                ids = Input(shape=(len(info.embed_in_dims),), name="embed_ids")
                inputs.append(ids)
                for col, (vin, vout) in enumerate(zip(info.embed_in_dims,
                                                      info.embed_out_dims)):
                    e = Embedding(vin + 1, vout, name=f"embed_col{col}")(
                        ids.index_select(1, col))
                    deep_parts.append(e)
            if info.continuous_cols:
                cont = Input(shape=(info.continuous_cols,), name="continuous")
                inputs.append(cont)
                deep_parts.append(cont)
            deep = (Merge(mode="concat")(deep_parts)
                    if len(deep_parts) > 1 else deep_parts[0])
            for h in self.hidden_layers:
                deep = Dense(h, activation="relu")(deep)
            towers.append(Dense(self.class_num, name="deep_linear")(deep))

        merged = Merge(mode="sum")(towers) if len(towers) > 1 else towers[0]
        out = Activation("softmax")(merged)
        return Model(inputs if len(inputs) > 1 else inputs[0], out,
                     name="wide_and_deep")

    def config(self):
        info = self.column_info
        return {"model_type": self.model_type, "class_num": self.class_num,
                "column_info": dataclasses.asdict(info),
                "hidden_layers": list(self.hidden_layers)}

    @classmethod
    def _from_config(cls, cfg):
        cfg["column_info"] = ColumnFeatureInfo(**cfg["column_info"])
        return cls(**cfg)


class SessionRecommender(Recommender):
    """Session-based next-item recommender (the SessionRecommender of the
    reference's recommendation family): a GRU stack over the session's
    recent items, optionally fused with an MLP over a longer purchase
    history, and a softmax over the item catalog.

    Inputs: session ids ``(batch, session_length)`` int (0 = padding), or
    ``[session, history]`` with history ``(batch, his_length)`` when
    ``include_history``; output ``(batch, item_count + 1)`` probabilities
    (row 0 unused: item ids are 1-based, the family convention).
    """

    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 his_length: int = 10):
        super().__init__()
        self.item_count = item_count
        self.item_embed = item_embed
        self.rnn_hidden_layers = tuple(rnn_hidden_layers)
        self.session_length = session_length
        self.include_history = include_history
        self.mlp_hidden_layers = tuple(mlp_hidden_layers)
        self.his_length = his_length
        self.model = self.build_model()

    def build_model(self) -> Model:
        session = Input(shape=(self.session_length,), name="session")
        x = Embedding(self.item_count + 1, self.item_embed,
                      name="session_embed")(session)
        for h in self.rnn_hidden_layers[:-1]:
            x = GRU(h, return_sequences=True)(x)
        rnn = GRU(self.rnn_hidden_layers[-1])(x)

        inputs = [session]
        if self.include_history:
            history = Input(shape=(self.his_length,), name="history")
            h_emb = Embedding(self.item_count + 1, self.item_embed,
                              name="history_embed")(history)
            h = Flatten()(h_emb)
            for units in self.mlp_hidden_layers:
                h = Dense(units, activation="relu")(h)
            merged = Merge(mode="concat")([rnn, h])
            inputs.append(history)
        else:
            merged = rnn
        out = Dense(self.item_count + 1, activation="softmax",
                    name="item_head")(merged)
        return Model(inputs if len(inputs) > 1 else inputs[0], out,
                     name="session_recommender")

    def recommend_for_session(self, sessions, max_items: int = 5,
                              batch_size: int = 1024):
        """Top-k next items per session row: a list of [(item_id, prob)]
        per row, by a host ``np.argsort`` of the probabilities (the JAX
        package's tie order); item id 0 (the padding row) is never
        recommended."""
        probs = self.predict(sessions, batch_size=batch_size)
        probs = np.asarray(probs).copy()
        probs[:, 0] = -np.inf
        k = min(max_items, probs.shape[1] - 1)   # catalog minus padding row
        top = np.argsort(-probs, axis=-1)[:, :k]
        return [[(int(i), float(probs[r, i])) for i in items]
                for r, items in enumerate(top)]

    def config(self):
        return {"item_count": self.item_count, "item_embed": self.item_embed,
                "rnn_hidden_layers": list(self.rnn_hidden_layers),
                "session_length": self.session_length,
                "include_history": self.include_history,
                "mlp_hidden_layers": list(self.mlp_hidden_layers),
                "his_length": self.his_length}
