"""TextSet and the text pipeline (port of ``analytics_zoo_tpu.data.text_set``,
numpy only, a copy whose feature sets are the port's) — ref feature/text:
``TextSet`` (TextSet.scala:43,246: read dir-of-class-folders / CSV / parquet),
tokenize → normalize → word2idx:146 → shapeSequence:164 → sample; relation
pairs/lists for ranking (fromRelationPairs:398, fromRelationLists:502) over
``Relations`` (feature/common/Relations.scala:43-154).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import re
import string
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class TextFeature(dict):
    """Per-text record (ref TextFeature): keys ``text``, ``label``,
    ``tokens``, ``indices``, ``uri``."""

    @property
    def text(self):
        """The raw text string of this feature."""
        return self.get("text")


# ---------------------------------------------------------------------------
# Transformers (ref feature/text/{Tokenizer,Normalizer,WordIndexer,
# SequenceShaper,TextFeatureToSample}.scala)
# ---------------------------------------------------------------------------


class TextTransformer:
    """Base text transformer: ``apply(TextFeature) -> TextFeature``;
    chain with ``>>`` / ``then`` (ref TextTransformer, text pipeline).
    """

    def apply(self, f: TextFeature) -> TextFeature:
        """Transform one TextFeature in place and return it."""
        raise NotImplementedError

    def __call__(self, f: TextFeature) -> TextFeature:
        return self.apply(f)


class Tokenizer(TextTransformer):
    """Whitespace tokenizer: fills ``tokens`` from ``text``
    (ref text/Tokenizer)."""

    def apply(self, f: TextFeature) -> TextFeature:
        f["tokens"] = f["text"].split()
        return f


class Normalizer(TextTransformer):
    """Lowercase + strip punctuation (ref Normalizer.scala)."""

    _strip = str.maketrans("", "", string.punctuation)

    def apply(self, f: TextFeature) -> TextFeature:
        f["tokens"] = [t.lower().translate(self._strip) for t in f["tokens"]]
        f["tokens"] = [t for t in f["tokens"] if t]
        return f


class WordIndexer(TextTransformer):
    """Map tokens to integer ids via ``word_index``; OOV tokens are
    dropped or replaced with ``replace_oov`` (ref text/WordIndexer)."""

    def __init__(self, word_index: Dict[str, int], replace_oov: Optional[int] = None):
        self.word_index = word_index
        self.replace_oov = replace_oov

    def apply(self, f: TextFeature) -> TextFeature:
        idx = []
        for t in f["tokens"]:
            if t in self.word_index:
                idx.append(self.word_index[t])
            elif self.replace_oov is not None:
                idx.append(self.replace_oov)
        f["indices"] = idx
        return f


class SequenceShaper(TextTransformer):
    """Pad/truncate to fixed length (ref shapeSequence, TextSet.scala:164).
    trunc_mode: 'pre' keeps the tail, 'post' keeps the head."""

    def __init__(self, length: int, trunc_mode: str = "pre", pad_element: int = 0):
        self.length = length
        self.trunc_mode = trunc_mode
        self.pad = pad_element

    def apply(self, f: TextFeature) -> TextFeature:
        idx = f["indices"]
        if len(idx) > self.length:
            idx = idx[-self.length:] if self.trunc_mode == "pre" else idx[: self.length]
        else:
            idx = idx + [self.pad] * (self.length - len(idx))
        f["indices"] = idx
        return f


# ---------------------------------------------------------------------------
# Relations (ref feature/common/Relations.scala)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Relation:
    id1: str
    id2: str
    label: int


class Relations:
    """Ref feature/common/Relations.scala:43 — the utility facade; the
    module-level functions are the implementation."""

    @staticmethod
    def read(path: str) -> "List[Relation]":
        """Load relations from csv/parquet/ndjson (ref Relations.read)."""
        return read_relations(path)

    @staticmethod
    def generate_relation_pairs(relations, seed: int = 0):
        """Interleave (positive, negative) relation rows for rank_hinge
        training (ref Relations.generateRelationPairs).
        """
        return generate_relation_pairs(relations, seed=seed)


def read_relations(path: str) -> List[Relation]:
    """Ref Relations.read:43 — CSV with (id1, id2, label), optional header."""
    out = []
    with open(path, newline="") as fh:
        for row in csv.reader(fh):
            if not row or row[0].lower() == "id1":
                continue
            out.append(Relation(row[0], row[1], int(row[2])))
    return out


def generate_relation_pairs(relations: Sequence[Relation],
                            seed: int = 0) -> List[Tuple[Relation, Relation]]:
    """Ref Relations.generateRelationPairs:92 — for each id1, pair each
    positive with a sampled negative."""
    rng = np.random.default_rng(seed)
    by_q: Dict[str, Dict[int, List[Relation]]] = {}
    for r in relations:
        by_q.setdefault(r.id1, {}).setdefault(1 if r.label > 0 else 0, []).append(r)
    pairs = []
    for q, groups in by_q.items():
        pos, neg = groups.get(1, []), groups.get(0, [])
        if not pos or not neg:
            continue
        for p in pos:
            pairs.append((p, neg[int(rng.integers(0, len(neg)))]))
    return pairs


# ---------------------------------------------------------------------------
# TextSet
# ---------------------------------------------------------------------------


class TextSet:
    """Ref TextSet.scala:43 — a collection of TextFeatures with a fluent
    pipeline (tokenize/normalize/word2idx/shape) ending in arrays for the
    training engine."""

    def __init__(self, features: List[TextFeature]):
        self.features = features
        self.word_index: Optional[Dict[str, int]] = None

    # -- readers ---------------------------------------------------------

    @staticmethod
    def read(path: str) -> "TextSet":
        """Dir of class subdirs of .txt files (ref TextSet.read:289)."""
        feats = []
        classes = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d)))
        for label, c in enumerate(classes):
            cdir = os.path.join(path, c)
            for fn in sorted(os.listdir(cdir)):
                with open(os.path.join(cdir, fn), encoding="utf-8",
                          errors="ignore") as fh:
                    feats.append(TextFeature(text=fh.read(), label=label,
                                             uri=os.path.join(cdir, fn)))
        return TextSet(feats)

    @staticmethod
    def read_csv(path: str, text_col: int = 1, label_col: Optional[int] = None) -> "TextSet":
        """Ref TextSet.readCSV:344 — (id, text) rows."""
        feats = []
        with open(path, newline="", encoding="utf-8") as fh:
            for row in csv.reader(fh):
                f = TextFeature(uri=row[0], text=row[text_col])
                if label_col is not None:
                    f["label"] = int(row[label_col])
                feats.append(f)
        return TextSet(feats)

    @staticmethod
    def read_parquet(path: str, id_col="id", text_col="text") -> "TextSet":
        """Ref TextSet.readParquet:371."""
        import pandas as pd

        df = pd.read_parquet(path)
        return TextSet([TextFeature(uri=str(r[id_col]), text=str(r[text_col]))
                        for _, r in df.iterrows()])

    @staticmethod
    def from_texts(texts: Sequence[str], labels: Optional[Sequence[int]] = None) -> "TextSet":
        """Build a TextSet from raw strings (+ optional labels)."""
        feats = []
        for i, t in enumerate(texts):
            f = TextFeature(text=t)
            if labels is not None:
                f["label"] = int(labels[i])
            feats.append(f)
        return TextSet(feats)

    # -- pipeline --------------------------------------------------------

    def tokenize(self) -> "TextSet":
        """Whitespace-tokenize every feature (ref TextSet.tokenize)."""
        for f in self.features:
            Tokenizer()(f)
        return self

    def normalize(self) -> "TextSet":
        """Lowercase/strip punctuation stage (ref TextSet.normalize)."""
        for f in self.features:
            Normalizer()(f)
        return self

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1, existing_map: Optional[Dict[str, int]] = None
                 ) -> "TextSet":
        """Build/apply the vocabulary (ref TextSet.word2idx:146). Index 0 is
        reserved for padding; OOV dropped (reference behavior)."""
        if existing_map is None:
            freq: Dict[str, int] = {}
            for f in self.features:
                for t in f.get("tokens", []):
                    freq[t] = freq.get(t, 0) + 1
            items = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
            items = [kv for kv in items if kv[1] >= min_freq][remove_topN:]
            if max_words_num > 0:
                items = items[:max_words_num]
            self.word_index = {w: i + 1 for i, (w, _) in enumerate(items)}
        else:
            self.word_index = dict(existing_map)
        indexer = WordIndexer(self.word_index)
        for f in self.features:
            indexer(f)
        return self

    def shape_sequence(self, length: int, trunc_mode: str = "pre") -> "TextSet":
        """Pad/truncate token sequences to ``len`` (ref shapeSequence)."""
        shaper = SequenceShaper(length, trunc_mode)
        for f in self.features:
            shaper(f)
        return self

    def get_word_index(self) -> Optional[Dict[str, int]]:
        """The fitted token -> id map (after word2idx)."""
        return self.word_index

    # -- materialization -------------------------------------------------

    def to_arrays(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Materialize (ids, labels) ndarrays from the processed features."""
        x = np.asarray([f["indices"] for f in self.features], np.int32)
        labels = [f["label"] for f in self.features if "label" in f]
        y = np.asarray(labels, np.int32) if len(labels) == len(self.features) else None
        return x, y

    def to_feature_set(self):
        """Wrap the processed arrays as a trainable FeatureSet."""
        from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet

        x, y = self.to_arrays()
        return ArrayFeatureSet(x, y)

    # -- ranking corpora (ref fromRelationPairs:398 / fromRelationLists:502)

    @staticmethod
    def from_relation_pairs(relations: Sequence[Relation],
                            corpus1: "TextSet", corpus2: "TextSet",
                            seed: int = 0):
        """Build a PairFeatureSet of ((q, pos_doc), (q, neg_doc)) rows for
        RankHinge training. Corpora must already be word2idx'd + shaped."""
        from analytics_zoo_tpu_torch.data.feature_set import PairFeatureSet

        idx1 = {f["uri"]: f["indices"] for f in corpus1.features}
        idx2 = {f["uri"]: f["indices"] for f in corpus2.features}
        qs, ds = [], []
        for pos, neg in generate_relation_pairs(relations, seed):
            qs.extend([idx1[pos.id1], idx1[neg.id1]])
            ds.extend([idx2[pos.id2], idx2[neg.id2]])
        x = [np.asarray(qs, np.int32), np.asarray(ds, np.int32)]
        y = np.zeros(len(qs), np.float32)
        return PairFeatureSet(x, y)

    @staticmethod
    def from_relation_lists(relations: Sequence[Relation],
                            corpus1: "TextSet", corpus2: "TextSet"):
        """Per-query grouped (q_indices, d_indices, label) lists for MAP/NDCG
        evaluation (ref TextSet.fromRelationLists:502)."""
        idx1 = {f["uri"]: f["indices"] for f in corpus1.features}
        idx2 = {f["uri"]: f["indices"] for f in corpus2.features}
        grouped: Dict[str, List[Tuple[List[int], List[int], int]]] = {}
        for r in relations:
            grouped.setdefault(r.id1, []).append((idx1[r.id1], idx2[r.id2], r.label))
        return [
            (np.asarray([g[0] for g in rows], np.int32),
             np.asarray([g[1] for g in rows], np.int32),
             np.asarray([g[2] for g in rows], np.int32))
            for rows in grouped.values()
        ]
