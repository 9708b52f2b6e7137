"""Dataset helpers (port of ``analytics_zoo_tpu.keras.datasets``, a copy:
the stand-ins give the same arrays bit for bit) — ref the pyzoo Keras API's bundled MNIST/IMDB loaders
(pyzoo keras dataset mirrors, SURVEY.md §2.2 "Keras API (py)" row).

Zero-egress environment: loaders read the standard local file layouts
(``mnist.npz`` keras archive; ``imdb.npz`` int-sequence archive) and, when
no path is given, synthesize structured stand-ins so every example/test
runs offline — clearly logged, with the same shapes/dtypes/contracts as
the real datasets.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch")

Arrays = Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


class mnist:
    """``mnist.load_data(path)`` — keras archive layout (x_train, y_train,
    x_test, y_test); synthetic structured digits when no file exists."""

    @staticmethod
    def load_data(path: Optional[str] = None, n_synth: int = 2048,
                  seed: int = 0) -> Arrays:
        """((x_train, y_train), (x_test, y_test)) from a keras mnist.npz, or
        synthetic structured digits when no path is given (zero egress).
        """
        if path:
            with np.load(path) as d:
                return ((d["x_train"], d["y_train"].astype(np.int32)),
                        (d["x_test"], d["y_test"].astype(np.int32)))
        logger.warning("mnist.load_data: no path given — synthesizing "
                       "structured digits (zero-egress environment)")
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 10, n_synth).astype(np.int32)
        x = (rng.normal(25, 12, size=(n_synth, 28, 28))
             .clip(0, 255).astype(np.uint8))
        for i, k in enumerate(y):   # class k = bright block of size 4+2k
            x[i, 2:6 + 2 * k, 2:6 + 2 * k] = 220
        split = int(0.9 * n_synth)
        return ((x[:split], y[:split]), (x[split:], y[split:]))


class imdb:
    """``imdb.load_data(path)`` — keras npz layout of int sequences;
    synthetic two-polarity sequences when no file exists."""

    @staticmethod
    def load_data(path: Optional[str] = None,
                  num_words: Optional[int] = 5000,
                  maxlen: Optional[int] = None, n_synth: int = 2048,
                  seed: int = 0) -> Arrays:
        """Int-sequence sentiment pairs from a keras imdb.npz (num_words oov
        capping, maxlen FILTERING), or synthetic polarity bands offline.
        """
        if path:
            with np.load(path, allow_pickle=True) as d:
                x_train, y_train = d["x_train"], d["y_train"]
                x_test, y_test = d["x_test"], d["y_test"]

            def cap(seqs, labels):
                # keras contract: maxlen FILTERS OUT longer sequences (with
                # their labels); num_words=None keeps the full vocabulary
                pairs = [(s, l) for s, l in zip(seqs, labels)
                         if maxlen is None or len(s) <= maxlen]
                out = [[w if num_words is None or w < num_words else 2
                        for w in s] for s, _ in pairs]
                return (np.asarray(out, dtype=object),
                        np.asarray([l for _, l in pairs], np.int32))

            return (cap(x_train, y_train), cap(x_test, y_test))
        logger.warning("imdb.load_data: no path given — synthesizing "
                       "polarity sequences (zero-egress environment)")
        rng = np.random.default_rng(seed)
        length = maxlen or 80
        vocab = num_words if num_words is not None else 5000
        if vocab < 502:
            raise ValueError(
                f"synthetic imdb needs num_words >= 502 (got {vocab}): ids "
                "100-500 are the polarity bands, 500+ the filler vocabulary")
        # polarity words live in disjoint id bands; filler is shared
        seqs, labels = [], []
        for _ in range(n_synth):
            y = int(rng.integers(0, 2))
            band = (100, 300) if y else (300, 500)
            n_pol = max(1, length // 5)
            s = rng.integers(500, vocab, size=length)
            pos = rng.choice(length, n_pol, replace=False)
            s[pos] = rng.integers(*band, size=n_pol)
            seqs.append(s.tolist())
            labels.append(y)
        x = np.asarray(seqs, dtype=object)
        y = np.asarray(labels, np.int32)
        split = int(0.9 * n_synth)
        return ((x[:split], y[:split]), (x[split:], y[split:]))

    @staticmethod
    def get_word_index() -> dict:
        """Keras-parity stub for the synthetic corpus: ids are the
        vocabulary (no natural-language words offline); returns the
        id->token identity map for the synthetic bands."""
        return {f"tok{i}": i for i in range(100, 500)}

    @staticmethod
    def pad_sequences(seqs, maxlen: int, value: int = 0) -> np.ndarray:
        """Keras-style pre-padding/truncation to a rectangle."""
        out = np.full((len(seqs), maxlen), value, np.int32)
        for i, s in enumerate(seqs):
            s = list(s)[-maxlen:]
            out[i, maxlen - len(s):] = s
        return out


class boston_housing:
    """``boston_housing.load_data(path)`` — keras npz layout (x, y with 13
    features); synthetic linear-model data when no file exists (ref
    pyzoo/zoo/pipeline/api/keras/datasets/boston_housing.py)."""

    @staticmethod
    def load_data(path: Optional[str] = None, test_split: float = 0.2,
                  n_synth: int = 512, seed: int = 113) -> Arrays:
        """13-feature housing regression split from an npz, or synthetic
        linear housing data offline.
        """
        if path:
            with np.load(path) as d:
                x, y = d["x"], d["y"]
        else:
            logger.warning("boston_housing.load_data: no path given — "
                           "synthesizing linear housing data (zero-egress "
                           "environment)")
            rng = np.random.default_rng(seed)
            x = rng.normal(size=(n_synth, 13)).astype(np.float32) * \
                np.linspace(1.0, 90.0, 13, dtype=np.float32)
            w = rng.normal(size=(13,)).astype(np.float32)
            y = (x @ w * 0.05 + 22.5
                 + rng.normal(0, 1.5, n_synth)).astype(np.float32)
        split = int(len(x) * (1 - test_split))
        return ((x[:split], y[:split]), (x[split:], y[split:]))


class reuters:
    """``reuters.load_data(path)`` — keras npz int-sequence layout with 46
    topic labels; synthetic topic-banded sequences when no file exists (ref
    pyzoo/zoo/pipeline/api/keras/datasets/reuters.py)."""

    NB_CLASSES = 46

    @staticmethod
    def load_data(path: Optional[str] = None,
                  num_words: Optional[int] = 5000,
                  maxlen: Optional[int] = None, test_split: float = 0.2,
                  n_synth: int = 2048, seed: int = 0) -> Arrays:
        """46-topic newswire sequences from an npz, or synthetic topic-banded
        sequences offline.
        """
        if path:
            with np.load(path, allow_pickle=True) as d:
                x, y = d["x"], d["y"]
            pairs = [(s, l) for s, l in zip(x, y)
                     if maxlen is None or len(s) <= maxlen]
            x = np.asarray(
                [[w if num_words is None or w < num_words else 2 for w in s]
                 for s, _ in pairs], dtype=object)
            y = np.asarray([l for _, l in pairs], np.int32)
        else:
            logger.warning("reuters.load_data: no path given — synthesizing "
                           "topic sequences (zero-egress environment)")
            rng = np.random.default_rng(seed)
            length = maxlen or 120
            vocab = num_words if num_words is not None else 5000
            n_topics = reuters.NB_CLASSES
            if vocab < 100 + 10 * n_topics:
                raise ValueError(
                    f"synthetic reuters needs num_words >= {100 + 10 * n_topics}")
            seqs, labels = [], []
            for _ in range(n_synth):
                t = int(rng.integers(0, n_topics))
                s = rng.integers(100 + 10 * n_topics, vocab, size=length)
                pos = rng.choice(length, max(1, length // 6), replace=False)
                s[pos] = rng.integers(100 + 10 * t, 100 + 10 * (t + 1),
                                      size=len(pos))
                seqs.append(s.tolist())
                labels.append(t)
            x = np.asarray(seqs, dtype=object)
            y = np.asarray(labels, np.int32)
        split = int(len(x) * (1 - test_split))
        return ((x[:split], y[:split]), (x[split:], y[split:]))

    get_word_index = imdb.get_word_index
    pad_sequences = imdb.pad_sequences
