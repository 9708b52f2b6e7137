"""Sample sources feeding the streaming input pipeline.

Ref: the reference's feature-engineering stack reads ImageSet/TextSet
collections off distributed storage into executor-local partitions and
iterates them per epoch (ImageSet.scala:46,140, TextSet.scala). The
port keeps one unifying contract instead of per-format
readers: a :class:`Source` is an *indexable* collection — ``len()`` plus
``fetch(i)`` producing sample ``i`` at any time, as a pure function of
``i``. Everything the pipeline layer needs falls out of that purity:

- **Determinism** — the epoch stream is ``(order, position)`` over the
  source; parallel map workers may race, but reassembly in index order
  makes the stream bitwise independent of worker count.
- **O(1) mid-epoch resume** — a checkpointed iterator records its
  position; restore re-derives the (cheap, integer) order and continues
  at that position without decoding a single consumed sample.
- **Multi-host windows** — a process materializes only the rows of each
  global batch it owns, because any row can be fetched in isolation.

Records are either ``(x, y)`` pairs (array sources) or
:class:`~analytics_zoo_tpu_torch.data.image_set.ImageFeature` dicts (file and
image sources — the transform chain then runs in the pipeline's
``map`` stage, exactly like the reference's executor-side OpenCV
pipelines).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Source",
    "ArraySource",
    "FeatureSetSource",
    "ImageSetSource",
    "TextSetSource",
    "FileSource",
    "NpyRowsSource",
]


class Source:
    """Indexable sample source: ``len(source)`` + ``fetch(i)``.

    ``fetch`` must be a pure function of ``i`` (and safe to call from
    several map workers at once) — the pipeline's determinism and
    checkpoint/resume contracts both rest on it.
    """

    def __len__(self) -> int:
        raise NotImplementedError

    def fetch(self, i: int) -> Any:
        """Produce sample ``i`` (any record type the map stage handles)."""
        raise NotImplementedError


class ArraySource(Source):
    """In-memory ``(x, y)`` arrays; ``x``/``y`` may be lists of arrays
    (multi-input / multi-target models)."""

    def __init__(self, x, y=None):
        self.xs = list(x) if isinstance(x, (list, tuple)) else [x]
        self.xs = [np.asarray(a) for a in self.xs]
        self._multi_x = isinstance(x, (list, tuple))
        self.ys = None
        self._multi_y = False
        if y is not None:
            self.ys = [np.asarray(a) for a in (
                y if isinstance(y, (list, tuple)) else [y])]
            self._multi_y = isinstance(y, (list, tuple))
        n = len(self.xs[0])
        for a in self.xs + (self.ys or []):
            if len(a) != n:
                raise ValueError(
                    f"all arrays must share dim 0 ({len(a)} vs {n})")

    def __len__(self) -> int:
        return len(self.xs[0])

    def fetch(self, i: int):
        x = [a[i] for a in self.xs]
        x = x if self._multi_x else x[0]
        if self.ys is None:
            return x, None
        y = [a[i] for a in self.ys]
        return x, (y if self._multi_y else y[0])


class FeatureSetSource(Source):
    """Adapter over any :class:`~analytics_zoo_tpu_torch.data.feature_set.
    FeatureSet` — per-sample ``take`` of a length-1 index batch, with the
    batch dim squeezed back off. Transform chains attached to the set
    (``TransformedFeatureSet``) run inside ``fetch`` and therefore on the
    pipeline's map workers."""

    def __init__(self, feature_set):
        self.feature_set = feature_set

    def __len__(self) -> int:
        return self.feature_set.num_samples

    @staticmethod
    def _squeeze(v):
        if isinstance(v, (list, tuple)):
            return [np.asarray(a)[0] for a in v]
        return np.asarray(v)[0]

    def fetch(self, i: int):
        x, y = self.feature_set.take(np.asarray([i]))
        return self._squeeze(x), (None if y is None else self._squeeze(y))


class ImageSetSource(Source):
    """Adapter over an :class:`~analytics_zoo_tpu_torch.data.image_set.ImageSet`:
    ``fetch`` yields a fresh :class:`ImageFeature` copy (pixel data
    deep-copied — in-place transforms must never mutate the source), with
    the set's accumulated transform chain carried along as the pipeline's
    default map function."""

    def __init__(self, image_set):
        self.image_set = image_set

    def __len__(self) -> int:
        return len(self.image_set.features)

    @property
    def chain(self):
        """The ImageSet's accumulated transform list (pipeline default map)."""
        return list(self.image_set._chain)

    def fetch(self, i: int):
        from analytics_zoo_tpu_torch.data.image_set import ImageFeature

        out = ImageFeature(self.image_set.features[i])
        if "image" in out:
            out["image"] = np.array(out["image"], copy=True)
        return out


class TextSetSource(Source):
    """Adapter over a processed :class:`~analytics_zoo_tpu_torch.data.text_set.
    TextSet`: the token arrays materialize once (text indices are tiny
    next to pixels) and ``fetch`` indexes them."""

    def __init__(self, text_set):
        x, y = text_set.to_arrays()
        self._inner = ArraySource(x, y)

    def __len__(self) -> int:
        return len(self._inner)

    def fetch(self, i: int):
        return self._inner.fetch(i)


class FileSource(Source):
    """A directory (class subdirs become labels, mirroring
    ``ImageSet.read``) or explicit file list; ``fetch`` yields an
    :class:`ImageFeature` carrying ``uri`` (+ ``label``) — decode happens
    in the map stage (``ImageRead`` / ``ImageBytesToMat``), i.e. on the
    worker pool, which is the whole point of streaming from files.

    **Ordering contract** (pinned by tests/test_batch_scoring.py — the
    batch runner's shard-range math and every mid-epoch resume position
    index into this order, so it is part of the checkpoint format):

    - directory without labels: files in ``sorted()`` name order;
    - directory with labels: class subdirs in ``sorted()`` name order,
      then each class's files in ``sorted()`` name order — so index ``i``
      maps to the same (file, label) on every host and every run,
      regardless of filesystem enumeration order;
    - explicit list: the caller's order, verbatim.

    ``len()`` is fixed at construction (the entry list snapshots once);
    files added to the directory afterwards are invisible, files removed
    fail at ``fetch`` time — never silently renumber."""

    def __init__(self, path: Union[str, Sequence[str]],
                 with_label: bool = False, one_based_label: bool = False):
        self.label_map: dict = {}
        entries: List[Tuple[str, Optional[int]]] = []
        if isinstance(path, str) and os.path.isdir(path):
            if with_label:
                classes = sorted(d for d in os.listdir(path)
                                 if os.path.isdir(os.path.join(path, d)))
                base = 1 if one_based_label else 0
                self.label_map = {c: i + base for i, c in enumerate(classes)}
                for c in classes:
                    for fn in sorted(os.listdir(os.path.join(path, c))):
                        full = os.path.join(path, c, fn)
                        if os.path.isfile(full):
                            entries.append((full, self.label_map[c]))
            else:
                for fn in sorted(os.listdir(path)):
                    full = os.path.join(path, fn)
                    if os.path.isfile(full):
                        entries.append((full, None))
        else:
            paths = [path] if isinstance(path, str) else list(path)
            missing = [p for p in paths if not os.path.isfile(p)]
            if missing:
                raise ValueError(
                    f"not files (or not found): {missing[:3]!r}"
                    + (f" (+{len(missing) - 3} more)" if len(missing) > 3
                       else ""))
            entries = [(p, None) for p in paths]
        if not entries:
            raise ValueError(f"no files found under {path!r}")
        self.entries = entries

    def __len__(self) -> int:
        return len(self.entries)

    def fetch(self, i: int):
        from analytics_zoo_tpu_torch.data.image_set import ImageFeature

        uri, label = self.entries[i]
        f = ImageFeature(uri=uri)
        if label is not None:
            f["label"] = label
        return f


class NpyRowsSource(Source):
    """Rows of one or more ``.npy`` files, concatenated along axis 0 —
    the batch-predict CLI's input format (``scripts/batch_predict.py``
    globs these). Files contribute rows in ``sorted()`` path order
    (same contract as :class:`FileSource`), so the global row index —
    and with it every shard range and resume offset — is stable across
    runs and hosts. Files open ``mmap_mode="r"``: ``fetch(i)`` touches
    only row ``i``'s pages, so a multi-GB input costs per-row I/O, and
    the returned row is a copy (callers never alias the mapping)."""

    def __init__(self, paths: Union[str, Sequence[str]]):
        paths = [paths] if isinstance(paths, str) else sorted(paths)
        if not paths:
            raise ValueError("NpyRowsSource needs at least one .npy file")
        missing = [p for p in paths if not os.path.isfile(p)]
        if missing:
            raise ValueError(f"not files (or not found): {missing[:3]!r}")
        self.paths = list(paths)
        self._arrays = [np.load(p, mmap_mode="r") for p in self.paths]
        shapes = {a.shape[1:] for a in self._arrays}
        if len(shapes) > 1:
            raise ValueError(
                f"input files disagree on row shape: {sorted(shapes)}")
        self._offsets = np.cumsum([0] + [a.shape[0] for a in self._arrays])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def fetch(self, i: int):
        k = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return np.array(self._arrays[k][i - self._offsets[k]]), None
