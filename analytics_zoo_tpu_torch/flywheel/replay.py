"""Replay captured traffic as a training :class:`Source`.

:class:`CaptureSource` turns one or more *committed* capture segments
(see :mod:`analytics_zoo_tpu_torch.flywheel.capture`) into the indexable
``len() + fetch(i)`` contract the streaming pipeline is built on — so
captured production traffic feeds ``Estimator.fit``/``train`` with the
full determinism and O(1)-resume guarantees of any other source
(``Pipeline.from_capture`` is the one-liner).

Trust model, matching the batch readers: the manifest is the source of
truth (only shards it lists are touched — a live or crashed writer's
``.tmp`` debris and unrecorded shards are invisible), and damage is
loud — a missing, short or checksum-mismatched shard raises
:class:`~analytics_zoo_tpu_torch.batch.writers.ShardCorruptError` at first
touch, never silently truncating an epoch. Ordering is stable: segments
in the order given (or segment-index order when discovering under a
model root), shards in manifest order, rows in shard order — the same
byte stream on every construction, which is what makes a mid-epoch
resumed retrain bitwise identical to an uninterrupted one.
"""

from __future__ import annotations

import bisect
import os
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from analytics_zoo_tpu_torch.batch.writers import (
    MANIFEST,
    ShardCorruptError,
    job_complete,
    load_shard_rows,
    read_manifest,
)
from analytics_zoo_tpu_torch.data.sources import Source
from analytics_zoo_tpu_torch.flywheel.capture import (
    committed_segments,
    is_quarantined,
)

__all__ = ["CaptureSource"]


class CaptureSource(Source):
    """Samples from committed capture segments, as ``(x, y)`` pairs with
    the captured prediction as the target (self-distillation: the
    incremental retrain fits the incumbent's observed behaviour on live
    traffic; swap ``y`` post-hoc when ground-truth labels arrive).

    ``dirs`` may be capture segment directories, or model roots
    (``<capture_root>/<model>``) whose committed, non-quarantined
    segments are discovered in index order. Uncommitted or quarantined
    segments passed *explicitly* are an error — the caller named data
    that must not be trained on.
    """

    def __init__(self, dirs: Union[str, os.PathLike, Sequence]):
        if isinstance(dirs, (str, os.PathLike)):
            dirs = [dirs]
        segments: List[str] = []
        for d in dirs:
            d = str(d)
            if os.path.isfile(os.path.join(d, MANIFEST)):
                if not job_complete(d):
                    raise ValueError(
                        f"capture segment {d!r} is not committed — only "
                        "rotated (COMMIT-marked) segments are replayable")
                if is_quarantined(d):
                    raise ValueError(
                        f"capture segment {d!r} is quarantined — a "
                        "rollback excluded it from retraining")
                segments.append(d)
            else:
                segments.extend(committed_segments(d))
        if not segments:
            raise ValueError(
                f"no committed capture segments under {list(map(str, dirs))!r}")
        self.segments = segments
        self._shards: List[Tuple[str, Dict]] = []
        offsets = [0]
        for seg in segments:
            doc = read_manifest(seg)
            if doc is None:
                raise ShardCorruptError(f"{seg!r} has no {MANIFEST}")
            if doc.get("output_format") != "jsonl":
                raise ShardCorruptError(
                    f"capture segment {seg!r} is "
                    f"{doc.get('output_format')!r}, expected jsonl")
            for rec in doc["shards"]:
                self._shards.append((seg, rec))
                offsets.append(offsets[-1] + int(rec["rows"]))
        self._offsets = offsets
        self._lock = threading.Lock()
        self._cache: Dict[int, List] = {}
        self._cache_order: List[int] = []
        self._cache_cap = 4

    def __len__(self) -> int:
        return self._offsets[-1]

    def fetch(self, i: int):
        if not 0 <= i < len(self):
            raise IndexError(i)
        k = bisect.bisect_right(self._offsets, i) - 1
        row = self._shard_rows(k)[i - self._offsets[k]]
        return _decode_row(row)

    # -- shard loading ----------------------------------------------------

    def _shard_rows(self, k: int) -> List:
        """Rows of shard ``k``, CRC-verified on first load and kept in a
        small LRU (sequential epochs touch shards in runs; parallel map
        workers share the cache under the lock)."""
        with self._lock:
            rows = self._cache.get(k)
            if rows is not None:
                return rows
            seg, rec = self._shards[k]
            path = os.path.join(seg, rec["file"])
            try:
                with open(path, "rb") as f:
                    payload = f.read()
            except OSError as e:
                raise ShardCorruptError(
                    f"capture segment {seg!r}: committed shard "
                    f"{rec['file']!r} unreadable ({e})") from e
            got = zlib.crc32(payload)
            if got != rec["crc32"]:
                raise ShardCorruptError(
                    f"capture segment {seg!r}: shard {rec['file']!r} "
                    f"checksum mismatch (stored {rec['crc32']}, computed "
                    f"{got}) — the capture payload is damaged")
            rows = load_shard_rows(path)
            if len(rows) < rec["rows"]:
                raise ShardCorruptError(
                    f"capture segment {seg!r}: shard {rec['file']!r} "
                    f"holds {len(rows)} rows, manifest records "
                    f"{rec['rows']}")
            self._cache[k] = rows
            self._cache_order.append(k)
            if len(self._cache_order) > self._cache_cap:
                self._cache.pop(self._cache_order.pop(0), None)
            return rows


def _decode_row(row: Dict):
    """One capture record back to the ``(x, y)`` sample shape the
    training pipeline consumes, dtypes restored from the recorded
    strings (a float32 request replays as float32)."""
    xs = [np.asarray(v, dtype=np.dtype(d))
          for v, d in zip(row["x"], row["xd"])]
    ys = [np.asarray(v, dtype=np.dtype(d))
          for v, d in zip(row["y"], row["yd"])]
    x = xs if row.get("xm") else xs[0]
    y = ys if row.get("ym") else ys[0]
    return x, y
