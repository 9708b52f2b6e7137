"""The atomic checkpoint commit protocol, directory format ``azoo-ckpt-v1``
(port of ``analytics_zoo_tpu.ft.atomic``).

A checkpoint is a directory written so that a reader never sees a torn
one:

1. stage every file into ``ckpt_N.tmp/`` (``arrays.npz`` then
   ``manifest.json``), fsyncing each;
2. fsync the staging directory;
3. ``os.rename(ckpt_N.tmp, ckpt_N)``, atomic on POSIX;
4. drop a ``COMMIT`` marker inside ``ckpt_N/`` and fsync it and the parent.

A directory without its ``COMMIT`` marker does not exist as far as
:func:`committed_checkpoints` is concerned. The manifest carries each
leaf's key, shape, dtype and CRC32, so a restore detects damage inside a
committed directory (:class:`CheckpointCorruptError`) and a restore into a
mismatched structure fails naming the key. Every kill site is a
:mod:`analytics_zoo_tpu_torch.ft.chaos` failure point.

The bytes on disk are the JAX package's, so each package reads what the
other wrote. Left out until the distributed port (ROADMAP A7): the
multi-host layout (``host_K/`` shards under a merged manifest).
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_unflatten
from analytics_zoo_tpu_torch.ft import chaos

__all__ = ["FORMAT", "CheckpointError", "CheckpointCorruptError",
           "commit_checkpoint", "read_checkpoint", "read_manifest",
           "verify_checksums", "is_committed", "committed_checkpoints",
           "sweep_stale", "leaf_dtype"]

FORMAT = "azoo-ckpt-v1"
ARRAYS = "arrays.npz"
MANIFEST = "manifest.json"
COMMIT = "COMMIT"


class CheckpointError(RuntimeError):
    """Base error for checkpoint write/read failures."""


class CheckpointCorruptError(CheckpointError):
    """A committed checkpoint failed its integrity checks (CRC mismatch,
    missing or truncated file): external damage, since the commit protocol
    cannot produce it. A restore may fall back to the previous committed
    checkpoint."""


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    # makes the rename/creation durable; not every filesystem supports it
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _leaf_record(key: str, arr: np.ndarray) -> Dict[str, Any]:
    return {"key": key, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "crc32": _crc(arr)}


def commit_checkpoint(path: str, flat: List[Tuple[str, np.ndarray]],
                      metadata: Optional[Dict] = None,
                      overwrite: bool = True) -> str:
    """Write ``flat`` (``[(key, host array), ...]``) as a committed
    checkpoint directory at ``path`` through the staging protocol above
    and return ``path``. ``overwrite=False`` refuses an existing committed
    directory; an uncommitted husk of the same name is swept and
    replaced. The COMMIT marker records the payload bytes."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    if is_committed(path):
        if not overwrite:
            raise FileExistsError(f"{path} exists and overwrite=False")
        shutil.rmtree(path)
    elif os.path.isdir(path):
        shutil.rmtree(path)  # an uncommitted husk from a crash, never data
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": arr for i, (_, arr) in enumerate(flat)})
    data = buf.getvalue()
    with open(os.path.join(tmp, ARRAYS), "wb") as f:
        if chaos.should_fail("torn_arrays"):
            f.write(data[: max(1, len(data) // 2)])
            _fsync_file(f)
            chaos.fail("torn_arrays")
        f.write(data)
        _fsync_file(f)
    chaos.maybe_fail("after_arrays")

    manifest = {"format": FORMAT, "keys": [k for k, _ in flat],
                "leaves": [_leaf_record(k, a) for k, a in flat],
                "metadata": metadata or {}}
    man_bytes = json.dumps(manifest).encode()
    with open(os.path.join(tmp, MANIFEST), "wb") as f:
        f.write(man_bytes)
        _fsync_file(f)
    _fsync_dir(tmp)
    chaos.maybe_fail("before_rename")

    os.rename(tmp, path)
    _fsync_dir(parent)
    chaos.maybe_fail("before_commit")

    with open(os.path.join(path, COMMIT), "w") as f:
        json.dump({"format": FORMAT, "bytes": len(data) + len(man_bytes)}, f)
        _fsync_file(f)
    _fsync_dir(path)
    return path


def is_committed(path: str) -> bool:
    """True iff ``path`` is a checkpoint directory whose COMMIT marker
    landed: the only state a reader may trust."""
    return all(os.path.isfile(os.path.join(path, name))
               for name in (COMMIT, MANIFEST, ARRAYS))


def committed_checkpoints(directory: str, prefix: str = "ckpt"
                          ) -> List[Tuple[int, str]]:
    """``[(step, path)]`` of every committed ``<prefix>_<step>`` directory
    under ``directory``, ascending by step. Uncommitted directories,
    ``*.tmp`` staging husks and unrelated files never appear."""
    if not os.path.isdir(directory):
        return []
    pat = re.compile(rf"{re.escape(prefix)}_(\d+)$")
    out = []
    for fname in os.listdir(directory):
        m = pat.match(fname)
        path = os.path.join(directory, fname)
        if m and is_committed(path):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def sweep_stale(directory: str, prefix: str = "ckpt",
                keep_steps: Optional[set] = None) -> List[str]:
    """Delete crash debris (``*.tmp`` staging directories and uncommitted
    ``<prefix>_<step>`` husks) and, when ``keep_steps`` is given, the
    committed checkpoints whose step is not in it (retention). Every
    removal is counted in ``zoo_checkpoint_sweeps_total{kind}``. Returns
    the removed paths."""
    from analytics_zoo_tpu_torch.common.observability import (
        checkpoint_sweep_counters,
    )

    if not os.path.isdir(directory):
        return []
    counters = checkpoint_sweep_counters()
    pat = re.compile(rf"{re.escape(prefix)}_(\d+)(\.tmp)?$")
    removed = []
    for fname in os.listdir(directory):
        m = pat.match(fname)
        path = os.path.join(directory, fname)
        if not m or not os.path.isdir(path):
            continue
        if m.group(2) is not None:
            kind = "staging"
        elif not is_committed(path):
            kind = "uncommitted"
        elif keep_steps is not None and int(m.group(1)) not in keep_steps:
            kind = "retention"
        else:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
        counters[kind].inc()
    return removed


def read_manifest(path: str) -> Dict[str, Any]:
    """The manifest dict of a checkpoint directory (committed or not);
    raises :class:`CheckpointCorruptError` when missing or unparseable."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: manifest unreadable ({e})") from e


def _load_leaves(path: str, n: int) -> List[np.ndarray]:
    try:
        with np.load(os.path.join(path, ARRAYS)) as npz:
            return [npz[f"a{i}"] for i in range(n)]
    except (OSError, ValueError, KeyError, zlib.error, EOFError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: array payload unreadable ({e})") from e


def verify_checksums(path: str, leaves: Optional[List[np.ndarray]] = None
                     ) -> int:
    """Verify every leaf's CRC32 against the manifest and return the
    number checked; raises :class:`CheckpointCorruptError` naming the
    first mismatched key."""
    recs = read_manifest(path).get("leaves", [])
    if leaves is None:
        leaves = _load_leaves(path, len(recs))
    checked = 0
    for rec, arr in zip(recs, leaves):
        want = rec.get("crc32")
        if want is None:
            continue
        got = _crc(arr)
        if got != want:
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: leaf '{rec['key']}' checksum "
                f"mismatch (stored {want}, computed {got}): the array "
                "payload is damaged")
        checked += 1
    return checked


def leaf_dtype(leaf) -> np.dtype:
    """The numpy dtype a leaf is stored with: a tensor's or an array's
    own, int32 for a host int (a step or an optimizer count, int32 in
    the JAX package too)."""
    if isinstance(leaf, int):
        return np.dtype(np.int32)
    return np.dtype(str(leaf.dtype).removeprefix("torch."))


def read_checkpoint(path: str, like: Any = None, verify: bool = True
                    ) -> Tuple[Any, Dict]:
    """Restore a committed checkpoint directory as host arrays.

    Without ``like``, the flat ``[(key, array), ...]`` list. With ``like``
    (the target tree), each leaf is validated against the target's shape
    and dtype (the error names the key) and the arrays are unflattened
    into ``like``'s structure through ``common.tree``. ``verify`` checks
    the CRC32s first. Returns ``(tree_or_flat, metadata)``."""
    if not is_committed(path):
        raise CheckpointError(
            f"{path!r} is not a committed checkpoint directory")
    manifest = read_manifest(path)
    keys, recs = manifest.get("keys", []), manifest.get("leaves", [])
    leaves = _load_leaves(path, len(recs))
    if verify:
        verify_checksums(path, leaves)
    meta = manifest.get("metadata", {})
    if like is None:
        return list(zip(keys, leaves)), meta
    like_leaves = tree_leaves(like)
    if len(recs) != len(like_leaves):
        raise ValueError(f"Checkpoint {path!r} has {len(recs)} leaves, "
                         f"target structure expects {len(like_leaves)}")
    for rec, leaf in zip(recs, like_leaves):
        want_shape = tuple(getattr(leaf, "shape", ()))
        if tuple(rec["shape"]) != want_shape:
            raise ValueError(
                f"Checkpoint {path!r}: leaf '{rec['key']}' has shape "
                f"{tuple(rec['shape'])}, target expects {want_shape}")
        if np.dtype(rec["dtype"]) != leaf_dtype(leaf):
            raise ValueError(
                f"Checkpoint {path!r}: leaf '{rec['key']}' has dtype "
                f"{rec['dtype']}, target expects {leaf_dtype(leaf)}")
    return tree_unflatten(like, leaves), meta
