"""Checkpoint and resume (port of ``analytics_zoo_tpu.engine.checkpoint``).

A checkpoint is a tree of tensors and host ints (the Estimator's
``TrainState``, or ``(params, model_state)`` for ``save_weights``) stored
in the atomic directory format of :mod:`analytics_zoo_tpu_torch.ft.atomic`,
whose bytes are the JAX package's. ``load_checkpoint`` also reads the
legacy two-file ``ckpt_N.npz`` + ``ckpt_N.json`` layout, and
``latest_checkpoint`` considers both.

Leaves are keyed as the JAX package keys them (``common.tree.tree_paths``):
a ``TrainState`` writes ``.params/<layer>/<weight>``,
``.model_state/<layer>/<stat>``, ``.opt_state/...`` and ``.step`` (int32);
``(params, model_state)`` writes ``0/<layer>/<weight>`` and
``1/<layer>/<stat>``. ``.params``, ``.model_state`` and ``.step`` carry
the same keys in both packages. ``.opt_state`` follows each package's own
optimizer tree:

- Adam: optax's ``.opt_state/0/.mu/<leaf>``, ``.opt_state/0/.nu/<leaf>``
  and ``.opt_state/0/.count`` are the port's ``.opt_state/mu/<leaf>``,
  ``.opt_state/nu/<leaf>`` and ``.opt_state/count``.
- SGD: optax's ``.opt_state/0/.trace/<leaf>`` (momentum) is the port's
  ``.opt_state/trace/<leaf>``; optax keeps a count only for a schedule
  (``.opt_state/1/.count``), the port always (``.opt_state/count``).
- Gradient accumulation wraps either as the tuple (inner state,
  accumulator, f32 sample count, int32 micro-step) in both packages:
  ``.opt_state/0/<inner>``, ``.opt_state/1/<leaf>``, ``.opt_state/2``,
  ``.opt_state/3``.

Host ints (the step, the counts) are stored as int32, as optax stores
its counts. ``interop.load_jax_checkpoint`` carries a JAX checkpoint
over by this mapping.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import (
    tree_leaves,
    tree_paths,
    tree_unflatten,
)
from analytics_zoo_tpu_torch.ft import atomic


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf: never a view of a tensor or array that a
    later step, or the caller, may change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.array(leaf)


def flatten(tree: Any) -> List[Tuple[str, np.ndarray]]:
    """``[(key, host array), ...]`` in ``common.tree``'s leaf order,
    keyed as the module docstring says."""
    return [(k, _host(v)) for k, v in zip(tree_paths(tree),
                                          tree_leaves(tree))]


def _dir_path(path: str) -> str:
    """A caller's path (legacy callers append ``.npz``) as the checkpoint
    directory."""
    return re.sub(r"\.npz$", "", path)


def _manifest_path(path: str) -> str:
    return _dir_path(path) + ".json"


def save_checkpoint(path: str, tree: Any, metadata: Optional[Dict] = None,
                    overwrite: bool = True) -> str:
    """Write ``tree`` at ``path`` through the atomic commit protocol
    (staged ``<path>.tmp/``, fsync, rename, ``COMMIT``) and return the
    committed directory. A crash at any point leaves no readable
    half-checkpoint."""
    return atomic.commit_checkpoint(_dir_path(path), flatten(tree),
                                    metadata=metadata, overwrite=overwrite)


def _legacy_flat(path: str) -> Tuple[List[Tuple[str, np.ndarray]], Dict]:
    """The keys, arrays and metadata of a two-file checkpoint of the
    pre-atomic layout."""
    with open(_manifest_path(path)) as f:
        manifest = json.load(f)
    keys = manifest["keys"]
    with np.load(_dir_path(path) + ".npz") as npz:
        leaves = [npz[f"a{i}"] for i in range(len(keys))]
    return list(zip(keys, leaves)), manifest.get("metadata", {})


def _load_legacy(path: str, like: Any) -> Tuple[Any, Dict]:
    """Read a two-file checkpoint into ``like``'s structure."""
    flat, meta = _legacy_flat(path)
    keys = [k for k, _ in flat]
    leaves = [a for _, a in flat]
    like_leaves = tree_leaves(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(f"Checkpoint has {len(leaves)} leaves, target "
                         f"structure expects {len(like_leaves)}")
    for key, arr, leaf in zip(keys, leaves, like_leaves):
        want_shape = tuple(getattr(leaf, "shape", ()))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"Checkpoint {path!r}: leaf '{key}' has shape "
                f"{tuple(arr.shape)}, target expects {want_shape}")
        if arr.dtype != atomic.leaf_dtype(leaf):
            raise ValueError(
                f"Checkpoint {path!r}: leaf '{key}' has dtype {arr.dtype}, "
                f"target expects {atomic.leaf_dtype(leaf)}")
    return tree_unflatten(like, leaves), meta


def load_flat(path: str) -> Tuple[List[Tuple[str, np.ndarray]], Dict]:
    """``([(key, host array), ...], metadata)`` of a checkpoint in either
    layout (CRC32s verified in the atomic one), for callers that match
    leaves by key rather than by position."""
    target = _dir_path(path)
    if os.path.isdir(target):
        return atomic.read_checkpoint(target)
    return _legacy_flat(path)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore host arrays into the structure of ``like``, each leaf
    validated against ``like``'s shape and dtype (the error names the
    key); atomic-format checkpoints also verify their CRC32s
    (:class:`~analytics_zoo_tpu_torch.ft.atomic.CheckpointCorruptError`).
    Reads the atomic directory format and the legacy two-file pair."""
    target = _dir_path(path)
    if os.path.isdir(target):
        return atomic.read_checkpoint(target, like=like)
    return _load_legacy(path, like)


def peek_metadata(path: str) -> Dict:
    """The manifest metadata alone (no arrays), {} when unreadable."""
    target = _dir_path(path)
    if os.path.isdir(target):
        try:
            return atomic.read_manifest(target).get("metadata", {})
        except atomic.CheckpointError:
            return {}
    try:
        with open(_manifest_path(path)) as f:
            return json.load(f).get("metadata", {})
    except (OSError, ValueError):
        return {}


def committed_checkpoints(directory: str, prefix: str = "ckpt"
                          ) -> List[Tuple[int, str]]:
    """``[(step, path)]`` of restorable checkpoints under ``directory``,
    ascending: committed atomic directories and legacy pairs."""
    out = list(atomic.committed_checkpoints(directory, prefix))
    if os.path.isdir(directory):
        pat = re.compile(rf"{re.escape(prefix)}_(\d+)\.npz$")
        for fname in os.listdir(directory):
            m = pat.match(fname)
            if m:
                out.append((int(m.group(1)), os.path.join(directory, fname)))
    out.sort()
    return out


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> Optional[str]:
    """The highest-step restorable checkpoint under ``directory``, or
    None. An interrupted write, which never committed, does not count."""
    candidates = committed_checkpoints(directory, prefix)
    return candidates[-1][1] if candidates else None
