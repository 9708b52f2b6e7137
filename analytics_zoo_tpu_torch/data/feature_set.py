"""FeatureSet (port of ``analytics_zoo_tpu.data.feature_set``: the batching
contract, ``ArrayFeatureSet`` and the device cache).

A dataset is host memory producing fixed-shape batches: the tail batch is
wrap-padded up to ``batch_size`` and carries a validity mask, training
shuffles each epoch with numpy from a per-epoch seed, and evaluation keeps
dataset order. The index batches are the JAX package's, element for
element, so both packages see the same batches.

``DeviceCachedFeatureSet`` holds the arrays on the card and gathers each
batch there from the host's index vector. It follows the JAX package's
*per-step* cached path (numpy shuffle order). The JAX package's fused epoch
dispatch draws its order in-graph with ``jax.random.permutation``, which
torch cannot reproduce; the port runs no fused epochs, so its cached runs
keep the numpy order. Streaming pipelines, multi-host windows, mid-epoch
resume offsets, device transforms and the row-sharded cache are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

ArrayLike = Union[np.ndarray, Sequence[np.ndarray]]


def _as_arrays(x) -> List[np.ndarray]:
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


class FeatureSet:
    """Base interface: index batches for training and evaluation over a
    dataset that subclasses index with :meth:`take`."""

    @property
    def num_samples(self) -> int:
        """Number of samples in the dataset."""
        raise NotImplementedError

    def take(self, indices: np.ndarray) -> Tuple[Any, Any]:
        """Gather (x, y) for integer indices; x may be a list of arrays."""
        raise NotImplementedError

    def steps_per_epoch(self, batch_size: int) -> int:
        """How many batches one epoch yields."""
        return -(-self.num_samples // batch_size)

    def train_index_batches(self, batch_size: int, shuffle: bool = True,
                            seed: int = 0
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (indices, mask) per training batch. The tail batch is
        wrap-padded (modulo) to the batch size; the mask zero-weights the
        duplicates."""
        n = self.num_samples
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        full_mask = np.ones(batch_size, dtype=np.float32)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            valid = len(idx)
            mask = full_mask
            if valid < batch_size:
                idx = np.concatenate(
                    [idx, order[np.arange(batch_size - valid) % n]])
                mask = np.zeros(batch_size, dtype=np.float32)
                mask[:valid] = 1.0
            yield idx, mask

    def eval_index_batches(self, batch_size: int
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Dataset-order (indices, mask) with wrap-padding masked out."""
        n = self.num_samples
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            valid = len(idx)
            if valid < batch_size:
                idx = np.concatenate([idx, np.arange(batch_size - valid) % n])
            mask = np.zeros(batch_size, dtype=np.float32)
            mask[:valid] = 1.0
            yield idx, mask

    def train_batches(self, batch_size: int, shuffle: bool = True,
                      seed: int = 0
                      ) -> Iterator[Tuple[Any, Any, np.ndarray]]:
        """Training batches (x, y, mask) on the host."""
        for idx, mask in self.train_index_batches(batch_size, shuffle, seed):
            x, y = self.take(idx)
            yield x, y, mask

    def eval_batches(self, batch_size: int
                     ) -> Iterator[Tuple[Any, Any, np.ndarray]]:
        """Dataset-order (x, y, mask) with wrap-padding masked out."""
        for idx, mask in self.eval_index_batches(batch_size):
            x, y = self.take(idx)
            yield x, y, mask


class ArrayFeatureSet(FeatureSet):
    """In-memory ndarray-backed dataset. ``x`` may be one array or a list
    (multi-input models); ``y`` may be None for prediction-only sets."""

    def __init__(self, x: ArrayLike, y: Optional[ArrayLike] = None):
        self.xs = _as_arrays(x)
        self._multi_x = isinstance(x, (list, tuple))
        self.ys = _as_arrays(y) if y is not None else None
        self._multi_y = isinstance(y, (list, tuple)) if y is not None else False
        n = len(self.xs[0])
        for a in self.xs + (self.ys or []):
            if len(a) != n:
                raise ValueError("All arrays must share dim 0 "
                                 f"({len(a)} vs {n})")

    @property
    def num_samples(self) -> int:
        return len(self.xs[0])

    def _pack(self, xs, ys):
        x = xs if self._multi_x else xs[0]
        if ys is None:
            return x, None
        return x, (ys if self._multi_y else ys[0])

    def take(self, indices: np.ndarray):
        return self._pack([a[indices] for a in self.xs],
                          None if self.ys is None
                          else [a[indices] for a in self.ys])

    def cache_device(self) -> "DeviceCachedFeatureSet":
        """The dataset held on the context's device, batches gathered
        there: see :class:`DeviceCachedFeatureSet`."""
        return DeviceCachedFeatureSet(
            self.xs if self._multi_x else self.xs[0],
            None if self.ys is None else
            (self.ys if self._multi_y else self.ys[0]))


class DeviceCachedFeatureSet(ArrayFeatureSet):
    """Dataset held in the context device's memory; each batch is gathered
    on the device from an index vector, so only the indices cross the host
    link per step. The host arrays stay too (evaluation and prediction
    order)."""

    def __init__(self, x: ArrayLike, y: Optional[ArrayLike] = None):
        super().__init__(x, y)
        device = get_nncontext().device
        # torch.tensor copies: the cache never aliases the caller's arrays
        self.device_xs = [torch.tensor(a, device=device) for a in self.xs]
        self.device_ys = (None if self.ys is None else
                          [torch.tensor(a, device=device) for a in self.ys])

    def gather(self, idx: torch.Tensor):
        """(x, y) of the rows ``idx`` (a device index tensor), on the
        device."""
        return self._pack(
            [a.index_select(0, idx) for a in self.device_xs],
            None if self.device_ys is None
            else [a.index_select(0, idx) for a in self.device_ys])
