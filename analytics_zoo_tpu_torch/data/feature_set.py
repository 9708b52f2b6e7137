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
keep the numpy order. A set's ``device_transform`` (carried into its
device cache) is a per-batch function the Estimator applies to ``x`` on the
device: uint8 pixels cross to and stay on the card as uint8 and are
normalised per batch there. Float64 arrays reach the device as float32,
as in the JAX package. A resumed epoch skips its first batches in the
Estimator.

``PairFeatureSet`` holds (positive, negative) rows interleaved for
RankHinge and shuffles, pads and masks whole pairs; ``TransformedFeatureSet``
applies a per-batch function to each host batch (``FeatureSet.transform``
or ``>>``). ``batches`` and the pair set's ``train_batches`` take the JAX
package's multi-host ``window``; streaming pipelines and the row-sharded
cache are not ported yet.
"""

from __future__ import annotations

from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.nncontext import (
    get_nncontext,
    host_to_device,
)

ArrayLike = Union[np.ndarray, Sequence[np.ndarray]]


def _as_arrays(x) -> List[np.ndarray]:
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


class FeatureSet:
    """Base interface: index batches for training and evaluation over a
    dataset that subclasses index with :meth:`take`.

    ``device_transform`` (optional): a per-batch function of ``x`` that the
    Estimator applies on the device, inside its train, evaluate and predict
    steps, before the compute-dtype cast.
    """

    device_transform = None

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

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_remainder: bool = False,
                window: Optional[Tuple[int, int]] = None,
                start_step: int = 0) -> Iterator[Tuple[Any, Any]]:
        """(x, y) batches with no mask: the tail wrap-padded (modulo, so a
        tiny dataset still fills a batch) or dropped. ``window=(lo, hi)``
        keeps only those rows of each batch (the JAX package's multi-host
        contract); ``start_step`` skips the first batches without taking
        them."""
        n = self.num_samples
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(start_step * batch_size, n, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size:
                if drop_remainder or len(idx) == 0:
                    return
                pad = order[np.arange(batch_size - len(idx)) % n]
                idx = np.concatenate([idx, pad])
            if window is not None:
                idx = idx[window[0]:window[1]]
            yield self.take(idx)

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

    def transform(self, fn: Callable) -> "TransformedFeatureSet":
        """Chain a per-batch ``fn(x, y) -> (x, y)`` (ref Preprocessing
        ``->`` chaining)."""
        return TransformedFeatureSet(self, fn)

    __rshift__ = transform


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

    @staticmethod
    def from_ndarrays(x, y=None) -> "ArrayFeatureSet":
        """Build from (x, y) ndarrays or lists of ndarrays."""
        return ArrayFeatureSet(x, y)

    def cache_device(self) -> "DeviceCachedFeatureSet":
        """The dataset held on the context's device, batches gathered
        there: see :class:`DeviceCachedFeatureSet`."""
        fs = DeviceCachedFeatureSet(
            self.xs if self._multi_x else self.xs[0],
            None if self.ys is None else
            (self.ys if self._multi_y else self.ys[0]))
        fs.device_transform = self.device_transform
        return fs


class DeviceCachedFeatureSet(ArrayFeatureSet):
    """Dataset held in the context device's memory; each batch is gathered
    on the device from an index vector, so only the indices cross the host
    link per step. The host arrays stay too (evaluation and prediction
    order)."""

    def __init__(self, x: ArrayLike, y: Optional[ArrayLike] = None):
        super().__init__(x, y)
        device = get_nncontext().device
        # copies (the cache never aliases the caller's arrays), float64
        # made float32
        self.device_xs = [host_to_device(a, device) for a in self.xs]
        self.device_ys = (None if self.ys is None else
                          [host_to_device(a, device) for a in self.ys])

    def gather(self, idx: torch.Tensor):
        """(x, y) of the rows ``idx`` (a device index tensor), on the
        device."""
        return self._pack(
            [a.index_select(0, idx) for a in self.device_xs],
            None if self.device_ys is None
            else [a.index_select(0, idx) for a in self.device_ys])


class PairFeatureSet(ArrayFeatureSet):
    """Pairwise-ranking dataset: rows are (pos, neg) interleaved, even index
    positive and odd negative, as ``Relations.generate_relation_pairs``
    makes them (ref feature/common/Relations.scala:92, read by RankHinge).

    Shuffling and batching work on PAIR units, so the interleaving that
    RankHinge depends on survives (the reference packs both members into
    one Sample, TextSet.scala:398): one ``np.random.default_rng(seed)``
    permutation of the pairs, the tail padded by whole pairs.
    """

    def __init__(self, x, y=None):
        super().__init__(x, y)
        if self.num_samples % 2 != 0:
            raise ValueError("PairFeatureSet needs an even number of rows "
                             "(pos, neg interleaved)")

    @staticmethod
    def _check_window(window):
        """A process window must respect the (pos, neg) interleaving: both
        bounds even, so no pair is split across processes."""
        if window is not None and (window[0] % 2 or window[1] % 2):
            raise ValueError(
                f"PairFeatureSet process window {window} splits a (pos, neg) "
                "pair; use an even per-process batch share")
        return window

    def _pair_order(self, batch_size: int, shuffle: bool, seed: int,
                    window):
        if batch_size % 2 != 0:
            raise ValueError("batch_size must be even for pair batches")
        self._check_window(window)
        order = np.arange(self.num_samples // 2)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        return order, batch_size // 2

    @staticmethod
    def _rows(p):
        idx = np.empty(2 * len(p), dtype=np.int64)
        idx[0::2], idx[1::2] = 2 * p, 2 * p + 1
        return idx

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = False, window=None):
        order, per_batch = self._pair_order(batch_size, shuffle, seed,
                                            window)
        pairs = len(order)
        for start in range(0, pairs, per_batch):
            p = order[start:start + per_batch]
            if len(p) < per_batch:
                if drop_remainder or len(p) == 0:
                    return
                p = np.concatenate(
                    [p, order[np.arange(per_batch - len(p)) % pairs]])
            idx = self._rows(p)
            if window is not None:
                idx = idx[window[0]:window[1]]
            yield self.take(idx)

    def cache_device(self):
        raise NotImplementedError(
            "PairFeatureSet cannot be device-cached: the engine's index-batch "
            "gather path shuffles single rows, which would destroy the "
            "(pos, neg) interleaving RankHinge depends on")

    def train_batches(self, batch_size: int, shuffle: bool = True,
                      seed: int = 0, window=None):
        """Pair-unit masking: a padded pair masks BOTH interleaved members,
        the per-pair loss convention (``rank_hinge``'s per-sample form)."""
        order, per_batch = self._pair_order(batch_size, shuffle, seed,
                                            window)
        pairs = len(order)
        for start in range(0, pairs, per_batch):
            p = order[start:start + per_batch]
            valid = len(p)
            if valid == 0:
                return
            mask = np.ones(batch_size, dtype=np.float32)
            if valid < per_batch:
                p = np.concatenate(
                    [p, order[np.arange(per_batch - valid) % pairs]])
                mask[2 * valid:] = 0.0
            idx = self._rows(p)
            if window is not None:
                idx, mask = (idx[window[0]:window[1]],
                             mask[window[0]:window[1]])
            x, y = self.take(idx)
            yield x, y, mask


class TransformedFeatureSet(FeatureSet):
    """Lazily applies a per-batch ``fn(x, y) -> (x, y)`` to the base set's
    host batches (ref Preprocessing chain)."""

    def __init__(self, base: FeatureSet, fn: Callable):
        self.base = base
        self.fn = fn
        self.device_transform = base.device_transform

    @property
    def num_samples(self) -> int:
        return self.base.num_samples

    def take(self, indices: np.ndarray):
        return self.fn(*self.base.take(indices))
