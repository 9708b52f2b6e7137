"""Static host values of an imported graph, placed on a device once.

The ONNX and TensorFlow importers keep a graph's constants and its shape
chains as host arrays: a value is *static* when it is a numpy array or a Python number, so no shape
op synchronises with the card. A static value that meets a tensor is made
a tensor on that tensor's device the first time (by a bucket's eager
warm-up, before any CUDA graph capture) and kept in its model's
:class:`ConstCache`; nothing is uploaded again at a later call, since a
pageable host-to-device copy inside a capture would be a fault.

A forward runs under :func:`running`, which names its device and cache for
the thread (two threads may run two models at once); :func:`as_tensor`
reads them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_ACTIVE = threading.local()


def placed(arr: np.ndarray, device, transform: Optional[Callable] = None,
           fmt: Optional[torch.memory_format] = None) -> torch.Tensor:
    """A host array as a new tensor on ``device`` (float64 made float32,
    as the JAX package's x64-off arrays), after ``transform`` (numpy), in
    memory format ``fmt``; made outside inference mode so that a
    fine-tuning forward may save it for backward. On the meta device only
    its shape and dtype."""
    arr = np.asarray(arr)
    if transform is not None:
        arr = transform(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    dev = torch.device(device)
    with torch.inference_mode(False):
        if dev.type == "meta":
            dt = torch.from_numpy(np.zeros(0, arr.dtype)).dtype
            return torch.empty(arr.shape, dtype=dt, device=dev)
        out = torch.tensor(arr, device=dev)
        if fmt is not None:
            out = out.contiguous(memory_format=fmt)
        return out


class ConstCache:
    """One model's static values on its devices, each made once.

    ``named`` maps a graph's constant names to its host arrays: those are
    kept by name (the very array object is looked up), any other static
    value (a folded shape chain's, a small derived array) by its bytes.
    Entries are per device, ``transform`` (a numpy layout function) and
    memory format."""

    def __init__(self, named: Optional[Dict[str, np.ndarray]] = None):
        self._named = dict(named or {})
        self._ids = {id(v): k for k, v in self._named.items()}
        self._placed: Dict[Tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    def place(self, x, device, transform: Optional[Callable] = None,
              fmt: Optional[torch.memory_format] = None) -> torch.Tensor:
        """``x`` (static) as a tensor on ``device``, made once."""
        name = self._ids.get(id(x))
        if name is not None and self._named[name] is x:
            key = (str(device), "name", name, transform, fmt)
        else:
            arr = np.asarray(x)
            key = (str(device), "bytes", arr.dtype.str, arr.shape,
                   arr.tobytes(), transform, fmt)
        out = self._placed.get(key)
        if out is None:
            with self._lock:
                out = self._placed.get(key)
                if out is None:
                    out = placed(x, device, transform, fmt)
                    self._placed[key] = out
        return out

    def named_items(self) -> Iterator[Tuple[str, Optional[Callable],
                                            Optional[torch.memory_format],
                                            torch.Tensor]]:
        """``(name, transform, fmt, tensor)`` of every named constant
        placed so far."""
        for key, t in list(self._placed.items()):
            if key[1] == "name":
                yield key[2], key[3], key[4], t

    def __len__(self) -> int:
        return len(self._placed)


@contextlib.contextmanager
def running(device: torch.device, cache: Optional[ConstCache]):
    """The running forward's device and constant cache, for the block, on
    this thread."""
    prev = (getattr(_ACTIVE, "device", None), getattr(_ACTIVE, "cache", None))
    _ACTIVE.device, _ACTIVE.cache = device, cache
    try:
        yield
    finally:
        _ACTIVE.device, _ACTIVE.cache = prev


def as_tensor(x, device=None, transform: Optional[Callable] = None,
              fmt: Optional[torch.memory_format] = None) -> torch.Tensor:
    """``x`` as a tensor: tensors as they are; a static value on
    ``device``, else the running forward's (the CPU outside one), through
    the running forward's cache."""
    if isinstance(x, torch.Tensor):
        return x
    dev = (device or getattr(_ACTIVE, "device", None)
           or torch.device("cpu"))
    cache = getattr(_ACTIVE, "cache", None)
    if cache is None:
        return placed(x, dev, transform, fmt)
    return cache.place(x, dev, transform, fmt)
