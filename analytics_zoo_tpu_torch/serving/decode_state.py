"""Host-side decode state for sequence serving: slots + prefill staging
(a copy of ``analytics_zoo_tpu.serving.decode_state``, which imports no
jax).

The continuous batcher (serving/sequence.py) runs one compiled decode
step over a fixed-capacity **slot array**; the device side of a slot is
a row in the preallocated carry pytree (recurrent h/c state — the
RNN-family equivalent of a transformer's KV cache block), replaced
functionally each step. Everything the device does NOT need lives here:

- :class:`SlotRecord` — per-slot host bookkeeping (the owning request,
  tokens generated so far, per-request eos / max_new_tokens / deadline).
- :class:`DecodeSlots` — the slot table: admit into free slots, evict on
  finish, fail-all on restart. Pure bookkeeping, no locking — the
  batcher's worker thread is the only writer, by the same
  single-flush-thread discipline ``DynamicBatcher`` uses.
- :class:`PrefillStaging` — a bounded pool of reusable host buffers for
  padding ragged prompts into (batch, length) grid cells, the dynamic
  batcher's staging-lease discipline applied to the 2-D prefill grid:
  checkout a ``(src, mask)`` pair, fill it, hand it to the prefill
  executable,
  release it once the admission scatter has consumed it. Bounded so a
  burst of admissions cannot grow host memory without limit; overflow
  releases simply drop the buffers.

Correctness note (why eviction is safe mid-grid): decode rows are
independent — the step function maps each slot's carry to its next
carry/token with no cross-slot reduction — so a dead slot computing
garbage on a stale carry perturbs nothing, and an evicted slot's row can
be overwritten by the next admission's scatter without quiescing the
others. tests/test_torch_text_models.py pins the underlying parity
primitive (step-by-step decode ≡ teacher-forced evaluation, bitwise on
tokens).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SlotRecord", "DecodeSlots", "PrefillStaging"]


class SlotRecord:
    """Host bookkeeping for one live decode slot."""

    __slots__ = ("request", "tokens", "max_new_tokens", "eos", "deadline",
                 "t_admit", "t_first_token")

    def __init__(self, request, max_new_tokens: int, eos: Optional[int],
                 deadline: Optional[float]):
        self.request = request
        self.tokens: List[int] = []
        self.max_new_tokens = max_new_tokens
        self.eos = eos
        self.deadline = deadline
        self.t_admit = time.monotonic()
        self.t_first_token: Optional[float] = None

    def append(self, tok: int) -> bool:
        """Record one generated token; True when the slot is finished
        (eos emitted — inclusive — or max_new_tokens reached)."""
        if self.t_first_token is None:
            self.t_first_token = time.monotonic()
        self.tokens.append(tok)
        if self.eos is not None and tok == self.eos:
            return True
        return len(self.tokens) >= self.max_new_tokens

    def result(self) -> np.ndarray:
        """The generated tokens so far as a 1-D int32 array — what the
        request's future resolves to on finish."""
        return np.asarray(self.tokens, dtype=np.int32)


class DecodeSlots:
    """Fixed-capacity slot table. Index ``i`` here is row ``i`` of the
    device carry pytree; ``capacity`` itself is the scatter drop-index
    for padded (dead) admission rows (the slot carries' sink row in the
    admission program)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"slot capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._slots: List[Optional[SlotRecord]] = [None] * self.capacity

    # -- queries ----------------------------------------------------------

    @property
    def live(self) -> int:
        """Occupied slot count."""
        return sum(1 for s in self._slots if s is not None)

    @property
    def free(self) -> int:
        """Empty slot count — how many requests the next admission wave
        can take."""
        return self.capacity - self.live

    def free_indices(self) -> List[int]:
        """Indices of empty slots, ascending — admission scatter targets."""
        return [i for i, s in enumerate(self._slots) if s is None]

    def live_items(self) -> List[Tuple[int, SlotRecord]]:
        """``(index, record)`` for every occupied slot, ascending."""
        return [(i, s) for i, s in enumerate(self._slots) if s is not None]

    def get(self, idx: int) -> Optional[SlotRecord]:
        """The record in slot ``idx``, or None when empty."""
        return self._slots[idx]

    # -- transitions ------------------------------------------------------

    def admit(self, idx: int, record: SlotRecord):
        """Occupy empty slot ``idx``; raises ``RuntimeError`` if it is
        already held (an admission bug, never a race — one writer)."""
        if self._slots[idx] is not None:
            raise RuntimeError(f"slot {idx} already occupied")
        self._slots[idx] = record

    def evict(self, idx: int) -> Optional[SlotRecord]:
        """Free slot ``idx``; returns its record, or None if the slot is
        already empty (a concurrent ``restart_worker`` drained the table
        between the worker's snapshot and this call — the caller skips,
        the record's future was already failed)."""
        rec = self._slots[idx]
        self._slots[idx] = None
        return rec

    def evict_all(self) -> List[Tuple[int, SlotRecord]]:
        """Drain every live slot (restart / step-fault path)."""
        out = self.live_items()
        self._slots = [None] * self.capacity
        return out


class PrefillStaging:
    """Bounded pool of reusable ``(src, mask)`` host buffer pairs, one
    pool per (batch, length) grid cell. ``src`` is int32, ``mask``
    float32 — the prefill executable's exact input shapes, so checkout →
    fill → dispatch never allocates on the steady-state path."""

    def __init__(self, cap_per_cell: int = 3):
        self._pools: Dict[Tuple[int, int], List[Tuple[np.ndarray,
                                                      np.ndarray]]] = {}
        self._cap = int(cap_per_cell)
        self._lock = threading.Lock()

    def checkout(self, batch: int, length: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        """Lease a ``(src, mask)`` buffer pair for one (batch, length)
        grid cell — pooled when available, freshly allocated otherwise.
        The caller must zero-fill before use (buffers return dirty)."""
        with self._lock:
            pool = self._pools.get((batch, length))
            if pool:
                return pool.pop()
        return (np.zeros((batch, length), dtype=np.int32),
                np.zeros((batch, length), dtype=np.float32))

    def release(self, lease: Tuple[np.ndarray, np.ndarray]):
        """Return a lease to its cell's pool (dropped when the pool is
        at ``cap_per_cell`` — the pool bounds memory, it is not a cache)."""
        src, _mask = lease
        cell = (src.shape[0], src.shape[1])
        with self._lock:
            pool = self._pools.setdefault(cell, [])
            if len(pool) < self._cap:
                pool.append(lease)
            # else: drop — the pool is a cap, not a cache
