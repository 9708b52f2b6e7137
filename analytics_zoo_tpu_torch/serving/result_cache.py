"""Content-addressed inference result cache with single-flight coalescing.

Heavy real-world serving traffic is repetitive — hot keys, retry storms,
fan-in from upstream services — yet without a cache every request pays
queue wait, batch assembly and a device execution. The expensive artifact
is the compiled device execution (the same economics that motivate the
per-bucket executable cache), so never run it twice for the same bytes:

- **Content-addressed keys.** SHA-256 over ``(model name, resolved
  version, canonical input bytes)``. Canonical means *after* signature
  dtype coercion: a JSON int payload and its float32 twin hash to the
  same key, exactly as they land in the same bucket executable. The
  version in the key is the one the Router resolved, so sticky keys,
  canary weights and rollout repoints all key distinctly — and
  invalidation is just "drop this version's keys".

- **LRU + TTL + byte budget.** Entries age out after ``ttl_s``, the
  least-recently-used entry is evicted beyond ``max_entries``, and
  ``max_bytes`` bounds resident result bytes (see docs/known-issues.md on
  why the byte budget, not the entry count, is the limit to tune).

- **Single-flight coalescing.** Concurrent identical requests attach to
  one leader future; one device execution resolves the whole flight. The
  leader's failure fails every follower with the same exception — errors
  are never cached, so the next request retries for real.

- **Immutable entries, copy-on-write views.** The cache stores one
  read-only master per key and hands every hit a zero-copy
  :class:`CowView` of it. Reads share the master's memory (the zero-copy
  npy path: ``np.save`` streams straight from the cache). The first
  write triggers a private copy: in-place operators (``out += b`` etc.)
  transparently materialize and rebind a private writable array, and
  item assignment (``out[0] = v`` — which Python cannot rebind) raises
  ``ValueError`` pointing at ``.copy()`` instead of silently corrupting
  the shared master. Mutation-safety tests mirror the batcher's
  staging-buffer discipline: nothing a caller does to a hit can
  change what the next hit sees.

What is deliberately NOT cached: errors (single-flight fails the flight
and forgets the key), shadow-mirror results (discarded by design),
explicit-version requests (``/versions/<v>:predict`` bypasses routing,
so it bypasses the cache too) and per-request opt-outs
(``Cache-Control: no-cache``). See docs/result-cache.md.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.tree import tree_map

__all__ = ["CowView", "ResultCache", "ResultCacheConfig", "cow_view",
           "tree_readonly_copy", "tree_cow_view", "tree_nbytes"]


@dataclass
class ResultCacheConfig:
    """Tuning knobs for :class:`ResultCache`.

    ``max_entries``: LRU capacity in entries. ``max_bytes``: byte budget
    over the cached result arrays (the binding limit in practice —
    entry sizes vary with batch rows, see docs/known-issues.md).
    ``ttl_s``: seconds an entry stays valid; ``None`` disables
    expiry. ``coalesce``: attach concurrent identical requests to one
    in-flight leader (single-flight); off, every miss executes.
    """

    max_entries: int = 4096
    max_bytes: int = 256 << 20
    ttl_s: Optional[float] = 60.0
    coalesce: bool = True

    def __post_init__(self):
        if self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if self.max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        if self.ttl_s is not None and self.ttl_s <= 0:
            raise ValueError("ttl_s must be positive (or None to disable)")


class CowView(np.ndarray):
    """A zero-copy, read-only view of a cached master array with
    copy-on-write semantics.

    Reads share the master's buffer — serving a hit allocates nothing,
    and ``np.save`` / ``.tolist()`` stream directly from the cache. The
    first *write* triggers a private copy instead of touching shared
    memory:

    - in-place operators (``v += 1``, ``v *= 2``, ...) materialize a
      private writable copy and rebind the caller's name to it (Python's
      augmented assignment uses the returned object, which makes the
      copy transparent);
    - item assignment (``v[0] = x``) cannot rebind the caller's name, so
      it raises ``ValueError`` naming ``.copy()`` — loudly, before the
      shared master could be corrupted.

    ``.copy()`` / ``np.array(v)`` return plain private ndarrays.
    """

    def __array_finalize__(self, obj):
        # views of a CowView stay CowViews; they inherit writeable=False
        # from the base, so the protection survives slicing
        pass

    def __setitem__(self, key, value):
        raise ValueError(
            "this array is a copy-on-write view of a cached serving "
            "result; item assignment cannot rebind your reference — "
            "take a private copy first (arr = arr.copy())")

    # Augmented assignment CAN rebind (x += 1 uses the return value), so
    # these genuinely copy-on-write: materialize private, apply, return.
    def _cow_private(self) -> np.ndarray:
        return np.array(self, dtype=self.dtype, copy=True)

    def __iadd__(self, other):
        return self._cow_private().__iadd__(other)

    def __isub__(self, other):
        return self._cow_private().__isub__(other)

    def __imul__(self, other):
        return self._cow_private().__imul__(other)

    def __itruediv__(self, other):
        return self._cow_private().__itruediv__(other)

    def __ifloordiv__(self, other):
        return self._cow_private().__ifloordiv__(other)

    def __imod__(self, other):
        return self._cow_private().__imod__(other)

    def __ipow__(self, other):
        return self._cow_private().__ipow__(other)

    def __iand__(self, other):
        return self._cow_private().__iand__(other)

    def __ior__(self, other):
        return self._cow_private().__ior__(other)

    def __ixor__(self, other):
        return self._cow_private().__ixor__(other)

    def __ilshift__(self, other):
        return self._cow_private().__ilshift__(other)

    def __irshift__(self, other):
        return self._cow_private().__irshift__(other)

    def copy(self, order="C"):
        """A plain, private, writable ndarray (drops the CowView type)."""
        return np.array(np.asarray(self), order=order, copy=True)


def cow_view(master: np.ndarray) -> CowView:
    """A :class:`CowView` over ``master`` — zero-copy, non-writable."""
    v = master.view(CowView)
    v.flags.writeable = False
    return v


def _tree_map(fn: Callable[[Any], Any], tree):
    return tree_map(fn, tree)


def _is_plain_array_tree(tree) -> bool:
    return isinstance(tree, np.ndarray)


def tree_readonly_copy(tree):
    """Private read-only copy of every numpy leaf — the immutable master
    stored in the cache (taken before the leader's caller could mutate
    its result)."""
    def _leaf(a):
        if isinstance(a, np.ndarray):
            m = np.array(a, copy=True)
            m.flags.writeable = False
            return m
        return a

    if _is_plain_array_tree(tree):
        return _leaf(tree)
    return _tree_map(_leaf, tree)


def tree_cow_view(tree):
    """Zero-copy :class:`CowView` handout of a cached master tree."""
    def _leaf(a):
        return cow_view(a) if isinstance(a, np.ndarray) else a

    if _is_plain_array_tree(tree):
        return _leaf(tree)
    return _tree_map(_leaf, tree)


def tree_nbytes(tree) -> int:
    """Total bytes across numpy leaves (the ``max_bytes`` accounting)."""
    total = [0]

    def _leaf(a):
        if isinstance(a, np.ndarray):
            total[0] += a.nbytes
        return a

    if _is_plain_array_tree(tree):
        _leaf(tree)
    else:
        _tree_map(_leaf, tree)
    return total[0]


class _Entry:
    __slots__ = ("master", "nbytes", "model", "version", "expires_at")

    def __init__(self, master, nbytes, model, version, expires_at):
        self.master = master
        self.nbytes = nbytes
        self.model = model
        self.version = version
        self.expires_at = expires_at    # monotonic seconds or None


class _Flight:
    """One in-flight leader execution and the followers coalesced onto
    it. Followers' futures resolve from the leader's cached result (each
    gets its own zero-copy CowView) or fail with the leader's exception."""

    __slots__ = ("followers",)

    def __init__(self):
        self.followers: List[Future] = []


class ResultCache:
    """The LRU+TTL content-addressed result cache (see module docstring).

    Thread-safe. Counters (``hits``/``misses``/``coalesced``/
    ``evictions``) and gauges (``bytes``/``entries``) are plain ints
    read by the engine's metric adapters; ``clock`` is injectable for
    deterministic TTL tests.
    """

    def __init__(self, config: Optional[ResultCacheConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or ResultCacheConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._flights: Dict[str, _Flight] = {}
        # (model, version) -> set of keys: invalidation rides the control
        # plane (unregister/rollback/hot-reload retirement drops a
        # version's keys without scanning the LRU)
        self._version_keys: Dict[Tuple[str, str], set] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.evictions = 0
        self.invalidations = 0
        self.peer_hits = 0
        self.peer_misses = 0
        #: Cooperative-cache hook (fleet fabric): an object with a
        #: ``fetch(key) -> Optional[tree]`` method (usually a
        #: :class:`~analytics_zoo_tpu_torch.serving.fabric.coopcache
        #: .PeerCacheClient`). ``None`` keeps the cache purely local.
        self.peer_client = None

    # -- keying -----------------------------------------------------------

    @staticmethod
    def key(model: str, version: str, xs: List[np.ndarray]) -> str:
        """SHA-256 over (model, resolved version, canonical input bytes).

        ``xs`` must be the signature-coerced per-input arrays (what the
        batcher would actually batch) so payloads that execute
        identically hash identically. Shape and dtype are part of the
        hash — a (2, 8) float32 request can never collide with a
        (16,) float32 one of equal bytes.
        """
        h = hashlib.sha256()
        h.update(model.encode())
        h.update(b"\x00")
        h.update(version.encode())
        for a in xs:
            h.update(b"\x00")
            h.update(str(a.dtype).encode())
            h.update(repr(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    # -- read path --------------------------------------------------------

    def get(self, key: str):
        """The cached result for ``key`` as a zero-copy CowView tree, or
        ``None``. Touches LRU recency; drops the entry if its TTL
        expired."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if e.expires_at is not None and self._clock() >= e.expires_at:
                self._drop_locked(key, "ttl")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            master = e.master
        return tree_cow_view(master)

    def peek(self, key: str):
        """The raw master tree for ``key``, or ``None`` — *without*
        counting a hit or touching LRU recency.

        The read used to *serve a peer's* cooperative-cache lookup
        (``GET /v1/cache/<key>``): another host asking "do you have
        this?" must not distort this host's hit-rate metrics or keep an
        otherwise-cold entry artificially warm. TTL still applies (an
        expired entry is dropped, not exported). The returned masters
        are read-only; callers serialize, never mutate."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            if e.expires_at is not None and self._clock() >= e.expires_at:
                self._drop_locked(key, "ttl")
                return None
            return e.master

    def peer_fetch(self, key: str):
        """Ask the fleet for ``key`` via :attr:`peer_client`.

        Returns the fetched result tree or ``None`` (no client, peer
        miss, or any transport/codec failure — the cooperative layer is
        strictly best-effort: a broken peer must never fail a request
        that a local execution can serve). Counts into ``peer_hits`` /
        ``peer_misses``."""
        client = self.peer_client
        if client is None:
            return None
        try:
            fetched = client.fetch(key)
        except Exception:   # noqa: BLE001 — best-effort by contract
            fetched = None
        if fetched is None:
            self.peer_misses += 1
        else:
            self.peer_hits += 1
        return fetched

    def begin_flight(self, key: str) -> Tuple[bool, Optional[Future]]:
        """Single-flight admission for a miss on ``key``.

        Returns ``(True, None)`` for the leader — the caller must
        execute and settle the flight via :meth:`complete_flight` /
        :meth:`fail_flight`. Returns ``(False, future)`` for a follower:
        the future resolves to a CowView of the leader's result, or
        fails with the leader's exception. With ``coalesce`` off, every
        caller is a leader.
        """
        with self._lock:
            if self.config.coalesce:
                fl = self._flights.get(key)
                if fl is not None:
                    fut: Future = Future()
                    fl.followers.append(fut)
                    self.coalesced += 1
                    return False, fut
                self._flights[key] = _Flight()
            self.misses += 1
            return True, None

    # -- write path -------------------------------------------------------

    def complete_flight(self, key: str, model: str, version: str, result):
        """Leader success: store an immutable master (a private read-only
        copy, taken before the leader's caller can mutate its own result)
        and resolve every follower with a zero-copy view of it."""
        master = tree_readonly_copy(result)
        nbytes = tree_nbytes(master)
        with self._lock:
            fl = self._flights.pop(key, None)
            followers = fl.followers if fl is not None else []
            self._put_locked(key, master, nbytes, model, version)
        for fut in followers:
            try:
                fut.set_result(tree_cow_view(master))
            except Exception:  # noqa: BLE001 — follower cancelled
                pass

    def fail_flight(self, key: str, exc: BaseException):
        """Leader failure: the whole flight fails with the leader's
        exception and nothing is cached (the next request retries for
        real)."""
        with self._lock:
            fl = self._flights.pop(key, None)
            followers = fl.followers if fl is not None else []
        for fut in followers:
            try:
                fut.set_exception(exc)
            except Exception:  # noqa: BLE001 — follower cancelled
                pass

    def _put_locked(self, key: str, master, nbytes: int, model: str,
                    version: str):
        if nbytes > self.config.max_bytes:
            return      # larger than the whole budget: never cacheable
        if key in self._entries:
            self._drop_locked(key, "replaced", count=False)
        ttl = self.config.ttl_s
        e = _Entry(master, nbytes, model, version,
                   None if ttl is None else self._clock() + ttl)
        self._entries[key] = e
        self._version_keys.setdefault((model, version), set()).add(key)
        self.bytes += nbytes
        while (len(self._entries) > self.config.max_entries
               or self.bytes > self.config.max_bytes):
            oldest = next(iter(self._entries))
            self._drop_locked(oldest, "lru")

    def _drop_locked(self, key: str, reason: str, count: bool = True):
        e = self._entries.pop(key, None)
        if e is None:
            return
        self.bytes -= e.nbytes
        ks = self._version_keys.get((e.model, e.version))
        if ks is not None:
            ks.discard(key)
            if not ks:
                self._version_keys.pop((e.model, e.version), None)
        if count:
            self.evictions += 1

    # -- invalidation (rides the control plane) ---------------------------

    def invalidate_version(self, model: str, version: str) -> int:
        """Drop every entry keyed to ``(model, version)`` — called from
        ``ServingEngine.unregister``, the single choke point all
        retirement paths (hot-reload trim, rollout rollback/finalize,
        manual unregister) funnel through. Returns entries dropped."""
        with self._lock:
            keys = list(self._version_keys.get((model, version), ()))
            for k in keys:
                self._drop_locked(k, "retired", count=False)
            self.invalidations += len(keys)
            return len(keys)

    def invalidate_model(self, model: str) -> int:
        """Drop every entry for every version of ``model``."""
        with self._lock:
            keys = [k for (m, _v), ks in list(self._version_keys.items())
                    if m == model for k in list(ks)]
            for k in keys:
                self._drop_locked(k, "retired", count=False)
            self.invalidations += len(keys)
            return len(keys)

    def clear(self):
        """Drop everything (in-flight leaders settle normally but their
        results re-enter an empty cache)."""
        with self._lock:
            for k in list(self._entries):
                self._drop_locked(k, "cleared", count=False)

    # -- introspection ----------------------------------------------------

    @property
    def entries(self) -> int:
        """Resident entry count."""
        return len(self._entries)

    def stats(self) -> Dict[str, float]:
        """Flat counters/gauges for ``/healthz`` and bench records."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "coalesced": self.coalesced,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "entries": len(self._entries),
                "bytes": self.bytes,
                "peer_hits": self.peer_hits,
                "peer_misses": self.peer_misses,
            }
