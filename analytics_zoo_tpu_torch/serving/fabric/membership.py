"""Shared cluster membership, the fleet's one view of who is serving
(port of ``analytics_zoo_tpu.serving.fabric.membership``).

Every front door in the fleet heartbeats into a shared ``fleet_dir``
(any filesystem all hosts can reach): one JSON
record per host under ``hosts/``, written atomically (temp file +
``os.replace``, so readers never observe a torn record), carrying a
monotonically increasing ``beat`` counter. Liveness is *beat progress*,
not file freshness: a reader tracks when each host's beat last changed
and declares the host dead once it has been flat for ``stale_after``
heartbeat intervals. That makes the protocol clock-skew-proof — no
cross-host timestamp is ever compared, exactly like the token-bucket
snapshot rule in ``quota.py``.

**Epochs.** The view is epoch-numbered: a shared ``epoch`` file is
bumped (max-plus-one, last-writer-wins — both racers observed the same
transition, so equal results are fine) every time any observer sees the
*live set* change. Doors stamp outbound fleet control traffic with
their epoch and reject inbound control traffic carrying an older one,
so a host that was partitioned away (its own heartbeats failing, its
view frozen) can never push decisions based on a stale picture onto
healthy peers. The partitioned host also self-detects: ``self_ok``
turns false when its own heartbeat writes fail or stop landing, and the
door degrades to local-only serving until the fabric heals (see
the fleet door).

**Suspicion.** Failure detection through beats alone takes
``stale_after × heartbeat_interval_s``; the data plane cannot wait that
long. :meth:`Membership.suspect` marks a host dead *immediately* (the
door calls it the moment a forward fails at transport level), and the
suspicion clears automatically when the host's beat advances again —
the same probe-then-trust shape as the front door's worker health
loop.

The clock is injectable and :meth:`beat_once` / :meth:`poll` are
manual, so unit tests drive the whole protocol deterministically with
no threads and no sleeps; :meth:`start` runs the production heartbeat
thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

__all__ = ["ClusterView", "HostRecord", "Membership"]


@dataclass(frozen=True)
class HostRecord:
    """One host's heartbeat record as read back from the fleet dir."""

    host_id: str
    url: str
    pid: int
    beat: int


@dataclass(frozen=True)
class ClusterView:
    """An epoch-numbered snapshot of the cluster.

    ``hosts`` is the *roster* — every host with a record on disk, dead
    or alive (routing partitions over the roster so that live keys keep
    their intervals when a host dies; see :func:`door.fleet_pick`).
    ``live`` is the sorted subset whose beats are progressing and that
    are not currently suspected. ``self_ok`` is false when the observer
    itself cannot sustain heartbeats — a door holding such a view must
    not forward (it may be the partitioned one)."""

    epoch: int
    hosts: Dict[str, HostRecord]
    live: Tuple[str, ...]
    self_ok: bool

    @property
    def roster(self) -> Tuple[str, ...]:
        """Sorted ids of every host on disk — the stable routing
        domain."""
        return tuple(sorted(self.hosts))

    def is_live(self, host_id: str) -> bool:
        """Whether ``host_id`` is in the live set of this view."""
        return host_id in self.live


class Membership:
    """One host's membership agent: heartbeat writer + view reader.

    See the module docstring for the protocol. ``fleet_dir`` is the
    shared rendezvous directory; ``host_id`` must be unique per door;
    ``url`` is this door's advertised base URL (what peers dial).
    ``stale_after`` is the number of flat heartbeat intervals after
    which a host is declared dead."""

    def __init__(self, fleet_dir: str, host_id: str, url: str, *,
                 heartbeat_interval_s: float = 0.2, stale_after: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if stale_after < 1:
            raise ValueError("stale_after must be >= 1")
        if heartbeat_interval_s <= 0:
            raise ValueError("heartbeat_interval_s must be positive")
        self.fleet_dir = fleet_dir
        self.host_id = host_id
        self.url = url
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.stale_after = int(stale_after)
        self._clock = clock
        self._hosts_dir = os.path.join(fleet_dir, "hosts")
        self._epoch_path = os.path.join(fleet_dir, "epoch")
        self._lock = threading.Lock()
        self._beat = 0
        self._epoch = 0
        # host -> (last observed beat, clock time the beat last changed)
        self._seen: Dict[str, Tuple[int, float]] = {}
        # host -> the beat it was suspected at (cleared on advance)
        self._suspect: Dict[str, int] = {}
        self._last_live: Optional[Tuple[str, ...]] = None
        self._last_write_ok_t: Optional[float] = None
        self._view = ClusterView(epoch=0, hosts={}, live=(),
                                 self_ok=False)
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def dead_after_s(self) -> float:
        """Seconds of beat flatness after which a host is dead."""
        return self.stale_after * self.heartbeat_interval_s

    # -- heartbeat (writer side) ------------------------------------------

    def beat_once(self) -> bool:
        """Write one heartbeat (atomic temp + replace). Returns whether
        the write landed — a false return is the partition signal that
        eventually flips ``self_ok``."""
        self._beat += 1
        record = {"host_id": self.host_id, "url": self.url,
                  "pid": os.getpid(), "beat": self._beat}
        path = os.path.join(self._hosts_dir, f"{self.host_id}.json")
        tmp = os.path.join(self._hosts_dir, f".{self.host_id}.tmp")
        try:
            os.makedirs(self._hosts_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)
        except OSError:
            return False
        with self._lock:
            self._last_write_ok_t = self._clock()
        return True

    def leave(self) -> None:
        """Remove this host's record — a clean departure drops it from
        the roster immediately (no staleness wait)."""
        try:
            os.remove(os.path.join(self._hosts_dir,
                                   f"{self.host_id}.json"))
        except OSError:
            pass

    # -- view (reader side) -----------------------------------------------

    def poll(self) -> ClusterView:
        """Read every record, advance the failure detector, bump the
        epoch on a live-set change, and return (and cache) the fresh
        :class:`ClusterView`."""
        now = self._clock()
        hosts: Dict[str, HostRecord] = {}
        try:
            names = os.listdir(self._hosts_dir)
        except OSError:
            names = []
        for fn in names:
            if fn.startswith(".") or not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._hosts_dir, fn)) as f:
                    d = json.load(f)
                rec = HostRecord(host_id=str(d["host_id"]),
                                 url=str(d["url"]), pid=int(d["pid"]),
                                 beat=int(d["beat"]))
            except (OSError, ValueError, KeyError):
                continue
            hosts[rec.host_id] = rec
        with self._lock:
            for hid, rec in hosts.items():
                prev = self._seen.get(hid)
                if prev is None or rec.beat != prev[0]:
                    self._seen[hid] = (rec.beat, now)
                    if (hid in self._suspect
                            and rec.beat != self._suspect[hid]):
                        # the suspect proved it is alive after all
                        del self._suspect[hid]
            for hid in list(self._seen):
                if hid not in hosts:
                    del self._seen[hid]
                    self._suspect.pop(hid, None)
            live = tuple(sorted(
                hid for hid in hosts
                if now - self._seen[hid][1] <= self.dead_after_s
                and hid not in self._suspect))
            self_ok = (self.host_id in live
                       and self._last_write_ok_t is not None
                       and now - self._last_write_ok_t
                       <= self.dead_after_s)
            epoch = max(self._read_epoch(), self._epoch)
            if live != self._last_live:
                epoch += 1
                self._write_epoch(epoch)
                self._last_live = live
            self._epoch = epoch
            self._view = ClusterView(epoch=epoch, hosts=hosts,
                                     live=live, self_ok=self_ok)
            return self._view

    def view(self) -> ClusterView:
        """The last polled :class:`ClusterView` (no filesystem I/O)."""
        with self._lock:
            return self._view

    def suspect(self, host_id: str) -> None:
        """Declare ``host_id`` dead *now* — the data plane's immediate
        failure signal (a forward just failed at transport level).
        Cleared automatically once the host's beat advances. Suspecting
        yourself is a no-op."""
        if host_id == self.host_id:
            return
        with self._lock:
            self._suspect[host_id] = self._seen.get(host_id,
                                                    (-1, 0.0))[0]
        self.poll()

    @property
    def epoch(self) -> int:
        """This observer's current epoch (monotonic)."""
        with self._lock:
            return self._epoch

    def _read_epoch(self) -> int:
        try:
            with open(self._epoch_path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _write_epoch(self, epoch: int) -> None:
        tmp = f"{self._epoch_path}.{self.host_id}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(str(epoch))
            os.replace(tmp, self._epoch_path)
        except OSError:
            pass

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Begin the production heartbeat thread (beat + poll every
        ``heartbeat_interval_s``). Idempotent."""
        if self._thread is not None:
            return
        self.beat_once()
        self.poll()
        self._stop = threading.Event()

        def _loop():
            while not self._stop.wait(self.heartbeat_interval_s):
                self.beat_once()
                self.poll()

        self._thread = threading.Thread(
            target=_loop, name=f"fleet-membership-{self.host_id}",
            daemon=True)
        self._thread.start()

    def stop(self, leave: bool = True) -> None:
        """Stop heartbeating; with ``leave`` (default) also remove the
        record so peers drop this host without a staleness wait."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
            self._stop = None
        if leave:
            self.leave()
