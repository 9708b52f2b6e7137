"""The fleet door: one host's entry point into a multi-host serving
fleet (port of ``analytics_zoo_tpu.serving.fabric.door``).

A :class:`FleetDoor` wraps one
:class:`~analytics_zoo_tpu_torch.serving.frontdoor.FrontDoor` (the host's
preforked worker ring) and joins it to its peers through a
:class:`~analytics_zoo_tpu_torch.serving.fabric.membership.Membership` — the
shared, epoch-numbered cluster view. The result is the front door's
contract lifted one level: a client may dial ANY host's fleet door and

- a request carrying ``X-Zoo-Route-Key`` lands on the same host (and,
  via the front door's inner ring, the same worker) no matter which
  door received it — :func:`fleet_pick` runs
  :class:`~analytics_zoo_tpu_torch.serving.router.TrafficPolicy`'s
  interval-point math over the *roster* (all hosts ever seen, dead
  ones included) and remaps only a dead host's interval onto the
  survivors, so one host's death moves exactly its keys;
- control-plane actions (``POST /v1/admin/rollout``: traffic splits,
  rollout start/promote/rollback, quota) apply on every host —
  executed locally, then fanned out to the live peers' epoch-guarded
  ``/v1/fleet/admin`` endpoint (a peer whose view is *older* than the
  caller's rejects with 409 instead of acting on a stale world);
- the result cache is cooperative: content-addressed keys are
  host-agnostic, so a worker's single-flight leader miss asks its
  door (``GET /v1/fleet/cache/<key>``), which searches its own
  workers and then every live peer before the worker pays a device
  execution — and a rollback's ``invalidate_version`` fan-out retires
  the entry on every host through the exact same admin replication;
- ``GET /metrics`` and ``GET /v1/debug/traces[/<id>]`` merge a second
  time across hosts: every sample gains a ``host="<id>"`` label next
  to its ``worker=`` label (HELP/TYPE still appear exactly once), and
  a trace's spans carry ``host`` so one request's timeline spans the
  whole fleet.

**Failure model.** Forwarding is best-effort with local failover: a
transport error talking to the picked host suspects it in the
membership (the view updates immediately — the next request remaps)
and serves the request locally; a peer-side 503 (draining door)
fails over locally without suspicion. A door whose own membership
record has gone stale (``self_ok`` false — it cannot see its own
heartbeats land) stops forwarding entirely and serves only locally:
a partitioned host must never act on a stale view.

**Elasticity.** Per-host worker autoscaling
(:class:`~analytics_zoo_tpu_torch.serving.fabric.autoscaler.Autoscaler`
driving ``FrontDoor.scale_to`` from queue depths) plus the
``SO_REUSEPORT`` shared-port fast path (``FleetConfig.shared_port``)
for trusted clients that want the kernel's multi-accept instead of a
proxy hop.

Like the front door it wraps, a fleet door never computes and never
initialises CUDA; only its workers hold card contexts.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import signal
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from analytics_zoo_tpu_torch.common.observability import (
    MetricsRegistry,
    format_traceparent,
    get_tracer,
    new_trace_id,
    parse_traceparent,
)
from analytics_zoo_tpu_torch.ft.chaos import serving_chaos
from analytics_zoo_tpu_torch.serving.frontdoor import (
    _FORWARD_HEADERS,
    _MODEL_RE,
    _OUTCOME_RE,
    _PREDICT_RE,
    _RETURN_HEADERS,
    _TRACE_ID_RE,
    _TRACES_RE,
    _TRANSPORT_ERRORS,
    _request_worker,
    FrontDoor,
    FrontDoorConfig,
    NoLiveWorkersError,
    merge_expositions,
)
from analytics_zoo_tpu_torch.serving.http import (
    DEFAULT_MAX_BODY_BYTES,
    LengthRequiredError,
    RequestTooLargeError,
    ZooHTTPServer,
    retry_after_headers,
    status_for_exception,
)
from analytics_zoo_tpu_torch.serving.quota import (
    QuotaConfig,
    QuotaExceededError,
    QuotaManager,
    TenantQuota,
)
from analytics_zoo_tpu_torch.serving.router import TrafficPolicy

from .autoscaler import Autoscaler, AutoscalerConfig
from .coopcache import TREE_CONTENT_TYPE
from .membership import Membership

__all__ = ["FleetConfig", "FleetDoor", "fleet_pick"]

_FLEET_CACHE_LOCAL_RE = re.compile(
    r"^/v1/fleet/cache/local/([0-9a-f]{64})$")
_FLEET_CACHE_RE = re.compile(r"^/v1/fleet/cache/([0-9a-f]{64})$")
_FLEET_TRACE_LOCAL_RE = re.compile(
    r"^/v1/fleet/traces/local/([0-9a-f]{16})$")


def fleet_pick(roster, live, self_id: str,
               route_key: Optional[str]) -> str:
    """Which host should serve a request that arrived at ``self_id``.

    The front door's interval-point math
    (:class:`~analytics_zoo_tpu_torch.serving.router.TrafficPolicy`) lifted
    one level. The partition is computed over the **roster** — every
    host the fleet has ever seen, dead ones included, in sorted order
    — so the map from route key to host depends only on the roster,
    not on who is currently alive. A key whose interval owner is dead
    re-picks over the live survivors (same math, dead hosts excluded):
    exactly the dead interval remaps, every other key stays put, and
    the host rejoining takes its old interval back.

    Keyless requests are served locally — every door is an equally
    good entry point, so spreading them again would only add a hop.

    Args:
      roster: all known host ids (any iterable; sorted internally).
      live: the currently-live subset.
      self_id: the host doing the picking.
      route_key: the request's ``X-Zoo-Route-Key`` (None = keyless).

    Returns:
      The chosen host id (possibly ``self_id``).

    The key is salted before hashing. The worker ring below hashes the
    SAME raw key: with an identical hash at both levels, every key a
    host owns would fall in that host's sub-interval of [0, 1) and
    collapse onto the corresponding fraction of its workers (one
    worker, for an even split) — the fleet would scale by doors but
    never by workers. The salt makes the two levels independent.
    """
    hosts = sorted(roster)
    if route_key is None or len(hosts) < 2:
        return self_id
    salted = "fleet\x1f" + route_key
    live_set = set(live)
    picked = TrafficPolicy({h: 1.0 for h in hosts}).pick(salted)
    if picked in live_set:
        return picked
    survivors = [h for h in hosts if h in live_set]
    if not survivors:
        return self_id
    return TrafficPolicy({h: 1.0 for h in survivors}).pick(salted)


@dataclass
class FleetConfig:
    """Knobs of one :class:`FleetDoor` (one host's share of the fleet).

    Args:
      spec: the engine factory every local worker boots (see
        :class:`~analytics_zoo_tpu_torch.serving.frontdoor.FrontDoorConfig`).
      fleet_dir: the shared rendezvous directory all hosts of the
        fleet point at (a shared filesystem in production, one tmpdir
        in tests) — membership records and the epoch live here.
      host_id: this host's stable id in the fleet (must be unique).
      workers: initial local worker-ring size.
      host / port: the fleet door's listener (``port=0`` picks free).
      advertise_url: the URL peers should dial for this door (default:
        the listener's own ``http://host:port``).
      heartbeat_interval_s / stale_after: membership cadence — a host
        whose record does not advance for ``stale_after`` intervals is
        dead (see :class:`~analytics_zoo_tpu_torch.serving.fabric
        .membership.Membership`).
      peer_timeout_s: control-plane fan-out timeout (metrics, traces,
        admin, quota snapshot) per peer.
      cache_timeout_s: cooperative-cache lookup budget per probe; also
        exported to workers as ``AZOO_FLEET_CACHE_TIMEOUT_S``.
      cooperative_cache: wire every worker's result cache to this
        door's fleet-wide lookup (``AZOO_FLEET_CACHE_URL``).
      adopt_quota: on boot, restore quota state from the first live
        peer's ``/v1/fleet/quota/snapshot`` — a joining host inherits
        the fleet's current policy *and* bucket levels instead of
        booting with full buckets (which would multiply a tenant's
        instantaneous budget by the host count).
      quota: this host's quota authority config (used when there is no
        peer to adopt from).
      autoscale: per-host worker autoscaling policy (None = off).
      shared_port: the ``SO_REUSEPORT`` multi-accept fast path,
        passed through to the local front door (see
        :class:`~analytics_zoo_tpu_torch.serving.frontdoor
        .FrontDoorConfig.shared_port`).
      proxy_timeout_s: per-hop timeout on forwarded predicts (and the
        local front door's proxy hops).
      aot_cache_dir: the port keeps no persistent executable cache
        (``inference.inference_model.NO_AOT_CACHE``); anything but
        ``None`` raises ``NotImplementedError`` as
        :class:`~analytics_zoo_tpu_torch.serving.frontdoor.FrontDoorConfig`
        does.
      Everything else passes straight through to the local
      :class:`~analytics_zoo_tpu_torch.serving.frontdoor.FrontDoorConfig`.
    """

    spec: str
    fleet_dir: str
    host_id: str
    workers: int = 2
    host: str = "127.0.0.1"
    port: int = 0
    advertise_url: Optional[str] = None
    heartbeat_interval_s: float = 0.2
    stale_after: int = 3
    peer_timeout_s: float = 5.0
    cache_timeout_s: float = 0.5
    cooperative_cache: bool = True
    adopt_quota: bool = True
    quota: Optional[QuotaConfig] = None
    autoscale: Optional[AutoscalerConfig] = None
    shared_port: Optional[int] = None
    aot_cache_dir: Optional[str] = None
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES
    proxy_timeout_s: float = 30.0
    drain_deadline_s: float = 30.0
    worker_boot_timeout_s: float = 120.0
    run_dir: Optional[str] = None
    log_dir: Optional[str] = None
    worker_env: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if not self.host_id:
            raise ValueError("host_id must be non-empty")
        if self.aot_cache_dir is not None:
            from analytics_zoo_tpu_torch.inference.inference_model import (
                refuse_aot_cache,
            )

            refuse_aot_cache(
                f"FleetConfig(aot_cache_dir={self.aot_cache_dir!r})")


class FleetDoor:
    """One host's fleet entry point: a local front door joined to its
    peers through shared membership.

    ::

        door = FleetDoor(FleetConfig(
            spec="my_app.serving:build_engine", workers=4,
            fleet_dir="/mnt/shared/azoo-fleet", host_id="a")).start()
        # clients POST http://host:door.port/v1/models/<m>:predict
        # — any fleet door; sticky keys land on one worker fleet-wide
        door.shutdown()

    ``start()`` boots the local worker ring (blocking), joins the
    membership, adopts the fleet's quota state from a live peer, and
    begins serving. The HTTP surface is the front door's plus the
    ``/v1/fleet/*`` peer protocol."""

    def __init__(self, config: FleetConfig):
        self.config = config
        self.host_id = config.host_id
        self._fd: Optional[FrontDoor] = None
        self._membership: Optional[Membership] = None
        self._autoscaler: Optional[Autoscaler] = None
        self._server: Optional[ZooHTTPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._ready = False
        self._state = "starting"        # -> serving -> stopped

        # zoo_fleet_* — this door's own registry; rides the per-host
        # exposition so the fleet merge stamps it host="<id>"
        self.registry = MetricsRegistry()
        reg = self.registry
        self._m_hosts_alive = reg.gauge(
            "zoo_fleet_hosts_alive",
            "Hosts currently live in the membership view.").labels()
        self._m_epoch = reg.gauge(
            "zoo_fleet_epoch",
            "This host's membership epoch (bumps on every live-set "
            "change; forwards carry it, stale admin is 409ed)."
            ).labels()
        self._m_requests = reg.counter(
            "zoo_fleet_requests_total",
            "Predicts by routing decision at this door.",
            labels=("target",))
        self._m_failovers = reg.counter(
            "zoo_fleet_failovers_total",
            "Forwarded predicts served locally instead (peer "
            "unreachable or refusing).").labels()
        self._m_quota_rejections = reg.counter(
            "zoo_fleet_quota_rejections_total",
            "Predicts rejected by this door's token buckets (entry "
            "door charges; forwarded hops do not re-charge).",
            labels=("tenant",))
        self._m_cache_lookups = reg.counter(
            "zoo_fleet_cache_lookups_total",
            "Cooperative-cache searches at this door by tier "
            "(own workers vs live peers) and outcome.",
            labels=("tier", "outcome"))
        self._m_autoscale = reg.gauge(
            "zoo_fleet_autoscale_events",
            "Applied autoscaling actions by direction.",
            labels=("direction",))
        self._m_admin_fanout = reg.counter(
            "zoo_fleet_admin_fanout_total",
            "Replicated admin actions relayed to peers by outcome.",
            labels=("outcome",))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FleetDoor":
        """Bind the listener, boot the local worker ring (blocking),
        join the membership, adopt quota from a live peer, start the
        autoscaler. Returns self."""
        self._server = ZooHTTPServer(
            (self.config.host, self.config.port),
            _make_fleet_handler(self))
        worker_env = dict(self.config.worker_env)
        if self.config.cooperative_cache:
            # workers ask THIS door on a single-flight leader miss —
            # the door knows the membership, the worker stays dumb
            worker_env["AZOO_FLEET_CACHE_URL"] = (
                f"{self.url}/v1/fleet/cache")
            worker_env.setdefault(
                "AZOO_FLEET_CACHE_TIMEOUT_S",
                str(self.config.cache_timeout_s))
        self._fd = FrontDoor(FrontDoorConfig(
            spec=self.config.spec,
            workers=self.config.workers,
            host=self.config.host,
            port=0,
            aot_cache_dir=self.config.aot_cache_dir,
            quota=self.config.quota,
            max_body_bytes=self.config.max_body_bytes,
            proxy_timeout_s=self.config.proxy_timeout_s,
            drain_deadline_s=self.config.drain_deadline_s,
            worker_boot_timeout_s=self.config.worker_boot_timeout_s,
            run_dir=self.config.run_dir,
            log_dir=self.config.log_dir,
            worker_env=worker_env,
            shared_port=self.config.shared_port)).start()
        self._membership = Membership(
            self.config.fleet_dir, self.host_id,
            self.config.advertise_url or self.url,
            heartbeat_interval_s=self.config.heartbeat_interval_s,
            stale_after=self.config.stale_after)
        self._membership.start()
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"zoo-fleetdoor-http-{self.host_id}")
        self._server_thread.start()
        if self.config.adopt_quota:
            self._adopt_quota()
        if self.config.autoscale is not None:
            self._autoscaler = Autoscaler(self._fd,
                                          self.config.autoscale)
            self._autoscaler.start()
        self._ready = True
        self._state = "serving"
        return self

    @property
    def port(self) -> int:
        """The fleet door's bound port."""
        if self._server is None:
            raise RuntimeError("fleet door not started")
        return self._server.server_port

    @property
    def url(self) -> str:
        """``http://host:port`` of this door's listener."""
        return f"http://{self.config.host}:{self.port}"

    @property
    def state(self) -> str:
        """``starting`` / ``serving`` / ``stopped``."""
        return self._state

    @property
    def frontdoor(self) -> FrontDoor:
        """The local worker ring (after :meth:`start`)."""
        if self._fd is None:
            raise RuntimeError("fleet door not started")
        return self._fd

    @property
    def membership(self) -> Membership:
        """This host's membership handle (after :meth:`start`)."""
        if self._membership is None:
            raise RuntimeError("fleet door not started")
        return self._membership

    @property
    def quota(self) -> QuotaManager:
        """This host's quota authority (the local front door's)."""
        return self.frontdoor.quota

    def shutdown(self) -> None:
        """Graceful exit: leave the membership (peers see a clean
        departure, not a death), stop the listener, the autoscaler and
        the local worker ring."""
        self._ready = False
        self._state = "stopped"
        if self._autoscaler is not None:
            self._autoscaler.stop()
        if self._membership is not None:
            self._membership.stop(leave=True)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._fd is not None:
            self._fd.shutdown()

    def simulate_host_kill(self) -> None:
        """Whole-host death, as tests and the bench need it: SIGKILL
        every worker, close the listener, stop heartbeating WITHOUT
        leaving — the membership record stays on disk exactly as a
        crashed host leaves it, so peers must detect the death by
        staleness (and the epoch must bump when they do)."""
        self._ready = False
        self._state = "stopped"
        if self._autoscaler is not None:
            self._autoscaler.stop()
        fd = self._fd
        if fd is not None:
            fd._stop.set()      # a dead host must not respawn workers
            for _slot, pid in fd.worker_pids().items():
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._membership is not None:
            self._membership.stop(leave=False)
        if fd is not None:
            fd.shutdown()

    def __enter__(self) -> "FleetDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- peer transport ---------------------------------------------------

    def _peer_request(self, url: str, method: str, path: str,
                      body: Optional[bytes], headers: Dict[str, str],
                      timeout: float,
                      ) -> Tuple[int, Dict[str, str], bytes]:
        u = urlsplit(url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port, timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def _live_peers(self) -> List[Tuple[str, str]]:
        """``[(host_id, url), ...]`` of the live peers (self excluded),
        sorted for deterministic fan-out order."""
        view = self.membership.view()
        out = []
        for hid in sorted(view.live):
            if hid == self.host_id:
                continue
            rec = view.hosts.get(hid)
            if rec is not None:
                out.append((hid, rec.url))
        return out

    # -- routing + forwarding ---------------------------------------------

    def handle_predict(self, method: str, path: str,
                       body: Optional[bytes],
                       headers: Dict[str, str],
                       route_key: Optional[str], hop: bool,
                       ) -> Tuple[int, Dict[str, str], bytes, str,
                                  Optional[str]]:
        """Route one predict at fleet level: pick the owning host,
        forward (one hop max) or serve through the local ring.

        Returns ``(status, headers, body, host_id, slot)`` — ``slot``
        is the serving worker when known. A transport failure toward
        the picked host *suspects* it (the view remaps immediately)
        and fails over to the local ring; a peer-side 503 fails over
        without suspicion. Raises
        :class:`~analytics_zoo_tpu_torch.serving.frontdoor
        .NoLiveWorkersError` only when the local ring is empty too."""
        view = self.membership.view()
        target = self.host_id
        if not hop and view.self_ok:
            # a door that cannot see its own heartbeats land is
            # partitioned from the fleet state: serve locally only,
            # never route by the stale view
            target = fleet_pick(view.roster, view.live, self.host_id,
                                route_key)
        if target != self.host_id:
            self._m_requests.labels(target="forward").inc()
            try:
                status, rheaders, data = self._forward(
                    target, method, path, body, headers)
                if status != 503:
                    return (status, rheaders, data, target,
                            rheaders.get("X-Zoo-Worker"))
                # the peer door is up but refusing (draining, ring
                # empty): predicts are idempotent — serve it here
                self._m_failovers.inc()
            except _TRANSPORT_ERRORS:
                self._m_failovers.inc()
                self.membership.suspect(target)
        else:
            self._m_requests.labels(target="local").inc()
        status, rheaders, data, slot = self.frontdoor.proxy(
            method, path, body, headers, route_key)
        return status, rheaders, data, self.host_id, slot

    def _forward(self, target: str, method: str, path: str,
                 body: Optional[bytes], headers: Dict[str, str],
                 ) -> Tuple[int, Dict[str, str], bytes]:
        # chaos hook: fleet_forward_drop armed with tag=<target host>
        # raises ChaosForwardError (a ConnectionError) right here —
        # the failover path above must absorb it like a real partition
        serving_chaos("fleet_forward_drop", tag=target)
        view = self.membership.view()
        rec = view.hosts.get(target)
        if rec is None:
            raise ConnectionError(
                f"host {target!r} vanished from the membership")
        h = dict(headers)
        h["X-Zoo-Fleet-Hop"] = "1"
        h["X-Zoo-Fleet-Epoch"] = str(self.membership.epoch)
        return self._peer_request(rec.url, method, path, body, h,
                                  self.config.proxy_timeout_s)

    # -- replicated control plane -----------------------------------------

    def apply_admin_local(self, payload: Dict) -> Dict[str, object]:
        """Apply one ``/v1/admin/rollout`` action on THIS host only:
        ``quota`` hits the door's token-bucket authority, everything
        else broadcasts to the local workers (they are replicas)."""
        if payload.get("action") == "quota":
            tenant = payload.get("tenant")
            if not tenant:
                raise ValueError("'quota' needs a 'tenant'")
            rate = payload.get("rate")
            self.quota.set_quota(
                str(tenant),
                None if rate is None else TenantQuota(
                    rate=float(rate),
                    burst=float(payload.get("burst", 1.0))))
            return {"quota": self.quota.describe()}
        return {"workers": self.frontdoor.broadcast_admin(payload)}

    def admin(self, payload: Dict, hop: bool = False,
              ) -> Dict[str, object]:
        """Replicated admin: apply locally, then fan out to every live
        peer's epoch-guarded ``/v1/fleet/admin``. ``hop=True`` (a
        relayed action) applies locally only — replication is one hop
        deep by construction. Returns ``{"hosts": {id: result}}`` (or
        the bare local result on a hop)."""
        local = self.apply_admin_local(payload)
        if hop:
            return local
        hosts: Dict[str, object] = {self.host_id: local}
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json",
                   "X-Zoo-Fleet-Epoch": str(self.membership.epoch)}
        timeout = max(self.config.peer_timeout_s,
                      self.config.drain_deadline_s + 5)
        for hid, url in self._live_peers():
            try:
                status, _h, data = self._peer_request(
                    url, "POST", "/v1/fleet/admin", body, headers,
                    timeout)
                hosts[hid] = {"status": status,
                              "response": json.loads(data)}
                self._m_admin_fanout.labels(
                    outcome="ok" if status == 200 else
                    f"http_{status}").inc()
            except (_TRANSPORT_ERRORS
                    + (json.JSONDecodeError,)) as e:
                hosts[hid] = {"error": f"{type(e).__name__}: {e}"}
                self._m_admin_fanout.labels(outcome="error").inc()
        return {"hosts": hosts}

    def _adopt_quota(self) -> bool:
        """Boot-time quota adoption: restore policy AND bucket levels
        from the first live peer that answers, so a joining host does
        not hand every tenant a fresh full budget."""
        self.membership.poll()
        for hid, url in self._live_peers():
            try:
                status, _h, data = self._peer_request(
                    url, "GET", "/v1/fleet/quota/snapshot", None, {},
                    self.config.peer_timeout_s)
            except _TRANSPORT_ERRORS:
                continue
            if status != 200:
                continue
            try:
                self.quota.restore(json.loads(data))
            except (json.JSONDecodeError, ValueError, KeyError,
                    TypeError):
                continue
            return True
        return False

    # -- cooperative cache ------------------------------------------------

    def cache_lookup_local(self, key: str) -> Optional[bytes]:
        """Search THIS host's live workers for a content-addressed
        result (``GET /v1/cache/<key>`` on each). Returns the encoded
        tree or None — peers call this, so it must never recurse back
        out to the fleet."""
        for _slot, port in sorted(
                self.frontdoor.worker_ports().items()):
            try:
                status, _h, data = _request_worker(
                    self.config.host, port, "GET",
                    f"/v1/cache/{key}", None, {},
                    self.config.cache_timeout_s)
            except _TRANSPORT_ERRORS:
                continue
            if status == 200:
                self._m_cache_lookups.labels(
                    tier="worker", outcome="hit").inc()
                return data
        self._m_cache_lookups.labels(
            tier="worker", outcome="miss").inc()
        return None

    def cache_lookup(self, key: str) -> Optional[bytes]:
        """Fleet-wide cooperative lookup: this host's workers first
        (cheapest), then every live peer's :meth:`cache_lookup_local`.
        Strictly best-effort — any failure is a miss, never an
        error."""
        data = self.cache_lookup_local(key)
        if data is not None:
            return data
        for hid, url in self._live_peers():
            try:
                status, _h, data = self._peer_request(
                    url, "GET", f"/v1/fleet/cache/local/{key}", None,
                    {}, self.config.cache_timeout_s)
            except _TRANSPORT_ERRORS:
                continue
            if status == 200:
                self._m_cache_lookups.labels(
                    tier="peer", outcome="hit").inc()
                return data
        self._m_cache_lookups.labels(
            tier="peer", outcome="miss").inc()
        return None

    # -- observability: fleet-level merges --------------------------------

    def local_metrics_text(self) -> str:
        """This host's full exposition: the front door's merged scrape
        (``worker=`` labels) plus the ``zoo_fleet_*`` families. The
        fleet merge re-merges this text with ``label="host"``."""
        view = self.membership.view()
        self._m_hosts_alive.set(float(len(view.live)))
        self._m_epoch.set(float(view.epoch))
        if self._autoscaler is not None:
            for direction, n in self._autoscaler.events.items():
                self._m_autoscale.labels(direction=direction).set(
                    float(n))
        return self.frontdoor.metrics_text() + self.registry.render()

    def metrics_text(self) -> str:
        """The fleet-merged ``GET /metrics`` body: every live host's
        :meth:`local_metrics_text`, merged a second time so each
        sample reads ``{host="a",worker="0",...}`` with HELP/TYPE
        appearing exactly once fleet-wide."""
        sections: List[Tuple[str, str]] = [
            (self.host_id, self.local_metrics_text())]
        for hid, url in self._live_peers():
            try:
                status, _h, data = self._peer_request(
                    url, "GET", "/v1/fleet/metrics/local", None, {},
                    self.config.peer_timeout_s)
                if status == 200:
                    sections.append((hid, data.decode()))
            except _TRANSPORT_ERRORS:
                pass        # partial scrape beats a failed one
        return merge_expositions(sections, label="host")

    def trace_index(self) -> Dict[str, object]:
        """The fleet ``GET /v1/debug/traces`` body: per-trace rollups
        from every live host, each entry listing the hosts (and
        ``host/worker`` processes) holding spans for it."""
        merged: Dict[str, Dict[str, object]] = {}

        def _fold(hid: str, doc: Dict) -> None:
            for tid, agg in (doc.get("traces") or {}).items():
                e = merged.setdefault(
                    tid, {"spans": 0, "workers": [], "hosts": []})
                e["spans"] += agg.get("spans", 0)
                e["workers"].extend(
                    f"{hid}/{w}" for w in agg.get("workers", []))
                if hid not in e["hosts"]:
                    e["hosts"].append(hid)

        local = self.frontdoor.trace_index()
        _fold(self.host_id, local)
        for hid, url in self._live_peers():
            try:
                status, _h, data = self._peer_request(
                    url, "GET", "/v1/fleet/traces/local", None, {},
                    self.config.peer_timeout_s)
                if status == 200:
                    _fold(hid, json.loads(data))
            except (_TRANSPORT_ERRORS + (json.JSONDecodeError,)):
                pass
        return {"enabled": local.get("enabled", False),
                "traces": merged}

    def collect_trace(self, trace_id: str) -> Dict[str, object]:
        """ONE fleet-wide timeline for ``trace_id``: every live
        host's merged trace (front door + workers), each span gaining
        a ``host`` field next to its ``worker``, anchors namespaced
        ``host/process``. Spans are deduplicated by span id — two
        doors sharing a tracer (in-process tests) must not double-report
        the same span."""
        anchors: Dict[str, object] = {}
        spans: List[Dict[str, object]] = []
        seen: set = set()

        def _fold(hid: str, doc: Dict) -> None:
            for proc, anchor in (doc.get("anchors") or {}).items():
                anchors[f"{hid}/{proc}"] = anchor
            for d in doc.get("spans") or []:
                sid = d.get("span_id")
                if sid is not None:
                    if sid in seen:
                        continue
                    seen.add(sid)
                d = dict(d)
                d["host"] = hid
                spans.append(d)

        _fold(self.host_id, self.frontdoor.collect_trace(trace_id))
        for hid, url in self._live_peers():
            try:
                status, _h, data = self._peer_request(
                    url, "GET", f"/v1/fleet/traces/local/{trace_id}",
                    None, {}, self.config.peer_timeout_s)
                if status == 200:
                    _fold(hid, json.loads(data))
            except (_TRANSPORT_ERRORS + (json.JSONDecodeError,)):
                pass
        spans.sort(key=lambda d: d.get("wall_start",
                                       d.get("start", 0.0)))
        return {"trace_id": trace_id, "spans": spans,
                "anchors": anchors,
                "note": "wall_* timestamps = per-process wall anchor "
                        "+ monotonic span time; anchors differ by "
                        "real clock skew between processes/hosts"}

    def collect_trace_chrome(self, trace_id: str) -> Dict[str, object]:
        """:meth:`collect_trace` as Chrome trace-event JSON — one
        ``pid`` row per ``host/worker`` process fleet-wide."""
        merged = self.collect_trace(trace_id)
        events = []
        for d in merged["spans"]:
            start = d.get("wall_start", d.get("start", 0.0))
            args = dict(d.get("attrs", {}))
            args["trace_id"] = d.get("trace_id")
            events.append({
                "name": d.get("name"), "ph": "X", "cat": "zoo",
                "ts": round(start * 1e6, 3),
                "dur": round(d.get("duration", 0.0) * 1e6, 3),
                "pid": f"{d.get('host', '?')}/{d.get('worker', '?')}",
                "tid": d.get("thread", 0),
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def health(self) -> Dict[str, object]:
        """The ``/healthz`` body: local ring health plus the
        membership view (epoch, live hosts, ``self_ok``)."""
        view = self.membership.view()
        local = self.frontdoor.health()
        status = local["status"] if self._ready else "unavailable"
        return {"status": status, "host_id": self.host_id,
                "epoch": view.epoch, "self_ok": view.self_ok,
                "live_hosts": sorted(view.live),
                "roster": list(view.roster),
                "frontdoor": local}


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------


def _make_fleet_handler(door: FleetDoor):
    """The fleet door's request-handler class — the front door's
    surface plus the ``/v1/fleet/*`` peer protocol."""

    class Handler(BaseHTTPRequestHandler):
        """Fleet routing, replication and merge endpoints for one
        FleetDoor."""

        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, *a):      # metrics carry the signal
            pass

        _trace_id = None

        def _adopt_trace_id(self) -> None:
            incoming = self.headers.get("X-Zoo-Trace-Id", "")
            if _TRACE_ID_RE.match(incoming):
                self._trace_id = incoming
                return
            parsed = parse_traceparent(
                self.headers.get("traceparent", ""))
            self._trace_id = parsed if parsed is not None \
                else new_trace_id()

        def _send(self, code: int, body: bytes,
                  content_type: str = "application/json",
                  extra_headers: Optional[Dict[str, str]] = None):
            try:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                tid = self._trace_id or new_trace_id()
                self.send_header("X-Zoo-Trace-Id", tid)
                self.send_header("traceparent",
                                 format_traceparent(tid))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

        def _send_json(self, code: int, payload,
                       extra_headers: Optional[Dict[str, str]] = None):
            self._send(code, json.dumps(payload).encode(),
                       extra_headers=extra_headers)

        def _send_error_for(self, e: BaseException):
            status = (503 if isinstance(e, NoLiveWorkersError)
                      else status_for_exception(e))
            self._send_json(
                status, {"error": f"{type(e).__name__}: {e}"},
                extra_headers=retry_after_headers(status, e))

        def _not_started(self) -> bool:
            if door._fd is None:
                self._send_json(
                    503, {"error": "fleet door is starting"},
                    extra_headers=retry_after_headers(503))
                return True
            return False

        # -- GET ----------------------------------------------------------

        def do_GET(self):
            self._adopt_trace_id()
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                if self._not_started():
                    return
                body = door.health()
                if body["status"] == "ok":
                    self._send_json(200, body)
                else:
                    self._send_json(
                        503, body,
                        extra_headers=retry_after_headers(503))
                return
            if self._not_started():
                return
            if path == "/metrics":
                self._send(200, door.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/v1/fleet/metrics/local":
                self._send(200, door.local_metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/v1/fleet/membership":
                view = door.membership.poll()
                self._send_json(200, {
                    "epoch": view.epoch, "self_ok": view.self_ok,
                    "live": sorted(view.live),
                    "roster": list(view.roster),
                    "hosts": {h: {"url": r.url, "pid": r.pid,
                                  "beat": r.beat}
                              for h, r in view.hosts.items()}})
            elif path == "/v1/fleet/quota/snapshot":
                self._send_json(200, door.quota.snapshot())
            elif (m := _FLEET_CACHE_LOCAL_RE.match(path)) is not None:
                data = door.cache_lookup_local(m.group(1))
                if data is None:
                    self._send_json(404, {"error": "cache miss"})
                else:
                    self._send(200, data, TREE_CONTENT_TYPE)
            elif (m := _FLEET_CACHE_RE.match(path)) is not None:
                data = door.cache_lookup(m.group(1))
                if data is None:
                    self._send_json(404, {"error": "cache miss"})
                else:
                    self._send(200, data, TREE_CONTENT_TYPE)
            elif path == "/v1/fleet/traces/local":
                self._send_json(200, door.frontdoor.trace_index())
            elif (m := _FLEET_TRACE_LOCAL_RE.match(path)) is not None:
                self._send_json(
                    200, door.frontdoor.collect_trace(m.group(1)))
            elif path == "/v1/debug/traces":
                self._send_json(200, door.trace_index())
            elif (t := _TRACES_RE.match(path)) is not None:
                if "format=chrome" in query:
                    self._send_json(
                        200, door.collect_trace_chrome(t.group(1)))
                else:
                    self._send_json(200,
                                    door.collect_trace(t.group(1)))
            elif path == "/v1/debug/flightrecorder":
                self._send_json(200, door.frontdoor.flight.stats())
            elif path == "/v1/debug/slo":
                self._send_json(200, door.frontdoor.slo.evaluate())
            elif (path == "/v1/models"
                  or _MODEL_RE.match(path) is not None):
                self._proxy_local("GET", None)
            else:
                self._send_json(404, {"error": "unknown path"})

        # -- POST ---------------------------------------------------------

        def do_POST(self):
            self._adopt_trace_id()
            if self._not_started():
                return
            if self.path == "/v1/admin/rollout":
                self._do_admin(hop=False)
                return
            if self.path == "/v1/fleet/admin":
                self._do_fleet_admin()
                return
            if self.path == "/v1/admin/frontdoor":
                self._do_frontdoor_admin()
                return
            outcome = _OUTCOME_RE.match(self.path)
            if _PREDICT_RE.match(self.path) is None and outcome is None:
                self._send_json(404, {"error": "unknown path"})
                return
            self._do_predict(outcome=outcome.group(1)
                             if outcome is not None else None)

        def _do_predict(self, outcome: Optional[str] = None):
            try:
                body = self._read_raw_body()
            except Exception as e:  # noqa: BLE001 — mapped below
                self._send_error_for(e)
                return
            hop = self.headers.get("X-Zoo-Fleet-Hop") is not None
            if not hop:
                # the ENTRY door charges quota; a forwarded hop must
                # not charge the tenant a second time
                tenant = self.headers.get("X-Zoo-Tenant")
                try:
                    door.quota.check(tenant)
                except QuotaExceededError as e:
                    door._m_quota_rejections.labels(
                        tenant=door.quota.label_for(e.tenant)).inc()
                    self._send_error_for(e)
                    return
            if not door._ready:
                self._send_json(
                    503, {"error": f"fleet door is {door.state}"},
                    extra_headers=retry_after_headers(503))
                return
            headers = {"X-Zoo-Trace-Id": self._trace_id}
            for h in _FORWARD_HEADERS:
                v = self.headers.get(h)
                if v is not None:
                    headers[h] = v
            # outcome posts pin a per-model route key: fleet_pick lands
            # every label for one model on the same host, and the
            # front-door pick below it on the same worker — the label
            # store's single-writer ownership
            route_key = ("outcome/" + outcome if outcome is not None
                         else self.headers.get("X-Zoo-Route-Key"))
            try:
                status, rheaders, data, host, slot = \
                    door.handle_predict("POST", self.path, body,
                                        headers, route_key, hop)
            except NoLiveWorkersError as e:
                self._send_error_for(e)
                return
            extra = {"X-Zoo-Host": host}
            if slot:
                extra["X-Zoo-Worker"] = slot
            for h in _RETURN_HEADERS:
                if h in rheaders:
                    extra[h] = rheaders[h]
            self._send(status, data,
                       rheaders.get("Content-Type",
                                    "application/json"),
                       extra_headers=extra)

        def _proxy_local(self, method: str, body: Optional[bytes]):
            headers = {"X-Zoo-Trace-Id": self._trace_id}
            for h in _FORWARD_HEADERS:
                v = self.headers.get(h)
                if v is not None:
                    headers[h] = v
            try:
                status, rheaders, data, slot = door.frontdoor.proxy(
                    method, self.path, body, headers, None)
            except NoLiveWorkersError as e:
                self._send_error_for(e)
                return
            extra = {"X-Zoo-Host": door.host_id,
                     "X-Zoo-Worker": slot}
            for h in _RETURN_HEADERS:
                if h in rheaders:
                    extra[h] = rheaders[h]
            self._send(status, data,
                       rheaders.get("Content-Type",
                                    "application/json"),
                       extra_headers=extra)

        def _do_admin(self, hop: bool):
            try:
                payload = json.loads(self._read_raw_body())
                if not isinstance(payload, dict):
                    raise ValueError(
                        "admin body must be a JSON object")
                self._send_json(200, door.admin(payload, hop=hop))
            except Exception as e:  # noqa: BLE001 — mapped below
                self._send_error_for(e)

        def _do_fleet_admin(self):
            # the stale-view guard: a relayed action stamped with an
            # epoch OLDER than ours comes from a door whose world
            # view predates a membership change we already saw —
            # refuse rather than act on it
            raw = self.headers.get("X-Zoo-Fleet-Epoch")
            if raw is not None:
                try:
                    peer_epoch = int(raw)
                except ValueError:
                    self._send_json(
                        400, {"error": f"bad epoch {raw!r}"})
                    return
                my_epoch = door.membership.epoch
                if peer_epoch < my_epoch:
                    self._send_json(409, {
                        "error": "stale membership view",
                        "peer_epoch": peer_epoch,
                        "epoch": my_epoch})
                    return
            self._do_admin(hop=True)

        def _do_frontdoor_admin(self):
            try:
                payload = json.loads(self._read_raw_body())
                if not isinstance(payload, dict):
                    raise ValueError(
                        "admin body must be a JSON object")
                action = payload.get("action")
                if action == "rolling_drain":
                    self._send_json(200,
                                    door.frontdoor.rolling_drain())
                elif action == "drain":
                    self._send_json(200, door.frontdoor.drain(
                        payload.get("deadline_s")))
                elif action == "status":
                    self._send_json(200, door.health())
                elif action == "scale":
                    self._send_json(200, door.frontdoor.scale_to(
                        int(payload["workers"])))
                else:
                    raise ValueError(
                        f"unknown frontdoor action {action!r}")
            except Exception as e:  # noqa: BLE001 — mapped below
                self._send_error_for(e)

        # -- body reading (same contract as serving/http.py) --------------

        def _read_raw_body(self) -> bytes:
            raw = self.headers.get("Content-Length")
            if raw is None:
                self.close_connection = True
                raise LengthRequiredError(
                    "POST requires a Content-Length header (chunked "
                    "bodies are not supported)")
            try:
                n = int(raw)
            except ValueError:
                self.close_connection = True
                raise ValueError(
                    f"invalid Content-Length: {raw!r}") from None
            if n <= 0:
                raise ValueError("empty request body")
            if n > door.config.max_body_bytes:
                self.close_connection = True
                raise RequestTooLargeError(
                    f"request body of {n} bytes exceeds the "
                    f"{door.config.max_body_bytes}-byte cap")
            body = self.rfile.read(n)
            if len(body) < n:
                self.close_connection = True
                raise ValueError(
                    f"truncated request body: Content-Length said "
                    f"{n} bytes, got {len(body)}")
            return body

    return Handler
