"""Horizontal serving tier: the preforked multi-process front door (port
of ``analytics_zoo_tpu.serving.frontdoor``).

One Python process (a stdlib HTTP server plus one flush thread) is a
GIL-bound ceiling no amount of hot-path work lifts. This module escapes
it the way the reference's Cluster Serving does: *replicas*. A
:class:`FrontDoor` prefork-spawns N
:mod:`~analytics_zoo_tpu_torch.serving.worker` subprocesses, each owning
a complete :class:`~analytics_zoo_tpu_torch.serving.engine.ServingEngine`
(batcher, result cache and, on the card, its own CUDA context and bucket
graphs), and fans requests out over persistent keep-alive connections.
The fan-out layer is thin and deterministic; reduction (metrics, health)
happens at the edge.

The front door itself never computes: it imports the port's serving
package (and so ``torch``) but must never initialise CUDA, which would
cost a context's card memory and time slices for nothing. Workers on one
card time-slice it (there is no MPS), so N workers may serve fewer
requests per second than one in-process engine; what the replicas buy is
fault isolation and GIL domains.

**Routing** reuses :class:`~analytics_zoo_tpu_torch.serving.router
.TrafficPolicy`'s interval-point math over the live worker slots with
equal weights: a request carrying ``X-Zoo-Route-Key`` hashes to a fixed
point of [0, 1) (sticky — a key's requests land on one worker, so that
worker's result cache stays hot for it), keyless requests spread by the
golden-ratio low-discrepancy sequence (over any window of N requests
every live worker receives N/len(ring) ± 1). The partition over slot
ids is deterministic, so ejecting a worker remaps exactly its interval
onto the survivors, and a respawned worker rejoining the ring takes its
old interval back — sticky keys migrate away and back with no
coordination.

**Health**: a heartbeat thread probes every worker's ``/healthz`` and
watches its process. A dead (``SIGKILL``, chaos ``os._exit``) or wedged
(probe timeouts) worker is ejected from the ring, its keys remap on the
next request, and it is respawned in the background — rejoining only
after its ready-file lands and a health probe passes. A transport
failure on the *proxy* path ejects immediately (no heartbeat wait) and
the request transparently retries on a live worker: inference is
idempotent, so a mid-request worker kill costs the client latency, not
an error. Worker-originated 503s (draining, breaker open) also retry on
another replica before surfacing.

**Quota** (single token-bucket authority): the front door owns the only
:class:`~analytics_zoo_tpu_torch.serving.quota.QuotaManager`; workers get
their quota stripped at boot, so N workers cannot multiply a tenant's
budget by N. Admin ``quota`` actions apply here; every other admin
action broadcasts to all workers (they are replicas — a traffic policy
must hold everywhere).

**Metrics**: ``GET /metrics`` scrapes every live worker and merges the
expositions into one — each family's HELP/TYPE appears exactly once,
every worker sample gains a ``worker="<slot>"`` label, and the front
door's own ``zoo_frontdoor_*`` families (plus its ``zoo_process_*``
gauges, labeled ``worker="frontdoor"``) ride along. Trace ids propagate
across the process hop: the front door mints (or adopts) the
``X-Zoo-Trace-Id`` and forwards it, and the worker's HTTP layer adopts
it, so spans on both sides share one id.

**Rolling drain** (:meth:`FrontDoor.rolling_drain`): one worker at a
time — eject from the ring, drain its engine over the admin surface
(queued work completes), SIGTERM, respawn, health-gate, rejoin,
advance. The tier never serves with fewer than N-1 workers during the
roll.

**Ops plane**: ``GET /v1/debug/traces/<id>`` fans out to
every live worker's span ring and merges the result with the front
door's own proxy spans into ONE per-request timeline — every span
labeled with its emitting process, aligned on the wall clock via each
process's ``wall_anchor`` (clock skew is reported, not hidden);
``?format=chrome`` renders it Perfetto-loadable. The front door also
keeps its own :class:`~analytics_zoo_tpu_torch.common.flight_recorder
.FlightRecorder` of proxy-level records (dumped on the ``proxy_error``
trigger — the forensic record when a worker is SIGKILLed mid-request,
since the dead worker cannot write its own) and an
:class:`~analytics_zoo_tpu_torch.common.slo.SLOEngine` with one availability
objective per worker slot, evaluated at every ``/metrics`` scrape and
served by ``GET /v1/debug/slo``.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Set, Tuple

from analytics_zoo_tpu_torch.common.flight_recorder import FlightRecorder
from analytics_zoo_tpu_torch.common.observability import (
    MetricsRegistry,
    build_info,
    format_traceparent,
    get_tracer,
    monotonic_s,
    new_trace_id,
    parse_traceparent,
    refresh_process_metrics,
    wall_anchor,
)
from analytics_zoo_tpu_torch.common.slo import SLOEngine, SLOObjective
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

__all__ = ["FrontDoor", "FrontDoorConfig", "NoLiveWorkersError",
           "WorkerBootError", "merge_expositions"]

_PREDICT_RE = re.compile(
    r"^/v1/models/([\w.\-]+)(?:/versions/([\w.\-]+))?:predict$")
_OUTCOME_RE = re.compile(r"^/v1/models/([\w.\-]+):outcome$")
_MODEL_RE = re.compile(r"^/v1/models/([\w.\-]+)$")
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{16}$")
_TRACES_RE = re.compile(r"^/v1/debug/traces/([0-9a-f]{16})$")

#: Request headers the front door forwards to the worker verbatim — the
#: whole client-visible contract (tenant/route-key/cache-control) plus
#: the trace id that joins the two processes' spans.
_FORWARD_HEADERS = ("Content-Type", "Accept", "Cache-Control",
                    "X-Zoo-Tenant", "X-Zoo-Route-Key")

#: Response headers copied from the worker back to the client (the body
#: is already proxied verbatim — bitwise parity with direct serving).
_RETURN_HEADERS = ("X-Zoo-Cache", "Retry-After")

#: Transport-level proxy failures — the worker is unreachable (dead,
#: killed mid-request, wedged past the timeout). Distinct from an HTTP
#: error *response*, which a live worker produced deliberately.
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class WorkerBootError(RuntimeError):
    """A worker subprocess failed to reach ready within the boot
    timeout (or exited during boot) — see its log file."""


class NoLiveWorkersError(RuntimeError):
    """Every worker is down or excluded — HTTP 503 + Retry-After at the
    front door."""

    retry_after_s = 1.0


@dataclass
class FrontDoorConfig:
    """Knobs of one :class:`FrontDoor`.

    Args:
      spec: the engine factory every worker boots —
        ``package.module:build_engine`` or
        ``/path/to/file.py:build_engine`` (a zero-argument callable
        returning a registered
        :class:`~analytics_zoo_tpu_torch.serving.engine.ServingEngine`).
      workers: ring size N. Start at physical cores (each worker is one
        GIL domain, and on the card one CUDA context).
      host / port: the front door's listener (``port=0`` picks a free
        port — read :attr:`FrontDoor.port`).
      aot_cache_dir: the JAX package's shared persistent executable
        cache. The port keeps none (a CUDA graph cannot be saved, and a
        worker captures its buckets at boot at little cost:
        ``inference.inference_model.NO_AOT_CACHE``); anything but
        ``None`` raises ``NotImplementedError``.
      quota: the single token-bucket authority
        (:class:`~analytics_zoo_tpu_torch.serving.quota.QuotaConfig`);
        workers' own quota is stripped at boot.
      heartbeat_interval_s / health_timeout_s / unhealthy_after: probe
        cadence, per-probe timeout, and consecutive misses before a
        worker is ejected as wedged (process death ejects immediately).
      worker_boot_timeout_s: ready-file deadline per spawn (a card
        worker pays the torch import, CUDA initialisation, the model load
        and its buckets' warm-up and capture; a numpy spec pays the
        import).
      respawn_backoff_s: pause before a respawn attempt (doubles per
        consecutive failure).
      proxy_timeout_s: per-hop socket timeout on proxied requests.
      drain_deadline_s: per-worker engine-drain deadline during a
        rolling drain (and the worker's own SIGTERM drain).
      run_dir: ready files + default log location (a fresh temp dir
        when None).
      log_dir: worker stdout/stderr logs, ``worker-<slot>.log``,
        append-mode across respawns (default: the
        ``AZOO_FRONTDOOR_LOG_DIR`` env var, else ``run_dir``).
      worker_env: extra environment for every worker — the chaos tests
        arm ``AZOO_FT_CHAOS=frontdoor_worker_exit`` here.
      shared_port: the ``SO_REUSEPORT`` multi-accept fast path (fleet
        fabric): every worker *additionally* binds this
        fixed port, and the kernel spreads accepted connections across
        them — trusted clients dial it directly with no proxy hop.
        Quota, sticky routing and transparent retry do NOT apply on
        this port (the front door never sees the request). The per-worker control ports
        (and all front-door machinery on them) are unaffected. ``None``
        (default) disables the extra listener.
    """

    spec: str
    workers: int = 2
    host: str = "127.0.0.1"
    port: int = 0
    aot_cache_dir: Optional[str] = None
    quota: Optional[QuotaConfig] = None
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES
    heartbeat_interval_s: float = 0.2
    health_timeout_s: float = 2.0
    unhealthy_after: int = 3
    worker_boot_timeout_s: float = 120.0
    respawn_backoff_s: float = 0.05
    proxy_timeout_s: float = 30.0
    drain_deadline_s: float = 30.0
    run_dir: Optional[str] = None
    log_dir: Optional[str] = None
    worker_env: Dict[str, str] = field(default_factory=dict)
    shared_port: Optional[int] = None

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.aot_cache_dir is not None:
            from analytics_zoo_tpu_torch.inference.inference_model import (
                refuse_aot_cache,
            )

            refuse_aot_cache(
                f"FrontDoorConfig(aot_cache_dir={self.aot_cache_dir!r})")


class _WorkerSlot:
    """One ring slot's current incarnation: the subprocess, its port,
    and its health bookkeeping."""

    __slots__ = ("slot", "proc", "port", "pid", "state", "misses",
                 "log_path")

    def __init__(self, slot: str, proc: subprocess.Popen, port: int,
                 pid: int, log_path: str):
        self.slot = slot
        self.proc = proc
        self.port = port
        self.pid = pid
        self.state = "live"      # live | draining | respawning | dead
        self.misses = 0
        self.log_path = log_path


def _request_worker(host: str, port: int, method: str, path: str,
                    body: Optional[bytes], headers: Dict[str, str],
                    timeout: float) -> Tuple[int, Dict[str, str], bytes]:
    """One request on a fresh connection (health gates, admin
    broadcasts, scrapes — paths that must not depend on pool state)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Prometheus exposition merging
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s(.+)$")


def merge_expositions(sections: List[Tuple[str, str]],
                      label: str = "worker") -> str:
    """Merge per-process Prometheus text expositions into one.

    ``sections`` is ``[(label value, exposition text), ...]``.
    Every family's ``# HELP`` / ``# TYPE`` header appears exactly once
    (first writer wins — the sections are replicas, their headers
    agree), every sample line gains a ``<label>="<value>"`` label, and
    each family's samples stay one contiguous block as the text-format
    grammar requires — even when the same family arrives from every
    section. ``label`` defaults to ``worker`` (the front door's merge);
    the fleet door merges already-merged per-host expositions a second
    time with ``label="host"``, so a fleet sample reads
    ``{host="a",worker="0",...}``."""
    order: List[str] = []
    families: Dict[str, Dict[str, object]] = {}

    def _family(name: str) -> Dict[str, object]:
        fam = families.get(name)
        if fam is None:
            fam = {"help": None, "type": None, "samples": []}
            families[name] = fam
            order.append(name)
        return fam

    for slot, text in sections:
        pair = f'{label}="{slot}"'
        current: Optional[str] = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                parts = line.split(" ", 3)
                if len(parts) < 3:
                    continue
                name = parts[2]
                fam = _family(name)
                kind = "help" if parts[1] == "HELP" else "type"
                if fam[kind] is None:
                    fam[kind] = line
                current = name
                continue
            if line.startswith("#"):
                continue
            # an exemplar suffix (` # {trace_id="..."} v`) must not feed
            # the greedy label regex — split it off and re-append after
            # the worker label is injected
            exemplar = ""
            ex_at = line.find(" # {")
            if ex_at != -1:
                exemplar = line[ex_at:]
                line = line[:ex_at]
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name, labels, value = m.groups()
            # summary _sum/_count samples belong to their family's block
            fam_name = name
            if current is not None and name in (current,
                                                current + "_sum",
                                                current + "_count"):
                fam_name = current
            elif name.endswith("_sum") and name[:-4] in families:
                fam_name = name[:-4]
            elif name.endswith("_count") and name[:-6] in families:
                fam_name = name[:-6]
            inner = f"{pair},{labels[1:-1]}" if labels else pair
            _family(fam_name)["samples"].append(
                f"{name}{{{inner}}} {value}{exemplar}")

    lines: List[str] = []
    for name in order:
        fam = families[name]
        if fam["help"] is not None:
            lines.append(fam["help"])
        if fam["type"] is not None:
            lines.append(fam["type"])
        lines.extend(fam["samples"])
    return "\n".join(lines) + "\n" if lines else ""


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------


class FrontDoor:
    """N preforked engine workers behind one consistent-hash ring.

    ::

        fd = FrontDoor(FrontDoorConfig(
            spec="my_app.serving:build_engine", workers=4)).start()
        # clients POST http://host:fd.port/v1/models/<name>:predict
        fd.rolling_drain()     # restart every worker, zero downtime
        fd.shutdown()

    ``start()`` blocks until every worker is ready (on the card, each
    boot captures the worker's bucket graphs). The HTTP surface
    is the single-process one plus ``POST /v1/admin/frontdoor``
    (``rolling_drain`` / ``drain`` / ``status``) and the ``worker=``
    labels in ``GET /metrics``. Every predict response carries
    ``X-Zoo-Worker: <slot>``.
    """

    def __init__(self, config: FrontDoorConfig):
        self.config = config
        self.quota = QuotaManager(config.quota)
        self._lock = threading.RLock()
        self._slots: Dict[str, _WorkerSlot] = {}
        self._live: Set[str] = set()
        self._policy: Optional[TrafficPolicy] = None
        self._pools: Dict[str, "queue.SimpleQueue"] = {}
        self._spawn_seq = 0
        self._stop = threading.Event()
        self._state = "starting"        # -> serving -> draining -> stopped
        self._run_dir = config.run_dir or tempfile.mkdtemp(
            prefix="azoo-frontdoor-")
        os.makedirs(self._run_dir, exist_ok=True)
        # AZOO_FRONTDOOR_LOG_DIR lets a harness (CI) collect every front
        # door's worker logs in one artifact dir without plumbing config
        self._log_dir = (config.log_dir
                         or os.environ.get("AZOO_FRONTDOOR_LOG_DIR")
                         or self._run_dir)
        os.makedirs(self._log_dir, exist_ok=True)
        self._server: Optional[ZooHTTPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._heartbeat: Optional[threading.Thread] = None

        # zoo_frontdoor_* — the front door's own registry (the merged
        # scrape prepends it un-merged; worker labels here mean "which
        # worker served", not "which process emitted")
        self.registry = MetricsRegistry()
        reg = self.registry
        self._m_requests = reg.counter(
            "zoo_frontdoor_requests_total",
            "Requests proxied to each worker slot.", labels=("worker",))
        self._m_retries = reg.counter(
            "zoo_frontdoor_retries_total",
            "Proxied requests transparently retried on another worker "
            "(transport failure or worker-side 503).").labels()
        self._m_proxy_errors = reg.counter(
            "zoo_frontdoor_proxy_errors_total",
            "Transport-level proxy failures observed (each ejects the "
            "worker and triggers a respawn).").labels()
        self._m_restarts = reg.counter(
            "zoo_frontdoor_worker_restarts_total",
            "Times each worker slot was respawned.", labels=("worker",))
        self._m_alive = reg.gauge(
            "zoo_frontdoor_workers_alive",
            "Worker slots currently in the routing ring.").labels()
        self._m_remaps = reg.counter(
            "zoo_frontdoor_ring_remaps_total",
            "Ring membership changes (ejections and rejoins) — each "
            "remaps the consistent-hash partition.").labels()
        self._m_quota_rejections = reg.counter(
            "zoo_frontdoor_quota_rejections_total",
            "Requests rejected by the front door's token buckets "
            "(the single quota authority).", labels=("tenant",))
        self._m_proxy_seconds = reg.summary(
            "zoo_frontdoor_proxy_seconds",
            "Per-hop proxy latency (connect/send/receive to a "
            "worker).").labels()
        # the front door's own zoo_process_* live in a separate registry
        # so the merger can stamp them worker="frontdoor"
        self._proc_registry = MetricsRegistry()
        # zoo_build_info rides in _proc_registry so the merged scrape
        # carries the family exactly once (worker="frontdoor"); its
        # device label reads "no-context" on a card's host: this process
        # never initialises CUDA
        build_info(self._proc_registry)
        # ops plane: the front door keeps its OWN flight
        # recorder of proxy-level request records — when a worker is
        # SIGKILLed mid-request the worker can't dump, but this ring
        # still holds the in-flight requests and their outcomes
        self.flight = FlightRecorder(
            capacity=int(os.environ.get("AZOO_FLIGHT_CAPACITY", "512")),
            dump_dir=os.environ.get("AZOO_FLIGHT_DIR"),
            latency_threshold_s=(
                float(os.environ["AZOO_FLIGHT_LATENCY_MS"]) / 1e3
                if os.environ.get("AZOO_FLIGHT_LATENCY_MS") else None),
            registry=self._proc_registry, role="frontdoor")
        # per-slot availability objectives: a single slot burning its
        # budget (bad worker, bad host) is visible even when the
        # fleet-wide numbers still look healthy. The families live in
        # _proc_registry — the workers' engines emit the same zoo_slo_*
        # names, so the front door's must ride the merge (stamped
        # worker="frontdoor") to keep HELP/TYPE appearing exactly once
        self.slo = SLOEngine(registry=self._proc_registry)
        for s in range(config.workers):
            self.slo.add_objective(SLOObjective(
                f"worker:availability:{s}", kind="availability",
                target=0.999,
                description=f"proxied requests to slot {s} that did "
                            "not fail"))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FrontDoor":
        """Spawn all N workers (concurrently), build the ring, start the
        heartbeat and the listener. Blocks until every worker is ready;
        raises :class:`WorkerBootError` (after killing the others) if
        any fails."""
        slots = [str(i) for i in range(self.config.workers)]
        results: Dict[str, object] = {}

        def _boot(slot: str) -> None:
            try:
                results[slot] = self._spawn(slot)
            except BaseException as e:  # noqa: BLE001 — reported below
                results[slot] = e

        threads = [threading.Thread(target=_boot, args=(s,), daemon=True,
                                    name=f"zoo-frontdoor-boot-{s}")
                   for s in slots]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failures = {s: r for s, r in results.items()
                    if isinstance(r, BaseException)}
        if failures:
            for r in results.values():
                if isinstance(r, _WorkerSlot):
                    self._terminate_worker(r, hard=True)
            slot, err = sorted(failures.items())[0]
            raise WorkerBootError(
                f"worker {slot} failed to boot: {err}") from err
        with self._lock:
            for slot in slots:
                w = results[slot]
                self._slots[slot] = w
                self._live.add(slot)
                self._pools[slot] = queue.SimpleQueue()
            self._rebuild_ring_locked()
            self._state = "serving"
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="zoo-frontdoor-heartbeat")
        self._heartbeat.start()
        self._server = ZooHTTPServer(
            (self.config.host, self.config.port), _make_handler(self))
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="zoo-frontdoor-http")
        self._server_thread.start()
        return self

    @property
    def port(self) -> int:
        """The listener's bound port (after :meth:`start`)."""
        if self._server is None:
            raise RuntimeError("front door not started")
        return self._server.server_port

    @property
    def url(self) -> str:
        """``http://host:port`` of the listener."""
        return f"http://{self.config.host}:{self.port}"

    @property
    def state(self) -> str:
        """``starting`` / ``serving`` / ``draining`` / ``stopped``."""
        return self._state

    def worker_pids(self) -> Dict[str, int]:
        """Current ``{slot: pid}`` (tests SIGKILL through this)."""
        with self._lock:
            return {s: w.pid for s, w in sorted(self._slots.items())}

    def worker_ports(self) -> Dict[str, int]:
        """Current ``{slot: port}`` of the LIVE workers — the fleet
        door's cooperative-cache search targets (``GET
        /v1/cache/<key>`` on each)."""
        with self._lock:
            return {s: self._slots[s].port for s in sorted(self._live)}

    def health(self) -> Dict[str, object]:
        """The ``/healthz`` body: front-door state + per-slot view."""
        with self._lock:
            workers = {
                s: {"state": w.state, "pid": w.pid, "port": w.port,
                    "misses": w.misses}
                for s, w in sorted(self._slots.items())}
            live = len(self._live)
            state = self._state
        status = ("ok" if state == "serving" and live > 0
                  else ("draining" if state == "draining"
                        else "unavailable"))
        return {"status": status, "state": state, "live_workers": live,
                "workers": workers}

    def drain(self, deadline_s: Optional[float] = None) -> Dict[str, object]:
        """Take the whole tier out of rotation: new predicts 503 at the
        front door, then every worker engine drains (queued work
        completes). Workers stay up — :meth:`shutdown` stops them."""
        with self._lock:
            if self._state == "serving":
                self._state = "draining"
        payload = {"action": "drain",
                   "deadline_s": deadline_s if deadline_s is not None
                   else self.config.drain_deadline_s}
        return {"state": self._state,
                "workers": self.broadcast_admin(payload)}

    def shutdown(self) -> None:
        """Stop the heartbeat, the listener and every worker (SIGTERM,
        escalating to SIGKILL past the drain deadline)."""
        self._stop.set()
        with self._lock:
            self._state = "stopped"
            workers = list(self._slots.values())
            self._live.clear()
            self._policy = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for w in workers:
            self._terminate_worker(w)
        if self._heartbeat is not None:
            self._heartbeat.join(timeout=5)

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- worker management ------------------------------------------------

    def _log(self, msg: str) -> None:
        try:
            sys.stderr.write(f"[frontdoor] {msg}\n")
        except (OSError, ValueError):  # pragma: no cover
            pass

    def _spawn(self, slot: str) -> _WorkerSlot:
        """Boot one worker subprocess and health-gate it (blocking)."""
        with self._lock:
            self._spawn_seq += 1
            seq = self._spawn_seq
        ready = os.path.join(self._run_dir, f"worker-{slot}-{seq}.json")
        log_path = os.path.join(self._log_dir, f"worker-{slot}.log")
        env = dict(os.environ)
        # the package must be importable in the child even when the
        # front door itself was launched from an unrelated cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        if get_tracer().enabled:
            # workers inherit tracing whenever the front door traces, so
            # a request's spans exist on both sides of the process hop
            # and collect_trace() has something to merge
            env.setdefault("AZOO_TRACE", "1")
        env.update(self.config.worker_env)
        cmd = [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.worker",
               "--spec", self.config.spec,
               "--ready-file", ready,
               "--worker-id", slot,
               "--host", self.config.host,
               "--max-body-bytes", str(self.config.max_body_bytes),
               "--drain-deadline-s", str(self.config.drain_deadline_s)]
        if self.config.shared_port:
            cmd += ["--shared-port", str(self.config.shared_port)]
        logf = open(log_path, "ab")
        try:
            logf.write(f"--- spawn slot={slot} seq={seq} ---\n".encode())
            logf.flush()
            proc = subprocess.Popen(cmd, stdout=logf,
                                    stderr=subprocess.STDOUT, env=env)
        finally:
            logf.close()    # the child keeps its own copy of the fd
        deadline = time.monotonic() + self.config.worker_boot_timeout_s
        info = None
        while time.monotonic() < deadline and not self._stop.is_set():
            if os.path.exists(ready):
                try:
                    with open(ready) as f:
                        info = json.load(f)
                    break
                except (OSError, json.JSONDecodeError):
                    pass        # torn read can't happen (atomic rename),
                                # but a slow FS deserves one more poll
            if proc.poll() is not None:
                raise WorkerBootError(
                    f"worker {slot} exited with code {proc.returncode} "
                    f"during boot (log: {log_path})")
            time.sleep(0.02)
        if info is None:
            proc.kill()
            proc.wait(timeout=5)
            if self._stop.is_set():
                raise WorkerBootError(
                    f"front door stopped during boot of worker {slot}")
            raise WorkerBootError(
                f"worker {slot} did not become ready within "
                f"{self.config.worker_boot_timeout_s}s (log: {log_path})")
        port = int(info["port"])
        # health gate: the server is listening, but rejoin only a worker
        # that answers — a respawn must never route traffic into a boot
        while time.monotonic() < deadline and not self._stop.is_set():
            try:
                status, _h, _b = _request_worker(
                    self.config.host, port, "GET", "/healthz", None, {},
                    self.config.health_timeout_s)
                if status == 200:
                    break
            except _TRANSPORT_ERRORS:
                pass
            time.sleep(0.02)
        else:
            proc.kill()
            proc.wait(timeout=5)
            raise WorkerBootError(
                f"worker {slot} never passed its health gate "
                f"(log: {log_path})")
        self._log(f"worker {slot} ready: pid={proc.pid} port={port}")
        return _WorkerSlot(slot, proc, port, int(info["pid"]), log_path)

    def _terminate_worker(self, w: _WorkerSlot, hard: bool = False) -> None:
        if w.proc.poll() is not None:
            return
        try:
            if hard:
                w.proc.kill()
            else:
                w.proc.terminate()
            w.proc.wait(timeout=self.config.drain_deadline_s + 5)
        except subprocess.TimeoutExpired:
            w.proc.kill()
            w.proc.wait(timeout=5)
        except OSError:  # pragma: no cover — already gone
            pass

    def _rebuild_ring_locked(self) -> None:
        # equal weights over the live slots: TrafficPolicy's partition is
        # deterministic in slot order, so membership alone fixes the map
        self._policy = (TrafficPolicy({s: 1.0 for s in self._live})
                        if self._live else None)
        self._m_alive.set(len(self._live))

    def _eject(self, slot: str, reason: str, kill: bool = True) -> bool:
        """Remove ``slot`` from the ring and (``kill=True``) hard-stop
        its process. Returns True when this call did the ejection —
        exactly one caller (heartbeat or proxy path) wins the respawn."""
        with self._lock:
            w = self._slots.get(slot)
            if w is None or w.state != "live":
                return False
            w.state = "respawning"
            self._live.discard(slot)
            self._pools[slot] = queue.SimpleQueue()   # drop stale conns
            self._rebuild_ring_locked()
        self._m_remaps.inc()
        self._log(f"ejected worker {slot}: {reason}")
        if kill and w.proc.poll() is None:
            try:
                w.proc.kill()
                w.proc.wait(timeout=5)
            except (OSError, subprocess.TimeoutExpired):  # pragma: no cover
                pass
        return True

    def _respawn_async(self, slot: str) -> None:
        threading.Thread(target=self._respawn, args=(slot,), daemon=True,
                         name=f"zoo-frontdoor-respawn-{slot}").start()

    def _respawn(self, slot: str) -> None:
        backoff = self.config.respawn_backoff_s
        for _attempt in range(8):
            if self._stop.is_set():
                return
            time.sleep(backoff)
            backoff = min(backoff * 2, 2.0)
            try:
                w = self._spawn(slot)
            except WorkerBootError as e:
                self._log(f"respawn of worker {slot} failed: {e}")
                continue
            with self._lock:
                if self._stop.is_set():
                    pass        # raced shutdown: stop the fresh worker
                else:
                    self._slots[slot] = w
                    self._live.add(slot)
                    self._pools[slot] = queue.SimpleQueue()
                    self._rebuild_ring_locked()
                    self._m_restarts.labels(worker=slot).inc()
                    self._m_remaps.inc()
                    self._log(f"worker {slot} rejoined the ring "
                              f"(pid={w.pid})")
                    return
            self._terminate_worker(w, hard=True)
            return
        with self._lock:
            w = self._slots.get(slot)
            if w is not None and w.state == "respawning":
                w.state = "dead"
        self._log(f"worker {slot} is DEAD: respawn attempts exhausted")

    def _probe(self, w: _WorkerSlot) -> bool:
        # any HTTP answer proves liveness — a draining worker's 503 is
        # deliberate, not a wedge
        try:
            _request_worker(self.config.host, w.port, "GET", "/healthz",
                            None, {}, self.config.health_timeout_s)
            return True
        except _TRANSPORT_ERRORS:
            return False

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.config.heartbeat_interval_s):
            with self._lock:
                live = [(s, self._slots[s]) for s in sorted(self._live)]
            for slot, w in live:
                if self._stop.is_set():
                    return
                code = w.proc.poll()
                if code is not None:
                    if self._eject(slot,
                                   f"process exited with code {code}",
                                   kill=False):
                        # the dead worker took its own ring with it —
                        # snapshot OURS, which still holds every recent
                        # (and in-flight) proxied request to that slot
                        self.flight.trigger("watchdog_restart")
                        self._respawn_async(slot)
                    continue
                if self._probe(w):
                    w.misses = 0
                elif w.misses + 1 >= self.config.unhealthy_after:
                    if self._eject(slot, f"{w.misses + 1} consecutive "
                                         "health-probe failures"):
                        self.flight.trigger("watchdog_restart")
                        self._respawn_async(slot)
                else:
                    w.misses += 1

    # -- routing + proxy --------------------------------------------------

    def _pick(self, route_key: Optional[str],
              excluded: Set[str]) -> Optional[str]:
        with self._lock:
            if not excluded and self._policy is not None:
                return self._policy.pick(route_key)
            live = sorted(self._live - excluded)
        if not live:
            return None
        # retry path: a throwaway equal-weight policy over the remaining
        # slots — same interval math, failed slots excluded
        return TrafficPolicy({s: 1.0 for s in live}).pick(route_key)

    def _proxy_once(self, slot: str, method: str, path: str,
                    body: Optional[bytes], headers: Dict[str, str],
                    ) -> Tuple[int, Dict[str, str], bytes]:
        with self._lock:
            w = self._slots.get(slot)
            if w is None or w.state != "live":
                raise ConnectionError(f"worker {slot} is not live")
            port = w.port
            pool = self._pools[slot]
        try:
            conn = pool.get_nowait()
        except queue.Empty:
            conn = None
        t0 = time.monotonic()
        if conn is not None:
            # a pooled keep-alive connection may have been closed by the
            # worker (error responses close); that is not evidence of a
            # dead worker — fall through to one fresh-connection attempt
            try:
                result = self._request_on(conn, pool, method, path, body,
                                          headers)
                self._finish_proxy(slot, t0)
                return result
            except _TRANSPORT_ERRORS:
                conn.close()
        conn = http.client.HTTPConnection(
            self.config.host, port, timeout=self.config.proxy_timeout_s)
        try:
            result = self._request_on(conn, pool, method, path, body,
                                      headers)
        except BaseException:
            conn.close()
            raise
        self._finish_proxy(slot, t0)
        return result

    def _request_on(self, conn, pool, method, path, body, headers):
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        if resp.will_close:
            conn.close()
        else:
            pool.put(conn)
        return resp.status, dict(resp.getheaders()), data

    def _finish_proxy(self, slot: str, t0: float) -> None:
        self._m_proxy_seconds.observe(time.monotonic() - t0)
        self._m_requests.labels(worker=slot).inc()

    def proxy(self, method: str, path: str, body: Optional[bytes],
              headers: Dict[str, str], route_key: Optional[str],
              ) -> Tuple[int, Dict[str, str], bytes, str]:
        """Route + proxy one request, transparently retrying transport
        failures (eject + respawn the worker) and worker-side 503s on
        other live slots. Returns ``(status, headers, body, slot)``;
        raises :class:`NoLiveWorkersError` when the ring is empty.

        Every hop is recorded: a flight-recorder record at
        the proxy level (a transport failure snapshots the ring via the
        ``proxy_error`` trigger — the dump of record when a worker was
        SIGKILLed mid-request), a ``frontdoor.proxy`` span per hop
        under the request's trace id when tracing is on, and a per-slot
        availability sample into the SLO engine."""
        tid = headers.get("X-Zoo-Trace-Id")
        m = _PREDICT_RE.match(path)
        rec = self.flight.begin(m.group(1) if m else path,
                                trace_id=tid, kind="proxy")
        tracer = get_tracer()
        excluded: Set[str] = set()
        last_503 = None
        attempts = 0
        max_attempts = self.config.workers + 1
        while attempts < max_attempts:
            slot = self._pick(route_key, excluded)
            if slot is None:
                break
            attempts += 1
            rec.t_route = monotonic_s()
            rec.worker = slot
            t_span = monotonic_s()
            try:
                status, rheaders, data = self._proxy_once(
                    slot, method, path, body, headers)
            except _TRANSPORT_ERRORS as e:
                self._m_proxy_errors.inc()
                if tracer.enabled and tid is not None:
                    tracer.record_span("frontdoor.proxy", tid, t_span,
                                       monotonic_s(), worker=slot,
                                       error=type(e).__name__)
                self.slo.record_outcome(slot, ok=False, trace_id=tid,
                                        prefix="worker:")
                # the worker can't write a dump if it was killed — OUR
                # ring still holds this (and every recent) request, so
                # snapshot it now
                self.flight.trigger("proxy_error")
                if self._eject(slot, f"proxy transport failure: "
                                     f"{type(e).__name__}: {e}"):
                    self._respawn_async(slot)
                excluded.add(slot)
                self._m_retries.inc()
                continue
            if tracer.enabled and tid is not None:
                tracer.record_span("frontdoor.proxy", tid, t_span,
                                   monotonic_s(), worker=slot,
                                   status=status)
            self.slo.record_outcome(slot, ok=status < 500, trace_id=tid,
                                    prefix="worker:")
            if status == 503:
                # a live worker refusing (draining / breaker open):
                # predicts are idempotent, another replica may serve it
                last_503 = (status, rheaders, data, slot)
                excluded.add(slot)
                self._m_retries.inc()
                continue
            self.flight.finish(
                rec, "ok" if status < 500
                else ("deadline" if status == 504 else "error"),
                error=None if status < 500 else f"http_{status}")
            return status, rheaders, data, slot
        if last_503 is not None:
            self.flight.finish(rec, "rejected", error="http_503")
            return last_503
        self.flight.finish(rec, "error", error="NoLiveWorkersError")
        raise NoLiveWorkersError(
            "no live workers in the ring — retry shortly")

    # -- admin ------------------------------------------------------------

    def broadcast_admin(self, payload: Dict) -> Dict[str, object]:
        """POST one admin action to every live worker (they are
        replicas: control-plane state must agree everywhere). Returns
        ``{slot: response or {"error": ...}}``."""
        body = json.dumps(payload).encode()
        with self._lock:
            targets = [(s, self._slots[s].port) for s in sorted(self._live)]
        out: Dict[str, object] = {}
        for slot, port in targets:
            try:
                status, _h, data = _request_worker(
                    self.config.host, port, "POST", "/v1/admin/rollout",
                    body, {"Content-Type": "application/json"},
                    max(self.config.proxy_timeout_s,
                        self.config.drain_deadline_s + 5))
                out[slot] = {"status": status,
                             "response": json.loads(data)}
            except (_TRANSPORT_ERRORS + (json.JSONDecodeError,)) as e:
                out[slot] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def rolling_drain(self) -> Dict[str, object]:
        """Zero-downtime restart of every worker, one at a time: eject
        from the ring → drain the engine (queued work completes) →
        SIGTERM → respawn → health-gate → rejoin → advance. Each respawn
        captures its bucket graphs again (the port keeps no persistent
        executable cache)."""
        reports: Dict[str, object] = {}
        for slot in sorted(self._slots, key=lambda s: (len(s), s)):
            with self._lock:
                w = self._slots.get(slot)
                if w is None or w.state != "live":
                    reports[slot] = {"skipped": w.state if w else "gone"}
                    continue
                w.state = "draining"
                self._live.discard(slot)
                self._pools[slot] = queue.SimpleQueue()
                self._rebuild_ring_locked()
            self._m_remaps.inc()
            self._log(f"rolling drain: worker {slot} out of the ring")
            try:
                _status, _h, data = _request_worker(
                    self.config.host, w.port, "POST", "/v1/admin/rollout",
                    json.dumps({
                        "action": "drain",
                        "deadline_s": self.config.drain_deadline_s,
                    }).encode(),
                    {"Content-Type": "application/json"},
                    self.config.drain_deadline_s + 5)
                drain_report = json.loads(data)
            except (_TRANSPORT_ERRORS + (json.JSONDecodeError,)) as e:
                drain_report = {"error": f"{type(e).__name__}: {e}"}
            self._terminate_worker(w)
            neww = self._spawn(slot)
            with self._lock:
                self._slots[slot] = neww
                self._live.add(slot)
                self._pools[slot] = queue.SimpleQueue()
                self._rebuild_ring_locked()
            self._m_restarts.labels(worker=slot).inc()
            self._m_remaps.inc()
            self._log(f"rolling drain: worker {slot} respawned "
                      f"(pid={neww.pid}) and rejoined")
            reports[slot] = {"drain": drain_report,
                             "respawned_pid": neww.pid}
        with self._lock:
            complete = len(self._live) == len(self._slots)
        return {"workers": reports, "complete": complete}

    # -- elasticity (fleet fabric) ----------------------------------------

    def queue_depths(self) -> Dict[str, float]:
        """Summed batcher queue depth per live worker, read from each
        worker's ``/healthz`` (the ``zoo_serving_queue_depth``
        backpressure signal at its source). Unreachable workers are
        skipped — the autoscaler must never stall on a dying worker."""
        with self._lock:
            targets = [(s, self._slots[s].port)
                       for s in sorted(self._live)]
        out: Dict[str, float] = {}
        for slot, port in targets:
            try:
                _status, _h, data = _request_worker(
                    self.config.host, port, "GET", "/healthz", None, {},
                    self.config.health_timeout_s)
                models = json.loads(data).get("models", {})
            except (_TRANSPORT_ERRORS + (json.JSONDecodeError,)):
                continue
            depth = 0.0
            for desc in models.values():
                for info in (desc.get("versions") or {}).values():
                    depth += float(info.get("queue_depth", 0) or 0)
            out[slot] = depth
        return out

    def scale_to(self, n: int) -> Dict[str, object]:
        """Grow or shrink the prefork set to ``n`` workers.

        Growing spawns fresh slots (next free integer ids) and health-
        gates them before they join the ring — in-flight traffic never
        notices. Shrinking retires the highest-numbered live slots
        gracefully: out of the ring first (keys remap to the
        survivors), then an engine drain (queued work completes), then
        SIGTERM — the same choreography as one :meth:`rolling_drain`
        rung, minus the respawn. Slots mid-respawn are left alone; the
        call is bounded by the live set it observed. Returns
        ``{"added": [...], "removed": [...], "workers": live_count}``.
        """
        if n < 1:
            raise ValueError(f"cannot scale below one worker, got {n}")
        added: List[str] = []
        removed: List[str] = []
        while True:
            with self._lock:
                if self._state != "serving":
                    break
                live = sorted(self._live, key=lambda s: (len(s), s))
                delta = n - len(live)
                if delta > 0:
                    slot = str(max((int(s) for s in self._slots
                                    if s.isdigit()), default=-1) + 1)
                elif delta < 0 and len(live) > 1:
                    slot = live[-1]
                    w = self._slots[slot]
                    w.state = "draining"
                    self._live.discard(slot)
                    self._pools[slot] = queue.SimpleQueue()
                    self._rebuild_ring_locked()
                else:
                    break
            if delta > 0:
                w = self._spawn(slot)
                with self._lock:
                    raced_stop = self._stop.is_set()
                    if not raced_stop:
                        self._slots[slot] = w
                        self._live.add(slot)
                        self._pools[slot] = queue.SimpleQueue()
                        self._rebuild_ring_locked()
                if raced_stop:
                    self._terminate_worker(w, hard=True)
                    break
                self.slo.add_objective(SLOObjective(
                    f"worker:availability:{slot}", kind="availability",
                    target=0.999,
                    description=f"proxied requests to slot {slot} that "
                                "did not fail"))
                self._m_remaps.inc()
                self._log(f"scale up: worker {slot} joined the ring "
                          f"(pid={w.pid})")
                added.append(slot)
            else:
                self._m_remaps.inc()
                self._log(f"scale down: worker {slot} out of the ring")
                try:
                    _request_worker(
                        self.config.host, w.port, "POST",
                        "/v1/admin/rollout",
                        json.dumps({
                            "action": "drain",
                            "deadline_s": self.config.drain_deadline_s,
                        }).encode(),
                        {"Content-Type": "application/json"},
                        self.config.drain_deadline_s + 5)
                except _TRANSPORT_ERRORS:
                    pass        # it dies anyway; drain is best-effort
                self._terminate_worker(w)
                with self._lock:
                    self._slots.pop(slot, None)
                    self._pools.pop(slot, None)
                removed.append(slot)
        with self._lock:
            live_count = len(self._live)
        return {"added": added, "removed": removed,
                "workers": live_count}

    # -- trace collection -------------------------------------------------

    def _debug_fanout(self, path: str) -> Dict[str, Dict]:
        """GET ``path`` from every live worker; ``{slot: parsed JSON}``
        (unreachable workers are skipped — a partial merge beats a
        failed one)."""
        with self._lock:
            targets = [(s, self._slots[s].port)
                       for s in sorted(self._live)]
        out: Dict[str, Dict] = {}
        for slot, port in targets:
            try:
                status, _h, data = _request_worker(
                    self.config.host, port, "GET", path, None, {},
                    self.config.proxy_timeout_s)
                if status == 200:
                    out[slot] = json.loads(data)
            except (_TRANSPORT_ERRORS + (json.JSONDecodeError,)):
                self._m_proxy_errors.inc()
        return out

    def trace_index(self) -> Dict[str, object]:
        """The merged ``GET /v1/debug/traces`` body: per-trace rollups
        from every live worker plus the front door's own ring, keyed by
        trace id, each entry carrying the set of processes that hold
        spans for it."""
        merged: Dict[str, Dict[str, object]] = {}

        def _fold(worker: str, rollup: Dict[str, Dict]) -> None:
            for tid, agg in rollup.items():
                e = merged.setdefault(tid, {"spans": 0, "workers": []})
                e["spans"] += agg.get("spans", 0)
                e["workers"].append(worker)

        _fold("frontdoor", get_tracer().trace_rollup())
        for slot, payload in self._debug_fanout("/v1/debug/traces"
                                                ).items():
            _fold(slot, payload.get("traces", {}))
        return {"enabled": get_tracer().enabled, "traces": merged}

    def collect_trace(self, trace_id: str) -> Dict[str, object]:
        """ONE merged timeline for ``trace_id`` across the whole fleet:
        the front door's own spans (proxy hops) plus every live
        worker's, each span labeled with the process that emitted it
        and aligned onto the wall clock via each process's
        ``wall_anchor``. The anchors are reported alongside the spans —
        residual inter-process clock skew is real measurement noise,
        noted rather than hidden."""
        anchors: Dict[str, float] = {"frontdoor": wall_anchor()}
        spans: List[Dict[str, object]] = []
        for s in get_tracer().spans_for(trace_id):
            d = s.to_dict()
            d["worker"] = "frontdoor"
            spans.append(d)
        for slot, payload in self._debug_fanout(
                f"/v1/debug/traces/{trace_id}").items():
            anchor = payload.get("wall_anchor")
            if anchor is not None:
                anchors[slot] = anchor
            for d in payload.get("spans", []):
                d["worker"] = slot
                spans.append(d)
        for d in spans:
            anchor = anchors.get(d["worker"])
            if anchor is not None:
                d["wall_start"] = anchor + d["start"]
                d["wall_end"] = (anchor + d["start"]
                                 + d.get("duration", 0.0))
        spans.sort(key=lambda d: d.get("wall_start", d["start"]))
        return {"trace_id": trace_id, "spans": spans,
                "anchors": anchors,
                "note": "wall_* timestamps = per-process wall anchor + "
                        "monotonic span time; anchors differ by real "
                        "clock skew between processes"}

    def collect_trace_chrome(self, trace_id: str) -> Dict[str, object]:
        """:meth:`collect_trace` rendered as Chrome trace-event JSON —
        one ``pid`` row per process (frontdoor + each worker slot), so
        Perfetto shows the whole-fleet request end to end."""
        merged = self.collect_trace(trace_id)
        events = []
        for d in merged["spans"]:
            start = d.get("wall_start", d["start"])
            args = dict(d.get("attrs", {}))
            args["trace_id"] = d["trace_id"]
            events.append({
                "name": d["name"], "ph": "X", "cat": "zoo",
                "ts": round(start * 1e6, 3),
                "dur": round(d.get("duration", 0.0) * 1e6, 3),
                "pid": d["worker"], "tid": d.get("thread", 0),
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    # -- metrics ----------------------------------------------------------

    def metrics_text(self) -> str:
        """The merged exposition: ``zoo_frontdoor_*`` first (un-merged —
        its ``worker`` labels mean "which worker served"), then every
        live worker's scrape plus the front door's own ``zoo_process_*``
        gauges, merged family-by-family with ``worker=`` labels."""
        refresh_process_metrics(self._proc_registry)
        # pulled SLO evaluation: the burn/budget gauges in self.registry
        # refresh on the same read that exposes them
        self.slo.evaluate()
        sections: List[Tuple[str, str]] = [
            ("frontdoor", self._proc_registry.render())]
        with self._lock:
            targets = [(s, self._slots[s].port) for s in sorted(self._live)]
        for slot, port in targets:
            try:
                status, _h, data = _request_worker(
                    self.config.host, port, "GET", "/metrics", None, {},
                    self.config.proxy_timeout_s)
                if status == 200:
                    sections.append((slot, data.decode()))
            except _TRANSPORT_ERRORS:
                # a worker dying mid-scrape is the heartbeat's problem;
                # the scrape stays partial rather than failing
                self._m_proxy_errors.inc()
        return self.registry.render() + merge_expositions(sections)


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------


def _make_handler(fd: FrontDoor):
    """The front door's request-handler class (same stdlib pattern as
    :func:`analytics_zoo_tpu_torch.serving.http.make_handler`, but proxying
    instead of owning an engine)."""

    class Handler(BaseHTTPRequestHandler):
        """Quota, routing and fan-out for one FrontDoor."""

        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, *a):  # quiet; metrics carry the signal
            pass

        _trace_id = None

        def _adopt_trace_id(self) -> None:
            incoming = self.headers.get("X-Zoo-Trace-Id", "")
            if _TRACE_ID_RE.match(incoming):
                self._trace_id = incoming
                return
            # W3C traceparent alias (same precedence as the worker
            # handler: the house header wins when both arrive)
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
                self.send_header("traceparent", format_traceparent(tid))
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
            self._send_json(status, {"error": f"{type(e).__name__}: {e}"},
                            extra_headers=retry_after_headers(status, e))

        # -- GET ----------------------------------------------------------

        def do_GET(self):
            self._adopt_trace_id()
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                self._send(200, fd.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/v1/debug/traces":
                self._send_json(200, fd.trace_index())
            elif (t := _TRACES_RE.match(path)) is not None:
                # ?format=chrome renders the merged fleet timeline as
                # Chrome trace-event JSON (Perfetto-loadable)
                if "format=chrome" in query:
                    self._send_json(200,
                                    fd.collect_trace_chrome(t.group(1)))
                else:
                    self._send_json(200, fd.collect_trace(t.group(1)))
            elif path == "/v1/debug/flightrecorder":
                self._send_json(200, fd.flight.stats())
            elif path == "/v1/debug/slo":
                self._send_json(200, fd.slo.evaluate())
            elif self.path == "/healthz":
                body = fd.health()
                if body["status"] == "ok":
                    self._send_json(200, body)
                else:
                    self._send_json(503, body,
                                    extra_headers=retry_after_headers(503))
            elif (self.path == "/v1/models"
                  or _MODEL_RE.match(self.path) is not None):
                self._proxy_through("GET", None)
            else:
                self._send_json(404, {"error": "unknown path"})

        # -- POST ---------------------------------------------------------

        def do_POST(self):
            self._adopt_trace_id()
            if self.path == "/v1/admin/frontdoor":
                self._do_frontdoor_admin()
                return
            if self.path == "/v1/admin/rollout":
                self._do_admin()
                return
            outcome = _OUTCOME_RE.match(self.path)
            if _PREDICT_RE.match(self.path) is None and outcome is None:
                self._send_json(404, {"error": "unknown path"})
                return
            try:
                body = self._read_raw_body()
            except Exception as e:  # noqa: BLE001 — mapped to statuses
                self._send_error_for(e)
                return
            # the single quota authority: charge the tenant HERE, before
            # any worker sees the request (workers run quota-stripped)
            tenant = self.headers.get("X-Zoo-Tenant")
            try:
                fd.quota.check(tenant)
            except QuotaExceededError as e:
                fd._m_quota_rejections.labels(
                    tenant=fd.quota.label_for(e.tenant)).inc()
                self._send_error_for(e)
                return
            if fd.state != "serving":
                self._send_json(
                    503, {"error": f"front door is {fd.state}"},
                    extra_headers=retry_after_headers(503))
                return
            # outcome posts pin a per-model route key so the sticky pick
            # lands every label for one model on the same worker — the
            # label store's single-writer ownership
            self._proxy_through(
                "POST", body,
                route_key=("outcome/" + outcome.group(1)
                           if outcome is not None else None))

        def _proxy_through(self, method: str, body: Optional[bytes],
                           route_key: Optional[str] = None):
            headers = {"X-Zoo-Trace-Id": self._trace_id}
            for h in _FORWARD_HEADERS:
                v = self.headers.get(h)
                if v is not None:
                    headers[h] = v
            if route_key is None:
                route_key = self.headers.get("X-Zoo-Route-Key")
            try:
                status, rheaders, data, slot = fd.proxy(
                    method, self.path, body, headers, route_key)
            except NoLiveWorkersError as e:
                self._send_error_for(e)
                return
            extra = {"X-Zoo-Worker": slot}
            for h in _RETURN_HEADERS:
                if h in rheaders:
                    extra[h] = rheaders[h]
            self._send(status, data,
                       rheaders.get("Content-Type", "application/json"),
                       extra_headers=extra)

        def _do_admin(self):
            try:
                payload = json.loads(self._read_raw_body())
                if not isinstance(payload, dict):
                    raise ValueError("admin body must be a JSON object")
                if payload.get("action") == "quota":
                    tenant = payload.get("tenant")
                    if not tenant:
                        raise ValueError("'quota' needs a 'tenant'")
                    rate = payload.get("rate")
                    fd.quota.set_quota(
                        str(tenant),
                        None if rate is None else TenantQuota(
                            rate=float(rate),
                            burst=float(payload.get("burst", 1.0))))
                    self._send_json(200, {"quota": fd.quota.describe()})
                    return
            except Exception as e:  # noqa: BLE001 — mapped to statuses
                self._send_error_for(e)
                return
            self._send_json(200, {"workers": fd.broadcast_admin(payload)})

        def _do_frontdoor_admin(self):
            try:
                payload = json.loads(self._read_raw_body())
                if not isinstance(payload, dict):
                    raise ValueError("admin body must be a JSON object")
                action = payload.get("action")
                if action == "rolling_drain":
                    self._send_json(200, fd.rolling_drain())
                elif action == "drain":
                    self._send_json(200, fd.drain(
                        payload.get("deadline_s")))
                elif action == "status":
                    self._send_json(200, fd.health())
                else:
                    raise ValueError(
                        f"unknown frontdoor action {action!r}")
            except Exception as e:  # noqa: BLE001 — mapped to statuses
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
            if n > fd.config.max_body_bytes:
                self.close_connection = True
                raise RequestTooLargeError(
                    f"request body of {n} bytes exceeds the "
                    f"{fd.config.max_body_bytes}-byte cap")
            body = self.rfile.read(n)
            if len(body) < n:
                self.close_connection = True
                raise ValueError(
                    f"truncated request body: Content-Length said {n} "
                    f"bytes, got {len(body)}")
            return body

    return Handler
