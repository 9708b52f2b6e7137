"""One preforked engine worker of the horizontal serving tier (port of
``analytics_zoo_tpu.serving.worker``).

The front door (:mod:`analytics_zoo_tpu_torch.serving.frontdoor`) spawns
N of these as subprocesses (``python -m
analytics_zoo_tpu_torch.serving.worker``); each owns a complete
:class:`~analytics_zoo_tpu_torch.serving.engine.ServingEngine` (batcher,
result cache and, on the card, its own CUDA context and bucket graphs)
behind the ordinary HTTP frontend
(:func:`~analytics_zoo_tpu_torch.serving.http.serve`) on a kernel-assigned
port. Because the worker speaks exactly the single-process HTTP surface,
the front door can proxy its response bytes verbatim: a single-worker
front door is bitwise identical to direct engine serving.

Boot protocol: build the engine from ``--spec``, start the HTTP server on
port 0, then atomically write ``--ready-file`` as JSON ``{"port", "pid",
"worker_id"}`` (tmp + ``os.replace``: the front door polls for the file
and must never read a torn write). The spec is ``module:build_engine`` or
``/path/to/file.py:build_engine``; the callable takes no arguments and
returns a fully registered engine. A spec chooses its device: one that
serves on the card and finds none raises, and the worker's boot fails.

Single-authority quota: whatever quota the spec configured is stripped
(``engine.quota.configure(QuotaConfig())``). Tenant token buckets live at
the front door only, so N workers cannot multiply a tenant's budget by N.

Lifecycle: SIGTERM → :meth:`ServingEngine.drain` (serve what is queued,
reject new work 503) → shutdown → exit 0. The front door's rolling drain
also drains through ``POST /v1/admin/rollout``'s ``drain`` action
*before* the SIGTERM, after ejecting the worker from the ring.

Chaos: with ``AZOO_FT_CHAOS=frontdoor_worker_exit`` in the worker
environment, the engine's predict path hard-kills the process
(``os._exit(43)``, after ``AZOO_FT_CHAOS_SKIP`` survivals): mid-request
from the front door's point of view, which must retry on a live worker
and respawn this one.

Fleet fabric: two opt-in extensions, both wired by the fleet door
through the environment and argv so the worker stays standalone.
``--shared-port`` binds a *second* listener on a fixed port every worker
shares (``SO_REUSEPORT`` is set by
:class:`~analytics_zoo_tpu_torch.serving.http.ZooHTTPServer`): the
kernel's multi-accept fast path for trusted clients; the ready file gains
a ``shared_port`` field. ``AZOO_FLEET_CACHE_URL`` installs a
:class:`~analytics_zoo_tpu_torch.serving.fabric.coopcache.PeerCacheClient`
as the engine result cache's ``peer_client``, so a single-flight leader
miss asks the fleet before paying a device execution
(``AZOO_FLEET_CACHE_TIMEOUT_S`` bounds the lookup, default 0.5 s).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import signal
import sys
import threading
from typing import Callable

__all__ = ["load_spec", "main"]


def load_spec(spec: str) -> Callable:
    """Resolve an engine-factory spec to its callable.

    Two forms: ``package.module:build_engine`` (imported) and
    ``/path/to/file.py:build_engine`` (loaded from the file — what the
    tests and the bench use, so a spec does not need to be
    installable)."""
    target, sep, attr = spec.rpartition(":")
    if not sep or not target or not attr:
        raise ValueError(
            f"spec {spec!r} must be 'module:callable' or "
            "'/path/to/file.py:callable'")
    if target.endswith(".py"):
        name = "_azoo_worker_spec_" + os.path.splitext(
            os.path.basename(target))[0]
        module_spec = importlib.util.spec_from_file_location(name, target)
        if module_spec is None or module_spec.loader is None:
            raise ValueError(f"cannot load spec file {target!r}")
        module = importlib.util.module_from_spec(module_spec)
        # register so dataclasses/pickling inside the spec resolve
        sys.modules[name] = module
        module_spec.loader.exec_module(module)
    else:
        module = importlib.import_module(target)
    fn = getattr(module, attr, None)
    if not callable(fn):
        raise ValueError(
            f"spec {spec!r}: {attr!r} is not a callable in {target!r}")
    return fn


def _arm_chaos(engine) -> None:
    # env-armed hard death inside the predict path: the batcher never
    # sees the request, the front door sees a dead TCP peer
    from analytics_zoo_tpu_torch.ft import chaos

    if chaos.active_point() != "frontdoor_worker_exit":
        return
    inner = engine.predict_async

    def chaotic_predict_async(*args, **kwargs):
        chaos.maybe_fail("frontdoor_worker_exit")
        return inner(*args, **kwargs)

    engine.predict_async = chaotic_predict_async


def main(argv=None) -> int:
    """Run one engine worker: build the engine from ``--spec``, strip
    its quota (the front door is the single authority), serve on port 0
    and atomically write ``--ready-file`` as ``{"port", "pid",
    "worker_id"}``; SIGTERM/SIGINT drains and exits 0. Spawned by
    :class:`~analytics_zoo_tpu_torch.serving.frontdoor.FrontDoor` as
    ``python -m analytics_zoo_tpu_torch.serving.worker``."""
    from analytics_zoo_tpu_torch.serving.http import (
        DEFAULT_MAX_BODY_BYTES,
        serve,
    )
    from analytics_zoo_tpu_torch.serving.quota import QuotaConfig

    p = argparse.ArgumentParser(
        description="Front-door engine worker.")
    p.add_argument("--spec", required=True,
                   help="engine factory: module:callable or "
                        "/path/to/file.py:callable")
    p.add_argument("--ready-file", required=True,
                   help="JSON {'port','pid','worker_id'} written "
                        "atomically once serving")
    p.add_argument("--worker-id", default="0")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-body-bytes", type=int,
                   default=DEFAULT_MAX_BODY_BYTES)
    p.add_argument("--drain-deadline-s", type=float, default=30.0)
    p.add_argument("--shared-port", type=int, default=0,
                   help="also bind this fixed SO_REUSEPORT listener "
                        "shared by every worker (0 = off) — the fleet "
                        "fabric's no-proxy fast path")
    args = p.parse_args(argv)

    if os.environ.get("AZOO_TRACE") == "1":
        # the front door exports AZOO_TRACE=1 into the worker env when
        # its own tracer is on, so one request's spans exist on both
        # sides of the process hop and the fleet-wide trace merge
        # (GET /v1/debug/traces/<id> at the front door) has something
        # to collect from every worker
        from analytics_zoo_tpu_torch.common.observability import get_tracer

        get_tracer().enable()

    engine = load_spec(args.spec)()
    # single token-bucket authority: quota is enforced at the front door
    engine.quota.configure(QuotaConfig())
    _arm_chaos(engine)

    peer_url = os.environ.get("AZOO_FLEET_CACHE_URL")
    if peer_url and engine.result_cache is not None:
        # cooperative cache (fleet fabric): on a single-flight leader
        # miss the cache asks the fleet — through this worker's own
        # front door, which knows the membership view — before paying a
        # device execution. Strictly best-effort; bounded by the timeout
        from analytics_zoo_tpu_torch.serving.fabric.coopcache import (
            PeerCacheClient,
        )

        engine.result_cache.peer_client = PeerCacheClient(
            peer_url,
            timeout_s=float(os.environ.get(
                "AZOO_FLEET_CACHE_TIMEOUT_S", "0.5")))

    srv, _thread = serve(engine, host=args.host, port=0,
                         max_body_bytes=args.max_body_bytes)
    shared_srv = None
    if args.shared_port:
        # the SO_REUSEPORT multi-accept fast path: every worker binds
        # the same fixed port (ZooHTTPServer sets SO_REUSEPORT before
        # bind) and the kernel spreads accepted connections across them
        shared_srv, _shared_thread = serve(
            engine, host=args.host, port=args.shared_port,
            max_body_bytes=args.max_body_bytes)

    stop = threading.Event()

    def _on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"port": srv.server_port, "pid": os.getpid(),
                   "worker_id": args.worker_id,
                   "shared_port": (shared_srv.server_port
                                   if shared_srv is not None else None)},
                  f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, args.ready_file)

    stop.wait()
    engine.drain(args.drain_deadline_s)
    srv.shutdown()
    if shared_srv is not None:
        shared_srv.shutdown()
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
