"""The cooperative result cache's wire codec (port of the codec in
``analytics_zoo_tpu.serving.fabric.coopcache``): how cached results travel
between hosts.

:func:`encode_tree` / :func:`decode_tree` are a pickle-free, bitwise-exact
codec for the nested dict/list/tuple-of-ndarray trees the serving engine
produces. Arrays ride in an ``npz`` container (``allow_pickle=False`` on
load — a malicious peer cannot execute code here), the tree structure as a
JSON skeleton referencing them by index. Unsupported leaf types (object
arrays, arbitrary Python objects) raise ``TypeError`` from
:func:`encode_tree`; the serving side treats that as "entry not
shareable" and answers 404.

:class:`PeerCacheClient` is the small HTTP client a *worker* uses on a
single-flight leader miss. It points at its own front door's
``GET /v1/fleet/cache/<key>`` (the door searches its other local workers
first, then its peer doors) with a short timeout: the cooperative layer is
best-effort, and a slow or dead peer costs at most ``timeout_s`` before
the leader executes locally.
"""

from __future__ import annotations

import io
import json
import urllib.parse
from typing import Any, Optional

import numpy as np

__all__ = ["TREE_CONTENT_TYPE", "PeerCacheClient", "decode_tree",
           "encode_tree"]

#: Content type of an encoded result tree (the fleet cache endpoints).
TREE_CONTENT_TYPE = "application/x-zoo-tree"


def encode_tree(tree: Any) -> bytes:
    """Serialize a result tree (nested dict/list/tuple of ndarrays and
    JSON scalars) to self-contained bytes.

    Arrays are stored in an npz container; the structure is a JSON
    skeleton referencing them by index, so decoding needs no pickle.
    Round-trips dtype, shape and bytes exactly. Raises ``TypeError`` on
    leaves the codec cannot carry losslessly (object arrays, numpy
    scalars, arbitrary objects) — callers treat those entries as not
    shareable."""
    flat: list = []

    def enc(node):
        if isinstance(node, np.ndarray):
            if node.dtype == object:
                raise TypeError("object arrays are not shareable")
            flat.append(np.ascontiguousarray(node))
            return {"t": "a", "i": len(flat) - 1}
        if isinstance(node, (list, tuple)):
            return {"t": "l" if isinstance(node, list) else "u",
                    "c": [enc(c) for c in node]}
        if isinstance(node, dict):
            for k in node:
                if not isinstance(k, str):
                    raise TypeError("non-string dict keys are not "
                                    "shareable")
            return {"t": "d", "c": [[k, enc(v)] for k, v in node.items()]}
        if node is None or isinstance(node, (bool, int, float, str)):
            return {"t": "s", "v": node}
        raise TypeError(
            f"unsupported result leaf type {type(node).__name__}")

    structure = enc(tree)
    payload = {f"a{i}": a for i, a in enumerate(flat)}
    payload["__tree__"] = np.frombuffer(
        json.dumps(structure).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def decode_tree(data: bytes) -> Any:
    """Inverse of :func:`encode_tree`.

    Loads with ``allow_pickle=False`` — a hostile payload can fail the
    decode (callers treat any failure as a peer miss) but can never
    execute code. Returns the reconstructed tree with private, writable
    arrays."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        structure = json.loads(bytes(z["__tree__"].tobytes()).decode())

        def dec(node):
            t = node["t"]
            if t == "a":
                return z[f"a{node['i']}"]
            if t == "l":
                return [dec(c) for c in node["c"]]
            if t == "u":
                return tuple(dec(c) for c in node["c"])
            if t == "d":
                return {k: dec(v) for k, v in node["c"]}
            if t == "s":
                return node["v"]
            raise ValueError(f"unknown tree node type {t!r}")

        return dec(structure)


class PeerCacheClient:
    """HTTP client for cooperative cache lookups, installed as
    ``ResultCache.peer_client`` on fleet workers.

    ``base_url`` is the front door's fleet-cache prefix (e.g.
    ``http://127.0.0.1:8500/v1/fleet/cache``) — the worker reaches the
    fleet *through its own door*, which knows the membership view; the
    worker itself stays fleet-oblivious. ``timeout_s`` bounds the whole
    lookup: past it the leader simply executes locally."""

    def __init__(self, base_url: str, timeout_s: float = 0.5):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        u = urllib.parse.urlsplit(self.base_url)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80
        self._path = u.path

    def fetch(self, key: str) -> Optional[Any]:
        """The cached tree for ``key`` from anywhere in the fleet, or
        ``None`` on miss / timeout / any transport or codec failure."""
        import http.client
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout_s)
        try:
            conn.request("GET", f"{self._path}/{key}",
                         headers={"Accept": TREE_CONTENT_TYPE})
            resp = conn.getresponse()
            body = resp.read()
        except (OSError, http.client.HTTPException):
            return None
        finally:
            conn.close()
        if resp.status != 200:
            return None
        try:
            return decode_tree(body)
        except Exception:   # noqa: BLE001 — corrupt peer payload = miss
            return None

    def __repr__(self) -> str:
        return (f"PeerCacheClient({self.base_url!r}, "
                f"timeout_s={self.timeout_s})")
