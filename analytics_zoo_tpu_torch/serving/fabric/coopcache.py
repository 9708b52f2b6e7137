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
shareable" and answers 404. The peer cache client is not ported yet
(ROADMAP A8).
"""

from __future__ import annotations

import io
import json
from typing import Any

import numpy as np

__all__ = ["TREE_CONTENT_TYPE", "decode_tree", "encode_tree"]

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
