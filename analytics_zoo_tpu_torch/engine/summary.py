"""Metric summaries (port of ``analytics_zoo_tpu.engine.summary``, which
imports no jax): ref BigDL TrainSummary/ValidationSummary wired by
``setTensorBoard`` (Topology.scala:197-236) with scalar read-back
(``getTrainSummary(tag)``:213) for notebooks.

Scalars are appended as REAL TensorBoard event files (TFRecord-framed Event
protos — ``tensorboard --logdir <log_dir>`` renders them directly, matching
the reference's dashboard story). The encoder is dependency-free: the Event/
Summary subset needed for scalars is ~40 lines of protobuf wire format, plus
CRC32C record framing. :meth:`read_scalar` parses the same files back, so
the notebook read-path (``get_train_summary("Loss")``) needs no TensorBoard
installation.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import List, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — software table; TFRecord framing masks it.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------------------
# Protobuf wire helpers (just what Event/Summary scalars need)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(value)) + value


def _encode_scalar_event(wall: float, step: int, tag: str,
                         value: float) -> bytes:
    # Summary.Value { tag = 1; simple_value = 2 }  /  Summary { value = 1 }
    sv = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, sv)
    # Event { wall_time = 1; step = 2; summary = 5 }
    return (_field_double(1, wall) + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def _encode_version_event(wall: float) -> bytes:
    # Event { wall_time = 1; file_version = 3 }
    return _field_double(1, wall) + _field_bytes(3, b"brain.Event:2")


def _decode_events(buf: bytes):
    """Yield (step, {tag: value}, wall) from a TFRecord event file."""
    off, n = 0, len(buf)
    while off + 12 <= n:
        (length,) = struct.unpack_from("<Q", buf, off)
        payload = buf[off + 12: off + 12 + length]
        off += 12 + length + 4
        yield _parse_event(payload)


def _parse_fields(payload: bytes):
    off, n = 0, len(payload)
    while off < n:
        key, off = _read_varint(payload, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(payload, off)
        elif wire == 1:
            val = payload[off:off + 8]
            off += 8
        elif wire == 5:
            val = payload[off:off + 4]
            off += 4
        elif wire == 2:
            ln, off = _read_varint(payload, off)
            val = payload[off:off + ln]
            off += ln
        else:  # pragma: no cover — groups unused
            raise ValueError(f"unsupported wire type {wire}")
        yield num, wire, val


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _parse_event(payload: bytes):
    wall, step, scalars = 0.0, 0, {}
    for num, wire, val in _parse_fields(payload):
        if num == 1 and wire == 1:
            (wall,) = struct.unpack("<d", val)
        elif num == 2 and wire == 0:
            step = val
        elif num == 5 and wire == 2:  # summary
            for n2, w2, v2 in _parse_fields(val):
                if n2 == 1 and w2 == 2:  # Summary.Value
                    tag, simple = None, None
                    for n3, w3, v3 in _parse_fields(v2):
                        if n3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif n3 == 2 and w3 == 5:
                            (simple,) = struct.unpack("<f", v3)
                    if tag is not None and simple is not None:
                        scalars[tag] = simple
    return step, scalars, wall


# ---------------------------------------------------------------------------
# Public writers (the reference's TrainSummary / ValidationSummary shape)
# ---------------------------------------------------------------------------


class Summary:
    """TensorBoard event writer: ``add_scalar`` appends real TFRecord
    Event protos; ``read_scalar`` reads a (step, value) series back
    (ref TrainSummary/ValidationSummary, Summary.scala)."""

    kind = "summary"

    def __init__(self, log_dir: str, app_name: str):
        self.dir = os.path.join(log_dir, app_name, self.kind)
        os.makedirs(self.dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(self.dir, fname)
        self._fh = open(self.path, "ab")
        self._fh.write(_tfrecord(_encode_version_event(time.time())))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        """Append one scalar Event proto (tag, value, step)."""
        self._fh.write(_tfrecord(
            _encode_scalar_event(time.time(), int(step), tag, float(value))))
        self._fh.flush()

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """All (step, value) pairs for ``tag`` across this dir's event files
        (ref ``getTrainSummary(tag)``, Topology.scala:213)."""
        out = []
        for fname in sorted(os.listdir(self.dir)):
            if "tfevents" not in fname:
                continue
            with open(os.path.join(self.dir, fname), "rb") as f:
                buf = f.read()
            for step, scalars, _wall in _decode_events(buf):
                if tag in scalars:
                    out.append((step, scalars[tag]))
        return out

    def close(self):
        """Flush and close the event file."""
        self._fh.close()


class TrainSummary(Summary):
    """Training-side summary (Loss/Throughput/LearningRate scalars);
    attach with ``Estimator.set_tensorboard`` (ref TrainSummary)."""

    kind = "train"


class ValidationSummary(Summary):
    """Validation-side summary (one scalar per metric per epoch);
    attach with ``Estimator.set_tensorboard`` (ref ValidationSummary)."""

    kind = "validation"
