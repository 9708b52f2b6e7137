"""Minimal protobuf wire-format reader (port of
``analytics_zoo_tpu.common.wire``) under the self-contained proto parsers
(onnx/proto.py's ONNX codec, caffe_import.py's NetParameter reader). One
codec, two schemas: the schemas stay where their domain lives, the
byte-level walking lives here.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

WireValue = Union[int, bytes]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, WireValue]]:
    """Yield (field_number, wire_type, value): varints as ints, everything
    else (length-delimited, fixed32/64) as raw bytes for the caller's
    schema to interpret."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val
