"""Self-contained ONNX protobuf codec (port of ``analytics_zoo_tpu.onnx.proto``,
a copy; no ``onnx`` package needed).

Implements just enough of the protobuf wire format to read and write the
ONNX ``ModelProto`` subset the importer consumes (graph, nodes, attributes,
initializers, value infos). Ref: pyzoo/zoo/pipeline/api/onnx — there the
``onnx`` python package supplies the proto classes; here a ~200-line codec
replaces that dependency.

Wire format: each field is a varint key ``(field_number << 3) | wire_type``
followed by a payload; wire types used by ONNX are 0 (varint), 1 (64-bit),
2 (length-delimited), 5 (32-bit).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# -- low-level wire codec ----------------------------------------------------


from analytics_zoo_tpu_torch.common.wire import iter_fields, read_varint as _read_varint


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def parse_fields(buf: bytes) -> Dict[int, List]:
    """Generic pass: field_number -> list of raw payloads (ints or bytes)."""
    fields: Dict[int, List] = {}
    for fnum, _wtype, val in iter_fields(buf):
        fields.setdefault(fnum, []).append(val)
    return fields


def _field(fields, n, default=None):
    v = fields.get(n)
    return v[0] if v else default


def _sint(v: int) -> int:
    """Interpret a varint as two's-complement int64 (negative attr ints)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def emit(fnum: int, wtype: int, payload) -> bytes:
    key = _write_varint((fnum << 3) | wtype)
    if wtype == 0:
        return key + _write_varint(payload & ((1 << 64) - 1))
    if wtype == 2:
        return key + _write_varint(len(payload)) + payload
    if wtype == 5:
        return key + payload
    if wtype == 1:
        return key + payload
    raise ValueError(wtype)


# -- ONNX data types ---------------------------------------------------------

# TensorProto.DataType -> numpy (the subset the zoo importer supports)
DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


@dataclass
class Attribute:
    name: str
    value: object   # int/float/bytes/np.ndarray/list


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]
    name: str = ""


@dataclass
class Graph:
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Optional[Tuple]]]   # (name, shape or None)
    outputs: List[str]
    name: str = ""


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = parse_fields(buf)
    dims = [_sint(d) for d in f.get(1, [])]
    dtype_code = _field(f, 2, 1)
    name = _field(f, 8, b"").decode()
    np_dtype = DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor dtype code {dtype_code}")
    raw = _field(f, 9)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    elif 4 in f:   # float_data (packed or repeated)
        vals = []
        for item in f[4]:
            if isinstance(item, bytes):
                vals.extend(struct.unpack(f"<{len(item) // 4}f", item))
            else:
                vals.append(struct.unpack("<f", struct.pack("<I", item))[0])
        arr = np.asarray(vals, np.float32).reshape(dims)
    elif 7 in f:   # int64_data
        vals = []
        for item in f[7]:
            if isinstance(item, bytes):
                pos = 0
                while pos < len(item):
                    v, pos = _read_varint(item, pos)
                    vals.append(_sint(v))
            else:
                vals.append(_sint(item))
        arr = np.asarray(vals, np.int64).reshape(dims)
    elif 5 in f:   # int32_data
        vals = []
        for item in f[5]:
            if isinstance(item, bytes):
                pos = 0
                while pos < len(item):
                    v, pos = _read_varint(item, pos)
                    vals.append(np.int32(np.uint32(v & 0xFFFFFFFF)))
            else:
                vals.append(np.int32(np.uint32(item & 0xFFFFFFFF)))
        arr = np.asarray(vals, np.int32).reshape(dims)
    else:
        arr = np.zeros(dims, np_dtype)
    return name, arr.astype(np_dtype, copy=False)


def _parse_attribute(buf: bytes) -> Attribute:
    f = parse_fields(buf)
    name = _field(f, 1, b"").decode()
    atype = _field(f, 20)
    # proto3 implicit presence: real serializers omit a scalar field whose
    # value equals the default (0 / 0.0 / ""), so every scalar read needs one.
    if atype == 1 or (atype is None and 2 in f):      # FLOAT
        return Attribute(name, struct.unpack("<f", _field(f, 2, b"\0\0\0\0"))[0])
    if atype == 2 or (atype is None and 3 in f):      # INT
        return Attribute(name, _sint(_field(f, 3, 0)))
    if atype == 3 or (atype is None and 4 in f):      # STRING
        return Attribute(name, _field(f, 4, b""))
    if atype == 4 or (atype is None and 5 in f):      # TENSOR
        return Attribute(name, parse_tensor(_field(f, 5))[1])
    if atype == 6 or (atype is None and 7 in f):      # FLOATS
        vals = []
        for item in f.get(7, []):
            if isinstance(item, bytes):
                vals.extend(struct.unpack(f"<{len(item) // 4}f", item))
            else:
                vals.append(struct.unpack("<f", struct.pack("<I", item))[0])
        return Attribute(name, vals)
    if atype == 7 or (atype is None and 8 in f):      # INTS
        vals = []
        for item in f.get(8, []):
            if isinstance(item, bytes):
                pos = 0
                while pos < len(item):
                    v, pos = _read_varint(item, pos)
                    vals.append(_sint(v))
            else:
                vals.append(_sint(item))
        return Attribute(name, vals)
    if atype == 8 or (atype is None and 9 in f):      # STRINGS
        return Attribute(name, list(f.get(9, [])))
    return Attribute(name, None)


def _parse_value_info(buf: bytes) -> Tuple[str, Optional[Tuple]]:
    f = parse_fields(buf)
    name = _field(f, 1, b"").decode()
    tbuf = _field(f, 2)
    if tbuf is None:
        return name, None
    tt = _field(parse_fields(tbuf), 1)
    if tt is None:
        return name, None
    shape_buf = _field(parse_fields(tt), 2)
    if shape_buf is None:
        return name, None
    dims = []
    for dim in parse_fields(shape_buf).get(1, []):
        df = parse_fields(dim)
        dims.append(_sint(_field(df, 1)) if 1 in df else None)
    return name, tuple(dims)


def _parse_node(buf: bytes) -> Node:
    f = parse_fields(buf)
    return Node(
        op_type=_field(f, 4, b"").decode(),
        inputs=[b.decode() for b in f.get(1, [])],
        outputs=[b.decode() for b in f.get(2, [])],
        attrs={a.name: a.value
               for a in (_parse_attribute(b) for b in f.get(5, []))},
        name=_field(f, 3, b"").decode(),
    )


def parse_graph(buf: bytes) -> Graph:
    f = parse_fields(buf)
    inits = dict(parse_tensor(b) for b in f.get(5, []))
    return Graph(
        nodes=[_parse_node(b) for b in f.get(1, [])],
        initializers=inits,
        inputs=[_parse_value_info(b) for b in f.get(11, [])],
        outputs=[_parse_value_info(b)[0] for b in f.get(12, [])],
        name=_field(f, 2, b"").decode(),
    )


def parse_model(buf: bytes) -> Graph:
    """ModelProto bytes -> Graph (field 7 = graph)."""
    f = parse_fields(buf)
    gbuf = _field(f, 7)
    if gbuf is None:
        raise ValueError("ModelProto has no graph")
    return parse_graph(gbuf)


# -- encoder (tests + export round-trips) ------------------------------------


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    # NOT ascontiguousarray: that promotes 0-d arrays to shape (1,), and
    # tobytes() below copies as needed anyway.
    arr = np.asarray(arr)
    out = b""
    for d in arr.shape:
        out += emit(1, 0, d)
    out += emit(2, 0, DTYPE_CODES[arr.dtype])
    out += emit(8, 2, name.encode())
    out += emit(9, 2, arr.tobytes())
    return out


def _encode_attr(name: str, value) -> bytes:
    out = emit(1, 2, name.encode())
    if isinstance(value, float):
        return out + emit(2, 5, struct.pack("<f", value)) + emit(20, 0, 1)
    if isinstance(value, (bool, int, np.integer)):
        return out + emit(3, 0, int(value)) + emit(20, 0, 2)
    if isinstance(value, bytes):
        return out + emit(4, 2, value) + emit(20, 0, 3)
    if isinstance(value, str):
        return out + emit(4, 2, value.encode()) + emit(20, 0, 3)
    if isinstance(value, np.ndarray):
        return out + emit(5, 2, encode_tensor(name + "_t", value)) + emit(20, 0, 4)
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, float) for v in value):
            for v in value:
                out += emit(7, 5, struct.pack("<f", v))
            return out + emit(20, 0, 6)
        for v in value:
            out += emit(8, 0, int(v))
        return out + emit(20, 0, 7)
    raise TypeError(f"attr {name}: {type(value)}")


def encode_node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += emit(1, 2, i.encode())
    for o in outputs:
        out += emit(2, 2, o.encode())
    if name:
        out += emit(3, 2, name.encode())
    out += emit(4, 2, op_type.encode())
    for k, v in attrs.items():
        out += emit(5, 2, _encode_attr(k, v))
    return out


def _encode_value_info(name: str, shape, dtype_code: int = 1) -> bytes:
    dims = b""
    for d in shape:
        dims += emit(1, 2, emit(1, 0, d) if d is not None else emit(2, 2, b"N"))
    tensor_type = emit(1, 0, dtype_code) + emit(2, 2, dims)
    return emit(1, 2, name.encode()) + emit(2, 2, emit(1, 2, tensor_type))


def encode_model(nodes: List[bytes], initializers: Dict[str, np.ndarray],
                 inputs: List[Tuple[str, Tuple]], outputs: List[str],
                 graph_name: str = "g", opset: int = 13) -> bytes:
    g = b""
    for n in nodes:
        g += emit(1, 2, n)
    g += emit(2, 2, graph_name.encode())
    for name, arr in initializers.items():
        g += emit(5, 2, encode_tensor(name, arr))
    for name, shape in inputs:
        g += emit(11, 2, _encode_value_info(name, shape))
    for name in outputs:
        g += emit(12, 2, _encode_value_info(name, ()))
    opset_id = emit(2, 0, opset)
    return emit(1, 0, 8) + emit(8, 2, opset_id) + emit(7, 2, g)
