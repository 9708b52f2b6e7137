"""A TensorFlow ``GraphDef`` reader on the in-repo protobuf wire codec
(:mod:`analytics_zoo_tpu_torch.common.wire`): no TensorFlow needed.

It yields the objects :class:`~analytics_zoo_tpu_torch.tfnet.GraphFunction`
reads: :class:`NodeDef` (``name``, ``op``, ``input``, ``attr``),
:class:`AttrValue` (``s``, ``i``, ``f``, ``b``, ``type``, ``shape``,
``tensor``, ``list``) and :class:`TensorProto`, whose :meth:`ndarray`
decodes the values as ``tensor_util.MakeNdarray`` does: raw little-endian
``tensor_content``, or a typed repeated field (``float_val``, ``int_val``,
``int64_val``, ``bool_val``, ``half_val`` holding fp16 or bfloat16 bits in
int32s, ...), packed or unpacked; a repeated field shorter than the shape
fills the rest with its last value, one value fills the whole shape, and
none gives zeros.

Field numbers (``tensorflow/core/framework/*.proto``): GraphDef.node 1;
NodeDef name 1, op 2, input 3, device 4, attr 5 (a ``map<string,
AttrValue>``: each entry a submessage, key 1, value 2); AttrValue list 1,
s 2, i 3, f 4, b 5, type 6, shape 7, tensor 8; TensorShapeProto dim 2
(Dim.size 1), unknown_rank 3; TensorProto dtype 1, tensor_shape 2,
tensor_content 4, float_val 5, double_val 6, int_val 7, string_val 8,
int64_val 10, bool_val 11, half_val 13, uint32_val 16, uint64_val 17.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common.wire import iter_fields, read_varint

# DataType enum -> numpy; DT_BFLOAT16 (14) decodes to float32 (numpy has
# no bfloat16): every bfloat16 value is exact in float32
DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 7: np.object_, 9: np.int64,
          10: np.bool_, 14: np.float32, 17: np.uint16, 19: np.float16,
          22: np.uint32, 23: np.uint64}


def _sint(v: int) -> int:
    """A varint as two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _varints(payloads) -> List[int]:
    """A repeated varint field's values, packed (bytes) or not (ints)."""
    out: List[int] = []
    for p in payloads:
        if isinstance(p, int):
            out.append(p)
            continue
        pos = 0
        while pos < len(p):
            v, pos = read_varint(p, pos)
            out.append(v)
    return out


def _fixed(payloads, fmt: str) -> List[float]:
    """A repeated fixed32 (``f``) or fixed64 (``d``) field, packed or not."""
    size = struct.calcsize("<" + fmt)
    raw = b"".join(payloads)
    return list(struct.unpack(f"<{len(raw) // size}{fmt}", raw))


def _fields(buf: bytes) -> Dict[int, List]:
    out: Dict[int, List] = {}
    for fnum, _wtype, val in iter_fields(buf):
        out.setdefault(fnum, []).append(val)
    return out


@dataclass
class Dim:
    size: int = 0
    name: str = ""


@dataclass
class TensorShapeProto:
    dim: List[Dim] = field(default_factory=list)
    unknown_rank: bool = False

    @classmethod
    def parse(cls, buf: bytes) -> "TensorShapeProto":
        f = _fields(buf)
        dims = []
        for d in f.get(2, []):
            df = _fields(d)
            dims.append(Dim(_sint(df.get(1, [0])[-1]),
                            df.get(2, [b""])[-1].decode()))
        return cls(dims, bool(f.get(3, [0])[-1]))

    @property
    def dims(self) -> List[int]:
        return [d.size for d in self.dim]


@dataclass
class TensorProto:
    dtype: int = 0
    tensor_shape: TensorShapeProto = field(default_factory=TensorShapeProto)
    fields: Dict[int, List] = field(default_factory=dict)

    @classmethod
    def parse(cls, buf: bytes) -> "TensorProto":
        f = _fields(buf)
        shape = (TensorShapeProto.parse(f[2][-1]) if 2 in f
                 else TensorShapeProto())
        return cls(f.get(1, [0])[-1], shape, f)

    @property
    def tensor_content(self) -> bytes:
        return b"".join(self.fields.get(4, []))

    def ndarray(self) -> np.ndarray:
        """The values as ``tensor_util.MakeNdarray`` gives them."""
        if self.dtype not in DTYPES:
            raise NotImplementedError(f"TensorProto dtype {self.dtype}")
        shape = tuple(self.tensor_shape.dims)
        n = int(np.prod(shape, dtype=np.int64))
        f = self.fields
        bf16 = self.dtype == 14
        if self.tensor_content:
            raw = self.tensor_content
            if bf16:
                bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
                return bits.view(np.float32).reshape(shape)
            dt = np.dtype(DTYPES[self.dtype]).newbyteorder("<")
            return np.frombuffer(raw, dt).astype(
                DTYPES[self.dtype]).reshape(shape)
        dtype = DTYPES[self.dtype]
        if self.dtype == 1:
            vals = np.asarray(_fixed(f.get(5, []), "f"), np.float32)
        elif self.dtype == 2:
            vals = np.asarray(_fixed(f.get(6, []), "d"), np.float64)
        elif self.dtype in (19, 14):  # fp16 / bfloat16 bits in int32s
            bits = np.asarray(_varints(f.get(13, [])), np.uint64)
            if bf16:
                vals = (bits.astype(np.uint32) << 16).view(np.float32)
            else:
                vals = bits.astype(np.uint16).view(np.float16)
        elif self.dtype == 9:
            vals = np.asarray([_sint(v) for v in _varints(f.get(10, []))],
                              np.int64)
        elif self.dtype == 10:
            vals = np.asarray(_varints(f.get(11, [])), np.bool_)
        elif self.dtype == 22:
            vals = np.asarray(_varints(f.get(16, [])), np.uint32)
        elif self.dtype == 23:
            vals = np.asarray(_varints(f.get(17, [])), np.uint64)
        elif self.dtype == 7:
            vals = np.asarray(list(f.get(8, [])), np.object_)
        else:  # int32, uint8, int16, int8, uint16: int_val
            vals = np.asarray([_sint(v) for v in _varints(f.get(7, []))],
                              np.int64).astype(dtype)
        if vals.size == 0:
            return np.zeros(shape, dtype)
        if vals.size != n:  # a short field repeats its last value
            vals = np.pad(vals, (0, n - vals.size), "edge")
        return vals.reshape(shape)


@dataclass
class ListValue:
    s: List[bytes] = field(default_factory=list)
    i: List[int] = field(default_factory=list)
    f: List[float] = field(default_factory=list)
    b: List[bool] = field(default_factory=list)
    type: List[int] = field(default_factory=list)
    shape: List[TensorShapeProto] = field(default_factory=list)
    tensor: List[TensorProto] = field(default_factory=list)

    @classmethod
    def parse(cls, buf: bytes) -> "ListValue":
        f = _fields(buf)
        return cls(
            list(f.get(2, [])), [_sint(v) for v in _varints(f.get(3, []))],
            _fixed(f.get(4, []), "f"),
            [bool(v) for v in _varints(f.get(5, []))],
            _varints(f.get(6, [])),
            [TensorShapeProto.parse(p) for p in f.get(7, [])],
            [TensorProto.parse(p) for p in f.get(8, [])])


_ONEOF = {1: "list", 2: "s", 3: "i", 4: "f", 5: "b", 6: "type", 7: "shape",
          8: "tensor", 9: "placeholder", 10: "func"}


@dataclass
class AttrValue:
    """One attribute; ``which`` names the field that is set (the proto's
    ``oneof value``), ``None`` when none is."""
    which: Optional[str] = None
    s: bytes = b""
    i: int = 0
    f: float = 0.0
    b: bool = False
    type: int = 0
    shape: Optional[TensorShapeProto] = None
    tensor: Optional[TensorProto] = None
    list: ListValue = field(default_factory=ListValue)
    placeholder: str = ""
    func_name: str = ""  # a NameAttrList's name (its attrs are not read)

    def HasField(self, name: str) -> bool:  # noqa: N802 (protobuf's name)
        return self.which == name

    @classmethod
    def parse(cls, buf: bytes) -> "AttrValue":
        a = cls()
        for fnum, _wtype, val in iter_fields(buf):
            a.which = _ONEOF.get(fnum, a.which)
            if fnum == 1:
                a.list = ListValue.parse(val)
            elif fnum == 2:
                a.s = val
            elif fnum == 3:
                a.i = _sint(val)
            elif fnum == 4:
                a.f = struct.unpack("<f", val)[0]
            elif fnum == 5:
                a.b = bool(val)
            elif fnum == 6:
                a.type = val
            elif fnum == 7:
                a.shape = TensorShapeProto.parse(val)
            elif fnum == 8:
                a.tensor = TensorProto.parse(val)
            elif fnum == 9:
                a.placeholder = val.decode()
            elif fnum == 10:
                a.func_name = _fields(val).get(1, [b""])[-1].decode()
        return a


@dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    input: List[str] = field(default_factory=list)
    device: str = ""
    attr: Dict[str, AttrValue] = field(default_factory=dict)

    @classmethod
    def parse(cls, buf: bytes) -> "NodeDef":
        n = cls()
        for fnum, _wtype, val in iter_fields(buf):
            if fnum == 1:
                n.name = val.decode()
            elif fnum == 2:
                n.op = val.decode()
            elif fnum == 3:
                n.input.append(val.decode())
            elif fnum == 4:
                n.device = val.decode()
            elif fnum == 5:  # a map entry: key 1, value 2
                entry = _fields(val)
                key = entry.get(1, [b""])[-1].decode()
                n.attr[key] = AttrValue.parse(entry.get(2, [b""])[-1])
        return n


@dataclass
class GraphDef:
    node: List[NodeDef] = field(default_factory=list)


def parse_graph_def(buf: bytes) -> GraphDef:
    """Serialized ``GraphDef`` bytes (a frozen ``.pb``) -> :class:`GraphDef`
    (function libraries and versions are not read)."""
    return GraphDef([NodeDef.parse(v) for fnum, _w, v in iter_fields(buf)
                     if fnum == 1])
