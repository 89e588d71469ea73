"""Minimal ONNX protobuf reader/writer (pure Python, stdlib only).

The PyTorch port's own copy of smalltts_tpu/onnxjax/proto.py, unchanged in
what it reads and writes.

The environment has neither the `onnx` package nor its compiled descriptors,
so this module speaks the protobuf *wire format* directly for the subset of
the ONNX schema the importer needs. Field numbers follow the public
`onnx/onnx.proto3` schema (stable since IR v3); the reader is validated in
tests against real files produced by `torch.onnx.export` (a third-party
producer), not just against our own writer.

Wire format refresher: a message is a sequence of (tag, value) pairs where
tag = (field_number << 3) | wire_type; wire types are 0 varint, 1 fixed64,
2 length-delimited (bytes / sub-message / packed repeated scalars), 5
fixed32. Repeated scalar fields must be accepted in both packed and
unpacked encodings.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- wire layer


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _signed(v: int) -> int:
    """Interpret an unsigned varint as a two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, raw_value) for every field in `buf`."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fno})")
        yield fno, wt, val


def _packed_varints(wt: int, val: object, signed: bool = True) -> List[int]:
    """A repeated int field: one varint (unpacked) or a packed blob.
    `signed=False` for uint64 fields — the two's-complement fold turned
    values >= 2^63 negative, and np.uint64 of a negative raises on
    numpy >= 2.0."""
    conv = _signed if signed else (lambda v: v)
    if wt == 0:
        return [conv(val)]
    out = []
    pos = 0
    buf = val
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(conv(v))
    return out


def _packed_floats(wt: int, val: object) -> List[float]:
    if wt == 5:
        return [struct.unpack("<f", val)[0]]
    return list(struct.unpack(f"<{len(val) // 4}f", val))


def _packed_doubles(wt: int, val: object) -> List[float]:
    if wt == 1:
        return [struct.unpack("<d", val)[0]]
    return list(struct.unpack(f"<{len(val) // 8}d", val))


def _f32(wt: int, val: object) -> float:
    if wt != 5:
        raise ValueError("expected fixed32 float")
    return struct.unpack("<f", val)[0]


# -------------------------------------------------------------- ONNX schema

# TensorProto.DataType
TENSOR_DTYPES: Dict[int, np.dtype] = {
    1: np.dtype(np.float32),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int8),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int16),
    6: np.dtype(np.int32),
    7: np.dtype(np.int64),
    9: np.dtype(np.bool_),
    10: np.dtype(np.float16),
    11: np.dtype(np.float64),
    12: np.dtype(np.uint32),
    13: np.dtype(np.uint64),
}
DTYPE_TO_ONNX = {v: k for k, v in TENSOR_DTYPES.items()}
BFLOAT16 = 16  # stored as uint16 raw bits; handled specially


@dataclass
class Tensor:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = 1
    raw_data: bytes = b""
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)
    double_data: List[float] = field(default_factory=list)
    uint64_data: List[int] = field(default_factory=list)
    string_data: List[bytes] = field(default_factory=list)
    external: Dict[str, str] = field(default_factory=dict)
    data_location: int = 0  # 0 = embedded, 1 = external file


@dataclass
class Attribute:
    name: str = ""
    type: int = 0  # AttributeProto.AttributeType
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[Tensor] = None
    g: Optional["Graph"] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)
    tensors: List[Tensor] = field(default_factory=list)
    graphs: List["Graph"] = field(default_factory=list)


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attributes: Dict[str, Attribute] = field(default_factory=dict)


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    shape: List[object] = field(default_factory=list)  # int or str (dim_param)


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: List[Tensor] = field(default_factory=list)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 0
    producer_name: str = ""
    graph: Graph = field(default_factory=Graph)
    opset: Dict[str, int] = field(default_factory=dict)

    @property
    def opset_version(self) -> int:
        """Default-domain opset (what op semantics key off)."""
        return self.opset.get("", 17)


# ------------------------------------------------------------------- parsers


def _parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    for fno, wt, val in _fields(buf):
        if fno == 1:
            t.dims.extend(_packed_varints(wt, val))
        elif fno == 2:
            t.data_type = val
        elif fno == 4:
            t.float_data.extend(_packed_floats(wt, val))
        elif fno == 5:
            t.int32_data.extend(_packed_varints(wt, val))
        elif fno == 6:
            t.string_data.append(val)
        elif fno == 7:
            t.int64_data.extend(_packed_varints(wt, val))
        elif fno == 8:
            t.name = val.decode("utf-8")
        elif fno == 9:
            t.raw_data = val
        elif fno == 10:
            t.double_data.extend(_packed_doubles(wt, val))
        elif fno == 11:
            t.uint64_data.extend(_packed_varints(wt, val, signed=False))
        elif fno == 13:  # external_data: StringStringEntryProto
            key = value = ""
            for efno, _ewt, eval_ in _fields(val):
                if efno == 1:
                    key = eval_.decode("utf-8")
                elif efno == 2:
                    value = eval_.decode("utf-8")
            t.external[key] = value
        elif fno == 14:
            t.data_location = val
    return t


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    for fno, wt, val in _fields(buf):
        if fno == 1:
            a.name = val.decode("utf-8")
        elif fno == 2:
            a.f = _f32(wt, val)
        elif fno == 3:
            a.i = _signed(val)
        elif fno == 4:
            a.s = val
        elif fno == 5:
            a.t = _parse_tensor(val)
        elif fno == 6:
            a.g = _parse_graph(val)
        elif fno == 7:
            a.floats.extend(_packed_floats(wt, val))
        elif fno == 8:
            a.ints.extend(_packed_varints(wt, val))
        elif fno == 9:
            a.strings.append(val)
        elif fno == 10:
            a.tensors.append(_parse_tensor(val))
        elif fno == 11:
            a.graphs.append(_parse_graph(val))
        elif fno == 20:
            a.type = val
    return a


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            n.inputs.append(val.decode("utf-8"))
        elif fno == 2:
            n.outputs.append(val.decode("utf-8"))
        elif fno == 3:
            n.name = val.decode("utf-8")
        elif fno == 4:
            n.op_type = val.decode("utf-8")
        elif fno == 5:
            a = _parse_attribute(val)
            n.attributes[a.name] = a
        elif fno == 7:
            n.domain = val.decode("utf-8")
    return n


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            vi.name = val.decode("utf-8")
        elif fno == 2:  # TypeProto
            for tfno, _twt, tval in _fields(val):
                if tfno == 1:  # tensor_type
                    for sfno, _swt, sval in _fields(tval):
                        if sfno == 1:
                            vi.elem_type = sval
                        elif sfno == 2:  # TensorShapeProto
                            for dfno, _dwt, dval in _fields(sval):
                                if dfno == 1:  # Dimension
                                    dim: object = None
                                    for ifno, _iwt, ival in _fields(dval):
                                        if ifno == 1:
                                            dim = _signed(ival)
                                        elif ifno == 2:
                                            dim = ival.decode("utf-8")
                                    vi.shape.append(dim)
    return vi


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            g.nodes.append(_parse_node(val))
        elif fno == 2:
            g.name = val.decode("utf-8")
        elif fno == 5:
            g.initializers.append(_parse_tensor(val))
        elif fno == 11:
            g.inputs.append(_parse_value_info(val))
        elif fno == 12:
            g.outputs.append(_parse_value_info(val))
    return g


def parse_model(buf: bytes) -> Model:
    m = Model()
    for fno, _wt, val in _fields(buf):
        if fno == 1:
            m.ir_version = val
        elif fno == 2:
            m.producer_name = val.decode("utf-8")
        elif fno == 7:
            m.graph = _parse_graph(val)
        elif fno == 8:  # OperatorSetIdProto
            domain, version = "", 0
            for ofno, _owt, oval in _fields(val):
                if ofno == 1:
                    domain = oval.decode("utf-8")
                elif ofno == 2:
                    version = _signed(oval)
            m.opset[domain] = version
    return m


def load_model(path: str) -> Model:
    with open(path, "rb") as f:
        model = parse_model(f.read())
    model._path = path  # for external-data resolution
    return model


# -------------------------------------------------------- tensor -> ndarray


def tensor_to_numpy(t: Tensor, base_dir: str = ".") -> np.ndarray:
    """Materialize a TensorProto as a numpy array (bf16 -> float32)."""
    shape = tuple(t.dims)
    if t.data_location == 1 or t.external:
        import os

        loc = t.external.get("location")
        if not loc:
            raise ValueError(f"initializer {t.name!r}: external data without location")
        offset = int(t.external.get("offset", 0))
        length = int(t.external.get("length", 0))
        with open(os.path.join(base_dir, loc), "rb") as f:
            f.seek(offset)
            raw = f.read(length) if length else f.read()
        return _raw_to_numpy(t, raw, shape)
    if t.raw_data:
        return _raw_to_numpy(t, t.raw_data, shape)
    if t.data_type == 1:
        return np.asarray(t.float_data, np.float32).reshape(shape)
    if t.data_type == 7:
        return np.asarray(t.int64_data, np.int64).reshape(shape)
    if t.data_type == 11:
        return np.asarray(t.double_data, np.float64).reshape(shape)
    if t.data_type in (12, 13):
        # per spec uint32 AND uint64 use the uint64_data field
        arr = np.asarray(t.uint64_data, np.uint64).reshape(shape)
        return arr.astype(np.uint32) if t.data_type == 12 else arr
    if t.data_type in (2, 3, 4, 5, 6, 9, 10, BFLOAT16):
        # stored in int32_data per spec (float16/bfloat16 as raw bits)
        arr = np.asarray(t.int32_data, np.int32)
        if t.data_type == 10:
            return arr.astype(np.uint16).view(np.float16).reshape(shape)
        if t.data_type == BFLOAT16:
            return _bf16_bits_to_f32(arr.astype(np.uint16)).reshape(shape)
        return arr.astype(TENSOR_DTYPES[t.data_type]).reshape(shape)
    raise ValueError(f"initializer {t.name!r}: unsupported data_type {t.data_type}")


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _raw_to_numpy(t: Tensor, raw: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    if t.data_type == BFLOAT16:
        return _bf16_bits_to_f32(np.frombuffer(raw, np.uint16)).reshape(shape)
    dt = TENSOR_DTYPES.get(t.data_type)
    if dt is None:
        raise ValueError(f"initializer {t.name!r}: unsupported data_type {t.data_type}")
    return np.frombuffer(raw, dt).reshape(shape).copy()


# ----------------------------------------------------------------- writer
# A small serializer so tests can synthesize graphs without torch, and so
# tools can re-emit imported models. Always writes raw_data for tensors and
# unpacked repeated ints (both of which every conformant reader accepts).


def _w_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _w_tag(out: bytearray, fno: int, wt: int) -> None:
    _w_varint(out, (fno << 3) | wt)


def _w_bytes(out: bytearray, fno: int, data: bytes) -> None:
    _w_tag(out, fno, 2)
    _w_varint(out, len(data))
    out.extend(data)


def _w_str(out: bytearray, fno: int, s: str) -> None:
    _w_bytes(out, fno, s.encode("utf-8"))


def _w_int(out: bytearray, fno: int, v: int) -> None:
    _w_tag(out, fno, 0)
    _w_varint(out, v)


def _w_f32(out: bytearray, fno: int, v: float) -> None:
    _w_tag(out, fno, 5)
    out.extend(struct.pack("<f", v))


def serialize_tensor(t: Tensor, base_dir: str = None) -> bytes:
    out = bytearray()
    for d in t.dims:
        _w_int(out, 1, d)
    _w_int(out, 2, t.data_type)
    if t.name:
        _w_str(out, 8, t.name)
    if t.raw_data:
        _w_bytes(out, 9, t.raw_data)
    elif t.float_data or t.int32_data or t.int64_data or t.uint64_data \
            or t.double_data or t.external or t.data_location:
        # typed-field / external payloads are legal inputs (tf2onnx emits
        # float_data); silently writing a tensor with NO bytes would corrupt
        # the copy — normalize through numpy into raw_data instead.
        # External sidecar files resolve against the MODEL's directory, which
        # the caller must supply — defaulting to cwd could silently embed
        # bytes from an unrelated same-named file (ADVICE r2).
        if (t.data_location == 1 or t.external) and base_dir is None:
            raise ValueError(
                f"tensor {t.name!r} stores external data; pass base_dir="
                "<model dir> to serialize it (cwd resolution is unsafe)")
        arr = tensor_to_numpy(t, base_dir) if base_dir is not None \
            else tensor_to_numpy(t)
        _w_bytes(out, 9, np.ascontiguousarray(arr).tobytes())
    elif int(np.prod(t.dims, dtype=np.int64)) not in (0,):
        raise ValueError(
            f"tensor {t.name!r} declares shape {tuple(t.dims)} but carries "
            "no data payload to serialize")
    return bytes(out)


def numpy_to_tensor(name: str, arr: np.ndarray) -> Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in DTYPE_TO_ONNX:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    return Tensor(
        name=name,
        dims=list(arr.shape),
        data_type=DTYPE_TO_ONNX[arr.dtype],
        raw_data=arr.tobytes(),
    )


def serialize_attribute(a: Attribute, base_dir: str = None) -> bytes:
    out = bytearray()
    _w_str(out, 1, a.name)
    if a.type == 1:
        _w_f32(out, 2, a.f)
    elif a.type == 2:
        _w_int(out, 3, a.i)
    elif a.type == 3:
        _w_bytes(out, 4, a.s)
    elif a.type == 4:
        _w_bytes(out, 5, serialize_tensor(a.t, base_dir))
    elif a.type == 6:
        for v in a.floats:
            _w_f32(out, 7, v)
    elif a.type == 7:
        for v in a.ints:
            _w_int(out, 8, v)
    elif a.type == 8:
        for v in a.strings:
            _w_bytes(out, 9, v)
    else:
        raise ValueError(f"writer: unsupported attribute type {a.type}")
    _w_int(out, 20, a.type)
    return bytes(out)


def attr_i(name: str, v: int) -> Attribute:
    return Attribute(name=name, type=2, i=v)


def attr_f(name: str, v: float) -> Attribute:
    return Attribute(name=name, type=1, f=v)


def attr_s(name: str, v: str) -> Attribute:
    return Attribute(name=name, type=3, s=v.encode("utf-8"))


def attr_ints(name: str, vs) -> Attribute:
    return Attribute(name=name, type=7, ints=list(vs))


def attr_floats(name: str, vs) -> Attribute:
    return Attribute(name=name, type=6, floats=list(vs))


def attr_t(name: str, arr: np.ndarray) -> Attribute:
    return Attribute(name=name, type=4, t=numpy_to_tensor(name, arr))


def serialize_node(n: Node, base_dir: str = None) -> bytes:
    out = bytearray()
    for i in n.inputs:
        _w_str(out, 1, i)
    for o in n.outputs:
        _w_str(out, 2, o)
    if n.name:
        _w_str(out, 3, n.name)
    _w_str(out, 4, n.op_type)
    for a in n.attributes.values():
        _w_bytes(out, 5, serialize_attribute(a, base_dir))
    return bytes(out)


def make_value_info(name: str, elem_type: int, shape) -> ValueInfo:
    return ValueInfo(name=name, elem_type=elem_type, shape=list(shape))


def serialize_value_info(vi: ValueInfo) -> bytes:
    shape_out = bytearray()
    for d in vi.shape:
        dim = bytearray()
        if isinstance(d, str):
            _w_str(dim, 2, d)
        else:
            _w_int(dim, 1, int(d))
        _w_bytes(shape_out, 1, bytes(dim))
    tt = bytearray()
    _w_int(tt, 1, vi.elem_type)
    _w_bytes(tt, 2, bytes(shape_out))
    tp = bytearray()
    _w_bytes(tp, 1, bytes(tt))
    out = bytearray()
    _w_str(out, 1, vi.name)
    _w_bytes(out, 2, bytes(tp))
    return bytes(out)


def serialize_graph(g: Graph, base_dir: str = None) -> bytes:
    out = bytearray()
    for n in g.nodes:
        _w_bytes(out, 1, serialize_node(n, base_dir))
    _w_str(out, 2, g.name or "graph")
    for t in g.initializers:
        _w_bytes(out, 5, serialize_tensor(t, base_dir))
    for vi in g.inputs:
        _w_bytes(out, 11, serialize_value_info(vi))
    for vi in g.outputs:
        _w_bytes(out, 12, serialize_value_info(vi))
    return bytes(out)


def serialize_model(m: Model, base_dir: str = None) -> bytes:
    """`base_dir` resolves external-data sidecar files; defaults to the
    directory the model was loaded from (Model._path) when available."""
    if base_dir is None and getattr(m, "_path", None):
        import os

        base_dir = os.path.dirname(os.path.abspath(m._path))
    out = bytearray()
    _w_int(out, 1, m.ir_version or 8)
    if m.producer_name:
        _w_str(out, 2, m.producer_name)
    _w_bytes(out, 7, serialize_graph(m.graph, base_dir))
    for domain, version in (m.opset or {"": 17}).items():
        op = bytearray()
        if domain:
            _w_str(op, 1, domain)
        _w_int(op, 2, version)
        _w_bytes(out, 8, bytes(op))
    return bytes(out)
