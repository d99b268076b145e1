"""Self-contained ONNX protobuf wire-format codec (no ``onnx`` package dependency).

Copy of ``synapseml_tpu/onnx/wire.py``: the port runs ONNX graphs op by op in
PyTorch (``importer.py``) and reads ``ModelProto`` bytes itself, without the
``onnx`` package. It implements the protobuf wire format directly for the ONNX
schema subset that matters:

    ModelProto / GraphProto / NodeProto / AttributeProto / TensorProto /
    ValueInfoProto / TypeProto / TensorShapeProto / OperatorSetIdProto

Field numbers follow onnx/onnx.proto (onnx upstream, stable since IR v3). A writer for
the same subset lets tests and benchmarks construct real ``.onnx`` files (builder.py).

One departure from the JAX package's copy: numpy has no bfloat16, and the port
takes no ``ml_dtypes``. A BFLOAT16 tensor's payload is read as ``uint16`` bits
and viewed as a CPU ``torch.bfloat16`` tensor (:func:`tensor_to_numpy` returns
that tensor for BFLOAT16, a numpy array otherwise), and :func:`numpy_to_tensor`
takes such a tensor and writes its bits. The bytes on the wire are the same.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TensorProto",
    "AttributeProto",
    "NodeProto",
    "ValueInfo",
    "GraphProto",
    "ModelProto",
    "parse_model",
    "serialize_model",
    "tensor_to_numpy",
    "numpy_to_tensor",
    "DataType",
]


# ---------------------------------------------------------------------------------
# low-level varint / wire primitives
# ---------------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, proto convention
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(data: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message buffer.

    wire types: 0 varint, 1 fixed64, 2 length-delimited (memoryview), 5 fixed32.
    """
    pos, end = 0, len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(data, pos)
        elif wt == 1:
            v = bytes(data[pos : pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(data, pos)
            v = data[pos : pos + ln]
            pos += ln
        elif wt == 5:
            v = bytes(data[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} for field {field}")
        yield field, wt, v


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(v: memoryview) -> List[int]:
    out, pos = [], 0
    while pos < len(v):
        x, pos = _read_varint(v, pos)
        out.append(_signed64(x))
    return out


def _tag(out: bytearray, field: int, wt: int) -> None:
    _write_varint(out, (field << 3) | wt)


def _put_bytes(out: bytearray, field: int, b: bytes) -> None:
    _tag(out, field, 2)
    _write_varint(out, len(b))
    out += b


def _put_str(out: bytearray, field: int, s: str) -> None:
    _put_bytes(out, field, s.encode("utf-8"))


def _put_varint_field(out: bytearray, field: int, v: int) -> None:
    _tag(out, field, 0)
    _write_varint(out, v)


# ---------------------------------------------------------------------------------
# ONNX data model (plain dataclasses)
# ---------------------------------------------------------------------------------

class DataType:
    """onnx.TensorProto.DataType enum values."""

    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    UINT32 = 12
    UINT64 = 13
    BFLOAT16 = 16

    _TO_NUMPY = {
        FLOAT: np.float32,
        UINT8: np.uint8,
        INT8: np.int8,
        UINT16: np.uint16,
        INT16: np.int16,
        INT32: np.int32,
        INT64: np.int64,
        BOOL: np.bool_,
        FLOAT16: np.float16,
        DOUBLE: np.float64,
        UINT32: np.uint32,
        UINT64: np.uint64,
    }

    @classmethod
    def to_numpy(cls, dt: int):
        """The numpy dtype of ONNX type ``dt``; BFLOAT16 has none: its storage
        dtype ``uint16`` (see :meth:`to_torch` for the value type)."""
        if dt == cls.BFLOAT16:
            return np.uint16
        try:
            return cls._TO_NUMPY[dt]
        except KeyError:
            raise ValueError(f"unsupported ONNX data_type {dt}") from None

    @classmethod
    def to_torch(cls, dt: int) -> torch.dtype:
        """The torch dtype of ONNX type ``dt`` (BFLOAT16 -> ``torch.bfloat16``)."""
        if dt == cls.BFLOAT16:
            return torch.bfloat16
        return torch.from_numpy(np.zeros(0, cls.to_numpy(dt))).dtype

    @classmethod
    def from_numpy(cls, dtype) -> int:
        if isinstance(dtype, torch.dtype):
            if dtype == torch.bfloat16:
                return cls.BFLOAT16
            dtype = torch.empty(0, dtype=dtype).numpy().dtype
        dtype = np.dtype(dtype)
        for k, v in cls._TO_NUMPY.items():
            if np.dtype(v) == dtype:
                return k
        raise ValueError(f"unsupported numpy dtype {dtype}")


@dataclasses.dataclass
class TensorProto:
    name: str = ""
    dims: List[int] = dataclasses.field(default_factory=list)
    data_type: int = DataType.FLOAT
    raw_data: bytes = b""
    float_data: List[float] = dataclasses.field(default_factory=list)
    int32_data: List[int] = dataclasses.field(default_factory=list)
    int64_data: List[int] = dataclasses.field(default_factory=list)
    double_data: List[float] = dataclasses.field(default_factory=list)
    uint64_data: List[int] = dataclasses.field(default_factory=list)
    string_data: List[bytes] = dataclasses.field(default_factory=list)
    # data_location 1 = EXTERNAL: bytes live in a side file described by the
    # external_data entries (location / offset / length), the format real
    # exporters use past protobuf's 2GB limit
    data_location: int = 0
    external_data: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AttributeProto:
    name: str = ""
    type: int = 0  # 1 FLOAT, 2 INT, 3 STRING, 4 TENSOR, 5 GRAPH, 6 FLOATS, 7 INTS, 8 STRINGS
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None
    floats: List[float] = dataclasses.field(default_factory=list)
    ints: List[int] = dataclasses.field(default_factory=list)
    strings: List[bytes] = dataclasses.field(default_factory=list)
    graphs: List["GraphProto"] = dataclasses.field(default_factory=list)
    # inside a FunctionProto body: take the value of the CALL node's
    # attribute with this name instead of a literal
    ref_attr_name: str = ""

    def value(self):
        return {
            1: self.f, 2: self.i, 3: self.s.decode("utf-8", "replace"),
            4: self.t, 5: self.g, 6: list(self.floats), 7: list(self.ints),
            8: [b.decode("utf-8", "replace") for b in self.strings], 10: list(self.graphs),
        }.get(self.type)


@dataclasses.dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    output: List[str] = dataclasses.field(default_factory=list)
    attribute: List[AttributeProto] = dataclasses.field(default_factory=list)

    def attrs(self) -> Dict[str, Any]:
        return {a.name: a.value() for a in self.attribute}


@dataclasses.dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    # each dim: int (static), str (symbolic), or None (unknown)
    shape: Optional[List[Any]] = None


@dataclasses.dataclass
class GraphProto:
    name: str = ""
    node: List[NodeProto] = dataclasses.field(default_factory=list)
    initializer: List[TensorProto] = dataclasses.field(default_factory=list)
    input: List[ValueInfo] = dataclasses.field(default_factory=list)
    output: List[ValueInfo] = dataclasses.field(default_factory=list)
    value_info: List[ValueInfo] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FunctionProto:
    """Model-local operator definition (ONNX functions, IR >= 8): nodes
    calling (domain, name) expand to the body with inputs bound and
    ``ref_attr_name`` attributes substituted from the call site."""

    name: str = ""
    domain: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    output: List[str] = dataclasses.field(default_factory=list)
    attribute: List[str] = dataclasses.field(default_factory=list)  # param names
    attribute_proto: List[AttributeProto] = dataclasses.field(
        default_factory=list)  # params with defaults
    node: List[NodeProto] = dataclasses.field(default_factory=list)
    opset_imports: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModelProto:
    ir_version: int = 8
    producer_name: str = ""
    graph: GraphProto = dataclasses.field(default_factory=GraphProto)
    opset_imports: Dict[str, int] = dataclasses.field(default_factory=dict)  # domain -> version
    functions: List[FunctionProto] = dataclasses.field(default_factory=list)

    @property
    def opset_version(self) -> int:
        return self.opset_imports.get("", 13)


# ---------------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------------

def _parse_tensor(data: memoryview) -> TensorProto:
    t = TensorProto()
    for field, wt, v in _iter_fields(data):
        if field == 1 and wt == 0:
            t.dims.append(_signed64(v))
        elif field == 1 and wt == 2:
            t.dims.extend(_packed_varints(v))
        elif field == 2:
            t.data_type = v
        elif field == 4:
            if wt == 2:
                t.float_data.extend(struct.unpack(f"<{len(v)//4}f", bytes(v)))
            else:
                t.float_data.append(struct.unpack("<f", v)[0])
        elif field == 5:
            if wt == 2:
                t.int32_data.extend(_packed_varints(v))
            else:
                t.int32_data.append(_signed64(v))
        elif field == 6:
            t.string_data.append(bytes(v))
        elif field == 7:
            if wt == 2:
                t.int64_data.extend(_packed_varints(v))
            else:
                t.int64_data.append(_signed64(v))
        elif field == 8:
            t.name = bytes(v).decode("utf-8")
        elif field == 9:
            t.raw_data = bytes(v)
        elif field == 10:
            if wt == 2:
                t.double_data.extend(struct.unpack(f"<{len(v)//8}d", bytes(v)))
            else:
                t.double_data.append(struct.unpack("<d", v)[0])
        elif field == 11:
            if wt == 2:
                t.uint64_data.extend(_packed_varints(v))
            else:
                t.uint64_data.append(v)
        elif field == 13:
            # StringStringEntryProto {key=1, value=2}
            k = val = ""
            for f2, wt2, v2 in _iter_fields(v):
                if f2 == 1:
                    k = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    val = bytes(v2).decode("utf-8")
            if k:
                t.external_data[k] = val
        elif field == 14:
            t.data_location = v
    return t


def _parse_attribute(data: memoryview) -> AttributeProto:
    a = AttributeProto()
    for field, wt, v in _iter_fields(data):
        if field == 1:
            a.name = bytes(v).decode("utf-8")
        elif field == 2:
            a.f = struct.unpack("<f", v)[0]
        elif field == 3:
            a.i = _signed64(v)
        elif field == 4:
            a.s = bytes(v)
        elif field == 5:
            a.t = _parse_tensor(v)
        elif field == 6:
            a.g = _parse_graph(v)
        elif field == 7:
            if wt == 2:
                a.floats.extend(struct.unpack(f"<{len(v)//4}f", bytes(v)))
            else:
                a.floats.append(struct.unpack("<f", v)[0])
        elif field == 8:
            if wt == 2:
                a.ints.extend(_packed_varints(v))
            else:
                a.ints.append(_signed64(v))
        elif field == 9:
            a.strings.append(bytes(v))
        elif field == 11:
            a.graphs.append(_parse_graph(v))
        elif field == 20:
            a.type = v
        elif field == 21:
            a.ref_attr_name = bytes(v).decode("utf-8")
    if a.type == 0:
        # Older exporters omit type; infer from which field is populated.
        if a.t is not None:
            a.type = 4
        elif a.g is not None:
            a.type = 5
        elif a.floats:
            a.type = 6
        elif a.ints:
            a.type = 7
        elif a.strings:
            a.type = 8
        elif a.s:
            a.type = 3
        elif a.f:
            a.type = 1
        else:
            a.type = 2
    return a


def _parse_node(data: memoryview) -> NodeProto:
    n = NodeProto()
    for field, wt, v in _iter_fields(data):
        if field == 1:
            n.input.append(bytes(v).decode("utf-8"))
        elif field == 2:
            n.output.append(bytes(v).decode("utf-8"))
        elif field == 3:
            n.name = bytes(v).decode("utf-8")
        elif field == 4:
            n.op_type = bytes(v).decode("utf-8")
        elif field == 5:
            n.attribute.append(_parse_attribute(v))
        elif field == 7:
            n.domain = bytes(v).decode("utf-8")
    return n


def _parse_value_info(data: memoryview) -> ValueInfo:
    vi = ValueInfo()
    for field, wt, v in _iter_fields(data):
        if field == 1:
            vi.name = bytes(v).decode("utf-8")
        elif field == 2:
            # TypeProto { tensor_type = 1 { elem_type = 1; shape = 2 } }
            for f2, _w2, v2 in _iter_fields(v):
                if f2 == 1:
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:
                            dims: List[Any] = []
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dv: Any = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dv = _signed64(v5)
                                        elif f5 == 2:
                                            dv = bytes(v5).decode("utf-8")
                                    dims.append(dv)
                            vi.shape = dims
    return vi


def _parse_graph(data: memoryview) -> GraphProto:
    g = GraphProto()
    for field, wt, v in _iter_fields(data):
        if field == 1:
            g.node.append(_parse_node(v))
        elif field == 2:
            g.name = bytes(v).decode("utf-8")
        elif field == 5:
            g.initializer.append(_parse_tensor(v))
        elif field == 11:
            g.input.append(_parse_value_info(v))
        elif field == 12:
            g.output.append(_parse_value_info(v))
        elif field == 13:
            g.value_info.append(_parse_value_info(v))
    return g


def parse_model(data: bytes) -> ModelProto:
    m = ModelProto()
    mv = memoryview(data)
    for field, wt, v in _iter_fields(mv):
        if field == 1:
            m.ir_version = v
        elif field == 2:
            m.producer_name = bytes(v).decode("utf-8")
        elif field == 7:
            m.graph = _parse_graph(v)
        elif field == 8:
            domain, version = "", 0
            for f2, _w2, v2 in _iter_fields(v):
                if f2 == 1:
                    domain = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    version = v2
            m.opset_imports[domain] = version
        elif field == 25:
            m.functions.append(_parse_function(v))
    return m


def _parse_function(data: memoryview) -> FunctionProto:
    f = FunctionProto()
    for field, wt, v in _iter_fields(data):
        if field == 1:
            f.name = bytes(v).decode("utf-8")
        elif field == 4:
            f.input.append(bytes(v).decode("utf-8"))
        elif field == 5:
            f.output.append(bytes(v).decode("utf-8"))
        elif field == 6:
            f.attribute.append(bytes(v).decode("utf-8"))
        elif field == 7:
            f.node.append(_parse_node(v))
        elif field == 9:
            domain, version = "", 0
            for f2, _w2, v2 in _iter_fields(v):
                if f2 == 1:
                    domain = bytes(v2).decode("utf-8")
                elif f2 == 2:
                    version = v2
            f.opset_imports[domain] = version
        elif field == 10:
            f.domain = bytes(v).decode("utf-8")
        elif field == 11:
            f.attribute_proto.append(_parse_attribute(v))
    return f


# ---------------------------------------------------------------------------------
# tensor <-> numpy
# ---------------------------------------------------------------------------------

def tensor_to_numpy(t: TensorProto, external_dir: Optional[str] = None):
    """The tensor's value: a numpy array, or for BFLOAT16 a CPU
    ``torch.bfloat16`` tensor (its ``uint16`` bits viewed as bfloat16)."""
    arr = _tensor_array(t, external_dir)
    if t.data_type == DataType.BFLOAT16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def _tensor_array(t: TensorProto, external_dir: Optional[str]) -> np.ndarray:
    np_dtype = DataType.to_numpy(t.data_type)
    shape = tuple(t.dims)
    if t.data_location == 1:  # EXTERNAL
        import os

        if external_dir is None:
            raise ValueError(
                f"tensor {t.name!r} stores its data externally "
                f"({t.external_data.get('location')!r}); load the model by "
                "path (load_model) or pass external_data_dir")
        loc = t.external_data.get("location", "")
        if not loc:
            raise ValueError(f"external tensor {t.name!r} has no 'location' "
                             "entry in external_data")
        base = os.path.realpath(external_dir)
        path = os.path.realpath(os.path.join(base, loc))
        if not path.startswith(base + os.sep):
            raise ValueError(f"external data location {loc!r} escapes the "
                             "model directory")
        offset = int(t.external_data.get("offset", 0) or 0)
        length = t.external_data.get("length")
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read(int(length)) if length else f.read()
        return np.frombuffer(buf, dtype=np_dtype).reshape(shape)
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=np_dtype)
    elif t.data_type == DataType.FLOAT and t.float_data:
        arr = np.asarray(t.float_data, dtype=np.float32)
    elif t.data_type == DataType.DOUBLE and t.double_data:
        arr = np.asarray(t.double_data, dtype=np.float64)
    elif t.data_type == DataType.INT64 and t.int64_data:
        arr = np.asarray(t.int64_data, dtype=np.int64)
    elif t.data_type in (DataType.INT32, DataType.INT16, DataType.INT8, DataType.UINT16,
                         DataType.UINT8, DataType.BOOL, DataType.FLOAT16) and t.int32_data:
        if t.data_type == DataType.FLOAT16:
            arr = np.asarray(t.int32_data, dtype=np.uint16).view(np.float16)
        else:
            arr = np.asarray(t.int32_data).astype(np_dtype)
    elif t.data_type in (DataType.UINT64, DataType.UINT32) and t.uint64_data:
        arr = np.asarray(t.uint64_data, dtype=np_dtype)
    else:
        arr = np.zeros(int(np.prod(shape)) if shape else 0, dtype=np_dtype)
    return arr.reshape(shape)


def numpy_to_tensor(name: str, arr) -> TensorProto:
    """A TensorProto of a numpy array, or of a ``torch.bfloat16`` tensor (its bits)."""
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
        bits = arr.detach().cpu().contiguous().view(torch.int16).numpy()
        return TensorProto(name=name, dims=list(bits.shape), data_type=DataType.BFLOAT16,
                           raw_data=bits.tobytes())
    # NB: np.ascontiguousarray would promote 0-d to 1-d, corrupting scalar tensors.
    arr = np.asarray(arr, order="C")
    return TensorProto(
        name=name,
        dims=list(arr.shape),
        data_type=DataType.from_numpy(arr.dtype),
        raw_data=arr.tobytes(),
    )


# ---------------------------------------------------------------------------------
# serialization (writer)
# ---------------------------------------------------------------------------------

def _ser_tensor(t: TensorProto) -> bytes:
    out = bytearray()
    for d in t.dims:
        _put_varint_field(out, 1, d)
    _put_varint_field(out, 2, t.data_type)
    if t.name:
        _put_str(out, 8, t.name)
    if t.raw_data:
        _put_bytes(out, 9, t.raw_data)
    if t.float_data:
        _put_bytes(out, 4, struct.pack(f"<{len(t.float_data)}f", *t.float_data))
    if t.int64_data:
        packed = bytearray()
        for x in t.int64_data:
            _write_varint(packed, x)
        _put_bytes(out, 7, bytes(packed))
    for k, v in t.external_data.items():  # round-trip external references
        entry = bytearray()
        _put_str(entry, 1, k)
        _put_str(entry, 2, v)
        _put_bytes(out, 13, bytes(entry))
    if t.data_location:
        _put_varint_field(out, 14, t.data_location)
    return bytes(out)


def _ser_attribute(a: AttributeProto) -> bytes:
    out = bytearray()
    _put_str(out, 1, a.name)
    if a.type == 1:
        _tag(out, 2, 5)
        out += struct.pack("<f", a.f)
    elif a.type == 2:
        _tag(out, 3, 0)
        _write_varint(out, a.i)
    elif a.type == 3:
        _put_bytes(out, 4, a.s)
    elif a.type == 4:
        _put_bytes(out, 5, _ser_tensor(a.t))
    elif a.type == 5:
        _put_bytes(out, 6, _ser_graph(a.g))
    elif a.type == 6:
        _put_bytes(out, 7, struct.pack(f"<{len(a.floats)}f", *a.floats))
    elif a.type == 7:
        packed = bytearray()
        for x in a.ints:
            _write_varint(packed, x)
        _put_bytes(out, 8, bytes(packed))
    elif a.type == 8:
        for s in a.strings:
            _put_bytes(out, 9, s)
    _put_varint_field(out, 20, a.type)
    return bytes(out)


def _ser_node(n: NodeProto) -> bytes:
    out = bytearray()
    for s in n.input:
        _put_str(out, 1, s)
    for s in n.output:
        _put_str(out, 2, s)
    if n.name:
        _put_str(out, 3, n.name)
    _put_str(out, 4, n.op_type)
    for a in n.attribute:
        _put_bytes(out, 5, _ser_attribute(a))
    if n.domain:
        _put_str(out, 7, n.domain)
    return bytes(out)


def _ser_value_info(vi: ValueInfo) -> bytes:
    shape_buf = bytearray()
    for d in vi.shape or []:
        dim = bytearray()
        if isinstance(d, int):
            _put_varint_field(dim, 1, d)
        elif isinstance(d, str):
            _put_str(dim, 2, d)
        _put_bytes(shape_buf, 1, bytes(dim))
    tensor_type = bytearray()
    _put_varint_field(tensor_type, 1, vi.elem_type)
    if vi.shape is not None:
        _put_bytes(tensor_type, 2, bytes(shape_buf))
    type_proto = bytearray()
    _put_bytes(type_proto, 1, bytes(tensor_type))
    out = bytearray()
    _put_str(out, 1, vi.name)
    _put_bytes(out, 2, bytes(type_proto))
    return bytes(out)


def _ser_graph(g: GraphProto) -> bytes:
    out = bytearray()
    for n in g.node:
        _put_bytes(out, 1, _ser_node(n))
    if g.name:
        _put_str(out, 2, g.name)
    for t in g.initializer:
        _put_bytes(out, 5, _ser_tensor(t))
    for vi in g.input:
        _put_bytes(out, 11, _ser_value_info(vi))
    for vi in g.output:
        _put_bytes(out, 12, _ser_value_info(vi))
    for vi in g.value_info:
        _put_bytes(out, 13, _ser_value_info(vi))
    return bytes(out)


def serialize_model(m: ModelProto) -> bytes:
    out = bytearray()
    _put_varint_field(out, 1, m.ir_version)
    if m.producer_name:
        _put_str(out, 2, m.producer_name)
    _put_bytes(out, 7, _ser_graph(m.graph))
    opsets = m.opset_imports or {"": 13}
    for domain, version in opsets.items():
        op = bytearray()
        if domain:
            _put_str(op, 1, domain)
        _put_varint_field(op, 2, version)
        _put_bytes(out, 8, bytes(op))
    return bytes(out)
