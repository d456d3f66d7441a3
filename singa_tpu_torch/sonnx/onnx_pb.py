"""Self-contained ONNX protobuf wire codec (the port's copy of
singa_tpu/sonnx/onnx_pb.py, pure Python and numpy).

The reference's sonnx (python/singa/sonnx.py) depends on the `onnx` pip
package; this module needs none: it implements the subset of the ONNX IR
proto needed for (de)serializing models (ModelProto, GraphProto,
NodeProto, TensorProto, AttributeProto, ValueInfoProto) as a minimal
proto3 wire-format codec. Files written here load in stock
`onnx`/onnxruntime and vice versa; the bytes are the contract, equal to
the JAX package's codec's for the same message.
"""

from __future__ import annotations

import struct

import numpy as np

# ---- wire primitives -----------------------------------------------------

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


def _enc_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's complement, 10-byte encoding
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 63:
                result -= 1 << 64
            return result, pos
        shift += 7


def _enc_tag(num: int, wt: int) -> bytes:
    return _enc_varint((num << 3) | wt)


def _enc_len(num: int, payload: bytes) -> bytes:
    return _enc_tag(num, _LEN) + _enc_varint(len(payload)) + payload


# ---- field spec ----------------------------------------------------------

class F:
    """Field descriptor: number, python attr name, kind, repeated?"""

    def __init__(self, num, name, kind, repeated=False, msg=None):
        self.num, self.name, self.kind = num, name, kind
        self.repeated = repeated
        self.msg = msg  # message class for kind == "msg"


class Message:
    """Base for ONNX messages; subclasses define FIELDS: list[F]."""

    FIELDS: list = []

    def __init__(self, **kwargs):
        for f in self.FIELDS:
            setattr(self, f.name, [] if f.repeated else _default(f))
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- encode ------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            val = getattr(self, f.name)
            if f.repeated:
                if not val:
                    continue
                if f.kind in ("int", "enum"):
                    payload = b"".join(_enc_varint(int(v)) for v in val)
                    out += _enc_len(f.num, payload)  # packed
                elif f.kind == "float":
                    out += _enc_len(f.num, struct.pack(f"<{len(val)}f", *val))
                elif f.kind == "double":
                    out += _enc_len(f.num, struct.pack(f"<{len(val)}d", *val))
                elif f.kind == "string":
                    for v in val:
                        out += _enc_len(f.num, v.encode()
                                        if isinstance(v, str) else v)
                elif f.kind == "bytes":
                    for v in val:
                        out += _enc_len(f.num, bytes(v))
                elif f.kind == "msg":
                    for v in val:
                        out += _enc_len(f.num, v.SerializeToString())
            else:
                if val is None or (f.kind in ("int", "enum") and val == 0):
                    continue
                if f.kind in ("int", "enum"):
                    out += _enc_tag(f.num, _VARINT) + _enc_varint(int(val))
                elif f.kind == "float":
                    if val != 0.0:
                        out += _enc_tag(f.num, _FIXED32) + struct.pack("<f", val)
                elif f.kind == "double":
                    if val != 0.0:
                        out += _enc_tag(f.num, _FIXED64) + struct.pack("<d", val)
                elif f.kind == "string":
                    if val:
                        out += _enc_len(f.num, val.encode()
                                        if isinstance(val, str) else val)
                elif f.kind == "bytes":
                    if val:
                        out += _enc_len(f.num, bytes(val))
                elif f.kind == "msg":
                    out += _enc_len(f.num, val.SerializeToString())
        return bytes(out)

    # -- decode ------------------------------------------------------------
    @classmethod
    def FromString(cls, data: bytes):
        obj = cls()
        obj._parse(memoryview(data))
        return obj

    def ParseFromString(self, data: bytes):
        self._parse(memoryview(data))
        return self

    def _parse(self, buf: memoryview):
        fields = {f.num: f for f in self.FIELDS}
        pos, end = 0, len(buf)
        while pos < end:
            tag, pos = _dec_varint(buf, pos)
            num, wt = tag >> 3, tag & 7
            f = fields.get(num)
            if wt == _VARINT:
                v, pos = _dec_varint(buf, pos)
                if f is not None:
                    if f.repeated:
                        getattr(self, f.name).append(v)
                    else:
                        setattr(self, f.name, v)
            elif wt == _FIXED64:
                raw = bytes(buf[pos:pos + 8])
                pos += 8
                if f is not None:
                    v = struct.unpack("<d", raw)[0]
                    if f.repeated:
                        getattr(self, f.name).append(v)
                    else:
                        setattr(self, f.name, v)
            elif wt == _FIXED32:
                raw = bytes(buf[pos:pos + 4])
                pos += 4
                if f is not None:
                    v = struct.unpack("<f", raw)[0]
                    if f.repeated:
                        getattr(self, f.name).append(v)
                    else:
                        setattr(self, f.name, v)
            elif wt == _LEN:
                ln, pos = _dec_varint(buf, pos)
                raw = buf[pos:pos + ln]
                pos += ln
                if f is None:
                    continue
                if f.kind == "msg":
                    m = f.msg()
                    m._parse(raw)
                    if f.repeated:
                        getattr(self, f.name).append(m)
                    else:
                        setattr(self, f.name, m)
                elif f.kind == "string":
                    s = bytes(raw).decode("utf-8", "replace")
                    if f.repeated:
                        getattr(self, f.name).append(s)
                    else:
                        setattr(self, f.name, s)
                elif f.kind == "bytes":
                    b = bytes(raw)
                    if f.repeated:
                        getattr(self, f.name).append(b)
                    else:
                        setattr(self, f.name, b)
                elif f.kind in ("int", "enum"):  # packed repeated varint
                    p = 0
                    vals = getattr(self, f.name)
                    while p < ln:
                        v, p = _dec_varint(raw, p)
                        vals.append(v)
                elif f.kind == "float":  # packed fixed32
                    vals = getattr(self, f.name)
                    vals.extend(struct.unpack(f"<{ln // 4}f", bytes(raw)))
                elif f.kind == "double":
                    vals = getattr(self, f.name)
                    vals.extend(struct.unpack(f"<{ln // 8}d", bytes(raw)))
            else:
                raise ValueError(f"bad wire type {wt} at {pos}")

    def __repr__(self):
        parts = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if v not in (None, [], "", 0, b"", 0.0):
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _default(f: F):
    return {"int": 0, "enum": 0, "float": 0.0, "double": 0.0,
            "string": "", "bytes": b"", "msg": None}[f.kind]


# ---- ONNX messages (field numbers from the public onnx.proto) ------------

class StringStringEntryProto(Message):
    FIELDS = [F(1, "key", "string"), F(2, "value", "string")]


class TensorProto(Message):
    # DataType enum values
    FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = range(1, 10)
    FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
    BFLOAT16 = 16

    FIELDS = [
        F(1, "dims", "int", repeated=True),
        F(2, "data_type", "enum"),
        F(4, "float_data", "float", repeated=True),
        F(5, "int32_data", "int", repeated=True),
        F(6, "string_data", "bytes", repeated=True),
        F(7, "int64_data", "int", repeated=True),
        F(8, "name", "string"),
        F(9, "raw_data", "bytes"),
        F(10, "double_data", "double", repeated=True),
        F(11, "uint64_data", "int", repeated=True),
        F(12, "doc_string", "string"),
    ]


_NP2ONNX = {
    np.dtype(np.float32): TensorProto.FLOAT,
    np.dtype(np.uint8): TensorProto.UINT8,
    np.dtype(np.int8): TensorProto.INT8,
    np.dtype(np.uint16): TensorProto.UINT16,
    np.dtype(np.int16): TensorProto.INT16,
    np.dtype(np.int32): TensorProto.INT32,
    np.dtype(np.int64): TensorProto.INT64,
    np.dtype(np.bool_): TensorProto.BOOL,
    np.dtype(np.float16): TensorProto.FLOAT16,
    np.dtype(np.float64): TensorProto.DOUBLE,
    np.dtype(np.uint32): TensorProto.UINT32,
    np.dtype(np.uint64): TensorProto.UINT64,
}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}


def tensor_to_numpy(t: TensorProto) -> np.ndarray:
    shape = tuple(t.dims)
    if t.data_type == TensorProto.BFLOAT16:
        # raw bf16: upcast via uint16 -> float32
        u = np.frombuffer(t.raw_data, dtype=np.uint16)
        return (u.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    dt = _ONNX2NP.get(t.data_type)
    if dt is None:
        raise ValueError(f"unsupported TensorProto dtype {t.data_type}")
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=dt).reshape(shape).copy()
    if t.data_type == TensorProto.FLOAT:
        return np.asarray(t.float_data, np.float32).reshape(shape)
    if t.data_type == TensorProto.DOUBLE:
        return np.asarray(t.double_data, np.float64).reshape(shape)
    if t.data_type == TensorProto.INT64:
        return np.asarray(t.int64_data, np.int64).reshape(shape)
    if t.data_type in (TensorProto.INT32, TensorProto.INT16, TensorProto.INT8,
                       TensorProto.UINT16, TensorProto.UINT8, TensorProto.BOOL,
                       TensorProto.FLOAT16):
        arr = np.asarray(t.int32_data, np.int32)
        if t.data_type == TensorProto.FLOAT16:
            return arr.astype(np.uint16).view(np.float16).reshape(shape)
        return arr.astype(dt).reshape(shape)
    if t.data_type in (TensorProto.UINT32, TensorProto.UINT64):
        return np.asarray(t.uint64_data, np.uint64).astype(dt).reshape(shape)
    raise ValueError(f"empty tensor data for dtype {t.data_type}")


def numpy_to_tensor(arr: np.ndarray, name: str = "") -> TensorProto:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP2ONNX:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    return TensorProto(name=name, dims=list(arr.shape),
                       data_type=_NP2ONNX[arr.dtype],
                       raw_data=arr.tobytes())


class Dimension(Message):
    FIELDS = [F(1, "dim_value", "int"), F(2, "dim_param", "string")]


class TensorShapeProto(Message):
    FIELDS = [F(1, "dim", "msg", repeated=True, msg=Dimension)]


class TypeProto_Tensor(Message):
    FIELDS = [F(1, "elem_type", "enum"),
              F(2, "shape", "msg", msg=TensorShapeProto)]


class TypeProto(Message):
    FIELDS = [F(1, "tensor_type", "msg", msg=TypeProto_Tensor)]


class ValueInfoProto(Message):
    FIELDS = [F(1, "name", "string"), F(2, "type", "msg", msg=TypeProto),
              F(3, "doc_string", "string")]


def make_value_info(name, elem_type, shape):
    dims = [Dimension(dim_value=int(d)) if isinstance(d, (int, np.integer))
            else Dimension(dim_param=str(d)) for d in shape]
    return ValueInfoProto(name=name, type=TypeProto(
        tensor_type=TypeProto_Tensor(elem_type=elem_type,
                                     shape=TensorShapeProto(dim=dims))))


class AttributeProto(Message):
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH = range(6)
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = range(6, 11)

    FIELDS = [
        F(1, "name", "string"),
        F(2, "f", "float"),
        F(3, "i", "int"),
        F(4, "s", "bytes"),
        F(5, "t", "msg", msg=TensorProto),
        F(7, "floats", "float", repeated=True),
        F(8, "ints", "int", repeated=True),
        F(9, "strings", "bytes", repeated=True),
        F(10, "tensors", "msg", repeated=True, msg=TensorProto),
        F(13, "doc_string", "string"),
        F(20, "type", "enum"),
    ]

    def value(self):
        """Python value by declared (or inferred) type."""
        ty = self.type
        if ty == self.FLOAT or (ty == 0 and self.f):
            return self.f
        if ty == self.INT:
            return self.i
        if ty == self.STRING or (ty == 0 and self.s):
            return self.s.decode() if isinstance(self.s, bytes) else self.s
        if ty == self.TENSOR or (ty == 0 and self.t is not None):
            return tensor_to_numpy(self.t)
        if ty == self.FLOATS or (ty == 0 and self.floats):
            return list(self.floats)
        if ty == self.INTS or (ty == 0 and self.ints):
            return list(self.ints)
        if ty == self.STRINGS or (ty == 0 and self.strings):
            return [s.decode() if isinstance(s, bytes) else s
                    for s in self.strings]
        return self.i  # bare int (possibly 0)


def make_attribute(name, value) -> AttributeProto:
    a = AttributeProto(name=name)
    if isinstance(value, bool):
        a.i, a.type = int(value), AttributeProto.INT
    elif isinstance(value, (int, np.integer)):
        a.i, a.type = int(value), AttributeProto.INT
    elif isinstance(value, (float, np.floating)):
        a.f, a.type = float(value), AttributeProto.FLOAT
    elif isinstance(value, str):
        a.s, a.type = value.encode(), AttributeProto.STRING
    elif isinstance(value, bytes):
        a.s, a.type = value, AttributeProto.STRING
    elif isinstance(value, np.ndarray):
        a.t, a.type = numpy_to_tensor(value), AttributeProto.TENSOR
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            a.ints, a.type = [int(v) for v in value], AttributeProto.INTS
        elif all(isinstance(v, (float, int, np.floating)) for v in value):
            a.floats, a.type = [float(v) for v in value], AttributeProto.FLOATS
        elif all(isinstance(v, str) for v in value):
            a.strings = [v.encode() for v in value]
            a.type = AttributeProto.STRINGS
        else:
            raise ValueError(f"mixed attribute list for {name}")
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return a


class NodeProto(Message):
    FIELDS = [
        F(1, "input", "string", repeated=True),
        F(2, "output", "string", repeated=True),
        F(3, "name", "string"),
        F(4, "op_type", "string"),
        F(5, "attribute", "msg", repeated=True, msg=AttributeProto),
        F(6, "doc_string", "string"),
        F(7, "domain", "string"),
    ]

    def attrs(self) -> dict:
        return {a.name: a.value() for a in self.attribute}


def make_node(op_type, inputs, outputs, name="", **attrs) -> NodeProto:
    return NodeProto(op_type=op_type, input=list(inputs),
                     output=list(outputs), name=name,
                     attribute=[make_attribute(k, v)
                                for k, v in attrs.items() if v is not None])


class GraphProto(Message):
    FIELDS = [
        F(1, "node", "msg", repeated=True, msg=NodeProto),
        F(2, "name", "string"),
        F(5, "initializer", "msg", repeated=True, msg=TensorProto),
        F(10, "doc_string", "string"),
        F(11, "input", "msg", repeated=True, msg=ValueInfoProto),
        F(12, "output", "msg", repeated=True, msg=ValueInfoProto),
        F(13, "value_info", "msg", repeated=True, msg=ValueInfoProto),
    ]


class OperatorSetIdProto(Message):
    FIELDS = [F(1, "domain", "string"), F(2, "version", "int")]


class ModelProto(Message):
    FIELDS = [
        F(1, "ir_version", "int"),
        F(2, "producer_name", "string"),
        F(3, "producer_version", "string"),
        F(4, "domain", "string"),
        F(5, "model_version", "int"),
        F(6, "doc_string", "string"),
        F(7, "graph", "msg", msg=GraphProto),
        F(8, "opset_import", "msg", repeated=True, msg=OperatorSetIdProto),
        F(14, "metadata_props", "msg", repeated=True,
          msg=StringStringEntryProto),
    ]


def load_model(path: str) -> ModelProto:
    with open(path, "rb") as f:
        return ModelProto.FromString(f.read())


def save_model(model: ModelProto, path: str):
    with open(path, "wb") as f:
        f.write(model.SerializeToString())
