"""Minimal ONNX initializer extractor (pure Python protobuf wire parsing),
a copy of the JAX package's io/onnx_reader.py.

The reference runs its face stack (SCRFD detector + ArcFace embedder) as
insightface ONNX graphs through onnxruntime. The port needs neither onnx
nor onnxruntime: weight conversion parses the ModelProto wire format
directly, and only the graph.initializer TensorProtos (name, dims,
data_type, raw_data), enough to lift every weight out of w600k_r50.onnx /
SCRFD packs into numpy. `write_onnx_initializers` writes such a file.

Field numbers (onnx.proto):
  ModelProto.graph = 7; GraphProto.initializer = 5;
  TensorProto: dims=1, data_type=2, float_data=4, int64_data=7,
               name=8, raw_data=9.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


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


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's fields."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:    # 64-bit
            val = bytes(buf[pos:pos + 8]); pos += 8
        elif wire == 2:    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]; pos += ln
        elif wire == 5:    # 32-bit
            val = bytes(buf[pos:pos + 4]); pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview):
    dims, dtype, name, raw = [], 1, "", b""
    float_data, int64_data = [], []
    for field, wire, val in _fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:
            dtype = val
        elif field == 4:
            if wire == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:  # packed floats
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif field == 7:
            if wire == 0:
                int64_data.append(val)
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(v)
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = bytes(val)
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Extract {initializer_name: ndarray} from an .onnx file."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(data):       # ModelProto
        if field == 7 and wire == 2:              # graph
            for gf, gw, gval in _fields(val):     # GraphProto
                if gf == 5 and gw == 2:           # initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


# -- writer (synthesis/testing) ----------------------------------------------

_DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
                np.dtype(np.int8): 3, np.dtype(np.int32): 6,
                np.dtype(np.int64): 7, np.dtype(np.float16): 10,
                np.dtype(np.float64): 11}


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int, payload: bytes) -> bytes:
    tag = _varint((num << 3) | wire)
    if wire == 2:
        return tag + _varint(len(payload)) + payload
    return tag + payload


def write_onnx_initializers(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: ndarray} as a minimal ModelProto whose graph carries the
    tensors as initializers — the inverse of read_onnx_initializers. Used to
    fabricate insightface-pack-shaped .onnx files (apps/validate
    --synthesize) so the ONNX read path is exercised end-to-end without
    onnx/onnxruntime installed."""
    graph = b""
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        code = _DTYPE_CODES.get(arr.dtype)
        if code is None:
            arr = arr.astype(np.float32)
            code = 1
        msg = b""
        for d in arr.shape:
            msg += _field(1, 0, _varint(d))
        msg += _field(2, 0, _varint(code))
        msg += _field(8, 2, name.encode("utf-8"))
        msg += _field(9, 2, arr.tobytes())
        graph += _field(5, 2, msg)
    with open(path, "wb") as f:
        f.write(_field(7, 2, graph))
