"""Checkpoint file reading: safetensors, torch pickles and ONNX initializers,
as numpy dicts. Counterpart of the JAX package's io/safetensors_reader.py
(the reference's two load paths, safetensors and torch.load of a .bin,
pipline_StableDiffusion_ConsistentID.py:125-136, plus HF sharded-checkpoint
index files).

The safetensors format is read and written here with json and numpy, not
through the `safetensors` package: 8 bytes of little-endian header length,
a JSON header {name: {dtype, shape, data_offsets}} (and an optional
"__metadata__"), then the raw little-endian tensor bytes. bf16 is read as
uint16 and widened to fp32, as the JAX reader's numpy dicts carry no bf16.

`iter_safetensors_torch` and `write_safetensors_torch` read and write torch
tensors in their own dtype (bf16 included), one tensor at a time, so a 14
GB bf16 checkpoint (the LLaVA-1.5 captioner's) never takes an fp32 copy;
`checkpoint_files` lists an HF sharded checkpoint's files.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    return (raw.astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dtype = info["dtype"]
        shape = tuple(info["shape"])
        if dtype == "BF16":
            raw = np.frombuffer(body[start:end], "<u2")
            out[name] = _bf16_to_f32(raw).reshape(shape)
        elif dtype in _ST_DTYPES:
            arr = np.frombuffer(body[start:end],
                                np.dtype(_ST_DTYPES[dtype]).newbyteorder("<"))
            out[name] = arr.reshape(shape).astype(_ST_DTYPES[dtype])
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, "
                             "which this reader does not take")
    return out


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> int:
    """Write numpy arrays in the safetensors format (keys sorted, as the
    reference writer does); returns the bytes written."""
    header: Dict[str, Dict] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {arr.dtype} has no "
                             "safetensors name here")
        blob = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _ST_NAMES[arr.dtype],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)   # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
    return 8 + len(text) + offset


def _torch_dtypes():
    import torch
    return {"F64": torch.float64, "F32": torch.float32,
            "F16": torch.float16, "BF16": torch.bfloat16,
            "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
            "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors_header(path: str) -> Tuple[Dict, int]:
    """({name: {dtype, shape, data_offsets}}, offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_safetensors_torch(path: str) -> Iterator[Tuple[str, "object"]]:
    """(name, CPU tensor in the file's dtype) for each tensor of a
    safetensors file, in file order, each read on its own."""
    import torch
    dtypes = _torch_dtypes()
    header, base = read_safetensors_header(path)
    order = sorted(header, key=lambda k: header[k]["data_offsets"][0])
    with open(path, "rb") as f:
        for name in order:
            info = header[name]
            if info["dtype"] not in dtypes:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']}, which this reader does "
                                 "not take")
            start, end = info["data_offsets"]
            f.seek(base + start)
            raw = bytearray(end - start)
            f.readinto(raw)
            t = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
                torch.empty(0, dtype=torch.uint8)
            yield name, t.view(dtypes[info["dtype"]]).reshape(info["shape"])


def write_safetensors_torch(path: str, tensors: Mapping[str, "object"]) -> int:
    """Write torch tensors (any device) in their own dtype, keys sorted,
    each copied to the host on its own; returns the bytes written."""
    import torch
    names = {v: k for k, v in _torch_dtypes().items()}
    header: Dict[str, Dict] = {}
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)   # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in sorted(tensors):
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(text) + offset


def checkpoint_files(path: str) -> List[str]:
    """The safetensors files of a checkpoint: one file, an HF index's
    shards, or every .safetensors file of a directory (index first)."""
    if os.path.isdir(path):
        for name in os.listdir(path):
            if name.endswith(".safetensors.index.json"):
                return checkpoint_files(os.path.join(path, name))
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.endswith(".safetensors")]
        if not files:
            raise FileNotFoundError(f"no checkpoint files in {path}")
        return files
    if path.endswith(".index.json"):
        with open(path) as f:
            index = json.load(f)
        root = os.path.dirname(path)
        return [os.path.join(root, shard)
                for shard in sorted(set(index["weight_map"].values()))]
    return [path]


def torch_state_dict_to_numpy(sd) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        out[k] = (v.detach().cpu().float().numpy() if hasattr(v, "detach")
                  else np.asarray(v))
    return out


def read_torch_bin(path: str) -> Dict[str, np.ndarray]:
    """torch.load a pickle checkpoint -> numpy dict (possibly nested one
    level, like ConsistentID-v1.bin's three sections)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if any(isinstance(v, dict) for v in sd.values()):
        return {k: torch_state_dict_to_numpy(v) if isinstance(v, dict) else v
                for k, v in sd.items()}
    return torch_state_dict_to_numpy(sd)


def read_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load one file or an HF sharded checkpoint directory/index."""
    if os.path.isdir(path) or path.endswith((".index.json", ".safetensors")):
        merged: Dict[str, np.ndarray] = {}
        for shard in checkpoint_files(path):
            merged.update(read_safetensors(shard))
        return merged
    if path.endswith(".onnx"):
        # insightface packs (SCRFD / ArcFace) ship as ONNX graphs
        from .onnx_reader import read_onnx_initializers
        return read_onnx_initializers(path)
    return read_torch_bin(path)
