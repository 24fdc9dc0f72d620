"""Calibrated int8 activation scales as a file (the JAX package's
io/quant_scales.py, the same format): the act_scale tree that
`ConsistentIDPipeline.calibrate_int8` makes, so a fleet serves from one
calibration run instead of calibrating in every process.

Format: an `.npz` of the flattened tree, '/'-joined module-path keys (each
leaf a scalar fp32 per-tensor scale), plus a `__format__` marker. The paths
are the JAX package's module paths, which are the port's too, so a file
written by either package loads in the other.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_FORMAT = "consistentid-act-scales-v1"
_FORMAT_KEY = "__format__"


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in sorted(tree.items()):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val, np.float32)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_act_scales(path: str, scales: Dict) -> None:
    """Write an act_scale tree (`pipeline.bundle.act_scales`, numpy or
    host tensor leaves) to `path` (.npz)."""
    flat = _flatten(scales)
    np.savez(path, **{_FORMAT_KEY: np.asarray(_FORMAT)}, **flat)


def load_act_scales(path: str) -> Dict:
    """Read a tree saved by save_act_scales, for
    `pipeline.with_quant("int8_static", act_scales=...)`; a file without
    the format marker raises ValueError."""
    with np.load(path, allow_pickle=False) as data:
        fmt = str(data[_FORMAT_KEY]) if _FORMAT_KEY in data else None
        if fmt != _FORMAT:
            raise ValueError(
                f"{path} is not an act-scales artifact "
                f"(format marker {fmt!r}, expected {_FORMAT!r})")
        flat = {k: np.asarray(data[k], np.float32)
                for k in data.files if k != _FORMAT_KEY}
    return _unflatten(flat)
