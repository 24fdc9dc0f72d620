"""Carry the JAX package's parameters into the port.

`params_from_jax` walks a flax parameter tree of numpy arrays (any nesting
of mappings, e.g. the bundle's {"unet": ..., "vae": ...}) and returns the
port's state dict. Module names are the same on both sides; only the leaves
change:
  - Dense kernel (in, out)      -> Linear weight (out, in)
  - Conv kernel HWIO            -> Conv2d weight OIHW
  - norm scale, Embed embedding -> weight
  - everything else (bias, position/class embeddings, latents) as it is.
It needs numpy only: the caller converts device arrays first.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, f"{prefix}{key}."))
            continue
        a = np.asarray(val)
        if key == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{prefix}{key}: kernel of rank {a.ndim}")
            name = "weight"
        elif key in ("scale", "embedding"):
            name = "weight"
        else:
            name = key
        out[f"{prefix}{name}"] = _to_tensor(a)
    return out
