"""Carry the JAX package's parameters into the port.

`params_from_jax` walks a flax parameter tree of numpy arrays (any nesting
of mappings, e.g. the bundle's {"unet": ..., "vae": ...}, or the SDXL
bundle's with "text_encoder_2", the UNet's "add_embedding" and linear
transformer projections, or a ControlNet's tree) and returns the port's
state dict. Module names are the same on both sides; only the leaves
change:
  - Dense kernel (in, out)      -> Linear weight (out, in)
  - Conv kernel HWIO            -> Conv2d weight OIHW
  - int8 kernel_q, the same two transposes, keeping its name (the int8
    UNet's Int8Dense/Int8Conv; kernel_scale and act_scale as they are)
  - norm scale, Embed embedding -> weight
  - PReLU alpha                 -> weight
  - everything else (bias, position/class embeddings, latents, the SCRFD
    head's scalar `scale_i`) as it is.
`state_from_jax` takes flax variables {"params": ..., "batch_stats": ...}
and adds the BatchNorm running statistics (mean -> running_mean, var ->
running_var, and a zero num_batches_tracked). Both need numpy only: the
caller converts device arrays first. The checkpoint loaders
(pipelines/loading.py) use the same two on the trees that io/convert*.py
read off reference files. `tree_from_module` is their inverse: a port
module's weights as such a tree, for io/export_backbones.py to write.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))   # a writable copy


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, f"{prefix}{key}."))
            continue
        a = np.asarray(val)
        if key in ("kernel", "kernel_q"):
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{prefix}{key}: kernel of rank {a.ndim}")
            name = "weight" if key == "kernel" else key
        elif key in ("scale", "embedding", "alpha"):
            name = "weight"
        else:
            name = key
        out[f"{prefix}{name}"] = _to_tensor(a)
    return out


def _batch_stats(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if key in ("mean", "var") and not isinstance(val, Mapping):
            name = "running_mean" if key == "mean" else "running_var"
            out[f"{prefix}{name}"] = _to_tensor(np.asarray(val))
            out[f"{prefix}num_batches_tracked"] = torch.zeros((),
                                                              dtype=torch.long)
        else:
            out.update(_batch_stats(val, f"{prefix}{key}."))
    return out


def permute_nhwc_flatten(weight: torch.Tensor, channels: int) -> torch.Tensor:
    """A Linear weight (out, H*W*C) over an NHWC map flattened as (h, w, c)
    -> the same weight over the NCHW map flattened as (c, h, w)."""
    out_dim, n = weight.shape
    spatial = int(round((n // channels) ** 0.5))
    return (weight.reshape(out_dim, spatial, spatial, channels)
            .permute(0, 3, 1, 2).reshape(out_dim, n).contiguous())


def state_from_jax(variables: Mapping,
                   flatten_nhwc: Optional[Mapping[str, int]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Flax variables {"params": ..., "batch_stats": ...} -> the port's state
    dict, parameters and BatchNorm buffers. `flatten_nhwc` names the Linear
    layers that read a flattened feature map, by the map's channels (ArcFace:
    {"fc": 512}): the JAX package flattens NHWC, the port NCHW, so their
    weight columns are permuted (h, w, c) -> (c, h, w)."""
    state = params_from_jax(variables["params"])
    state.update(_batch_stats(variables.get("batch_stats", {})))
    for name, channels in (flatten_nhwc or {}).items():
        key = f"{name}.weight"
        state[key] = permute_nhwc_flatten(state[key], channels)
    return state


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)


def _leaf_from_param(module: nn.Module, leaf: str, t: torch.Tensor):
    """(flax leaf name, numpy array) of one parameter of `module`: the
    inverse of `params_from_jax`'s leaf map."""
    a = t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()
    if leaf != "weight":
        return leaf, a
    if isinstance(module, nn.Embedding):
        return "embedding", a
    if type(module).__name__ == "PReLU":
        return "alpha", a
    if isinstance(module, _NORMS) or a.ndim == 1:
        return "scale", a
    if a.ndim == 4:
        return "kernel", np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if a.ndim == 2:
        return "kernel", np.ascontiguousarray(a.T)
    raise ValueError(f"{type(module).__name__}.weight of rank {a.ndim}")


def tree_from_module(module: nn.Module,
                     flatten_nhwc: Optional[Mapping[str, int]] = None,
                     keep: Optional[Callable[[str], bool]] = None
                     ) -> Tuple[Dict, Dict]:
    """A port module's weights as flax-shaped (params, batch_stats) trees of
    fp32 numpy arrays: the inverse of `state_from_jax`, including its
    `flatten_nhwc` permutation (given the same names). `keep`: only the
    parameters whose dotted state-dict name it accepts."""
    params: Dict = {}
    stats: Dict = {}

    def node(tree: Dict, name: str) -> Dict:
        for part in name.split(".") if name else ():
            tree = tree.setdefault(part, {})
        return tree

    for name, mod in module.named_modules():
        for leaf, t in mod.named_parameters(recurse=False):
            if keep is not None and not keep(f"{name}.{leaf}" if name
                                             else leaf):
                continue
            key, a = _leaf_from_param(mod, leaf, t)
            if key == "kernel" and name in (flatten_nhwc or {}):
                c = flatten_nhwc[name]
                n_in, out_dim = a.shape
                spatial = int(round((n_in // c) ** 0.5))
                a = np.ascontiguousarray(
                    a.reshape(c, spatial, spatial, out_dim)
                    .transpose(1, 2, 0, 3).reshape(n_in, out_dim))
            node(params, name)[key] = a
        for leaf, t in mod.named_buffers(recurse=False):
            if leaf in ("running_mean", "running_var"):
                node(stats, name)["mean" if leaf == "running_mean"
                                  else "var"] = t.detach().float().cpu().numpy()
    return params, stats
