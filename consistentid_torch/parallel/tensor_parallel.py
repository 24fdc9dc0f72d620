"""Tensor parallelism (Megatron-style) for the UNet and the Llama decoder:
the port's counterpart of the JAX package's parallel/tensor_parallel.py.

The same rules decide which weights are split (`unet_split_plan`,
`llama_split_plan`, leaf for leaf JAX's `unet_param_shardings` and
`llama_param_shardings`):
  - UNet, inside the transformers' attention and feed-forward: to_q, to_k,
    to_v, to_k_ip, to_v_ip and ff.proj column-parallel (their output
    features split), to_out and ff.out row-parallel (their input features
    split); everything else replicated;
  - Llama: q/k/v_proj, gate/up_proj and lm_head column-parallel, o_proj
    and down_proj row-parallel, an int8 layer's per-channel scale following
    a column split; embeddings and norms replicated.
JAX leaves the collectives to GSPMD. Here the split weights live in
`ColumnParallelLinear` / `RowParallelLinear` (and their int8 twins), and a
row-parallel layer all-reduces its partial products over the mesh's model
group, then adds its bias once. What GSPMD keeps exact, the port must
arrange itself:
  - heads are local: a rank holds whole heads of q, k, v (and of the IP
    branch) and its attention runs heads // tp of them. A degree that does
    not divide the heads raises ValueError (GSPMD would pad);
  - the GEGLU in-projection's output is [h, gate]: rank r holds the r-th
    slice of h and the r-th slice of gate, so its local chunk(2) pairs
    them;
  - LoRA is folded into the base weights before the split (the pipeline
    folds at every request); a UNet with unfolded LoRA deltas is refused;
  - an int8 row-parallel layer quantizes its activations with the
    all-reduced (max) per-token amax, so its codes are the single-device
    ones, and all-reduces the exact int32 products before dequantizing;
  - the lm_head's vocabulary slices are gathered before the argmax.
The int8 UNet's layers name their weights kernel_q, which JAX's UNet rule
does not match (it matches only `kernel`): under --quant int8 JAX shards
nothing of the quantized projections, and neither does the port (the float
IP projections beside them stay whole too, which computes the same).
"""
from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QMAX, int_mm, quantize_symmetric
from .mesh import (all_gather_cat, all_reduce_max, all_reduce_sum,
                   model_axis_size)

COL, ROW = "col", "row"

# UNet (JAX _COL_PARALLEL / _ROW_PARALLEL)
_UNET_COL = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "proj")
_UNET_ROW = ("to_out", "out")
# Llama (JAX _LLAMA_COL / _LLAMA_ROW)
_LLAMA_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
              "lm_head")
_LLAMA_ROW = ("o_proj", "down_proj")


# ------------------------------------------------------------------ plans

def _unet_rule(parts, ndim: int) -> Optional[str]:
    if parts[-1] != "weight" or ndim != 2:
        return None
    name = parts[-2]
    parent = parts[-3] if len(parts) >= 3 else ""
    if not any("attn" in p or p == "ff" for p in parts):
        return None
    if not (parent.startswith("attn") or parent == "ff"):
        return None
    if name in _UNET_COL:
        return COL
    if name in _UNET_ROW:
        return ROW
    return None


def unet_split_plan(state: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """{state key: "col" | "row"} of the UNet weights JAX's rule splits
    (a column split divides a Linear weight's dim 0, a row split its dim
    1); keys not named are replicated."""
    plan = {}
    for key, t in state.items():
        rule = _unet_rule(key.split("."), t.dim())
        if rule:
            plan[key] = rule
    return plan


def _llama_rule(parts, ndim: int) -> Optional[str]:
    name = parts[-2] if len(parts) >= 2 else ""
    kind = parts[-1]
    if kind in ("weight", "kernel_q") and ndim == 2:
        if name in _LLAMA_COL:
            return COL
        if name in _LLAMA_ROW:
            return ROW
    if kind == "kernel_scale" and name in _LLAMA_COL:
        return COL
    return None


def llama_split_plan(state: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """{state key: "col" | "row"} of a float or int8 Llama state dict
    (JAX `llama_param_shardings`)."""
    plan = {}
    for key, t in state.items():
        rule = _llama_rule(key.split("."), t.dim())
        if rule:
            plan[key] = rule
    return plan


# ---------------------------------------------------------------- layers

def _shard(t: Optional[torch.Tensor], dim: int, rank: int, tp: int,
           halves: bool = False) -> Optional[torch.Tensor]:
    """Rank `rank`'s slice of `t` along `dim` (a fresh tensor). With
    `halves`, the r-th slice of each half (the GEGLU [h, gate] layout)."""
    if t is None:
        return None
    if halves:
        return torch.cat([_shard(h, dim, rank, tp)
                          for h in t.chunk(2, dim=dim)], dim=dim)
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dimension {n} does not split over {tp} ranks")
    return t.narrow(dim, rank * (n // tp), n // tp).clone()


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class ColumnParallelLinear(nn.Module):
    """This rank's output features of a Linear (weight and bias slices)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.weight = _param(weight)
        self.bias = _param(bias)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's input features of a Linear: the partial product is
    summed over `group`, then the whole bias added once. Inference only
    (the sum carries no gradient), as the split serves generate, serve and
    the captioner."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group):
        super().__init__()
        self.weight = _param(weight)
        self.bias = _param(bias)
        self.group = group

    def forward(self, x):
        y = all_reduce_sum(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class ColumnParallelInt8Dense(nn.Module):
    """This rank's output channels of an `Int8Dense` (dynamic scales): the
    activations are whole on every rank, so their codes are the
    single-device ones."""

    def __init__(self, layer: nn.Module, rank: int, tp: int):
        super().__init__()
        self.path = layer.path
        self.register_buffer("kernel_q", _shard(layer.kernel_q, 0, rank, tp))
        self.register_buffer("kernel_scale",
                             _shard(layer.kernel_scale, 0, rank, tp))
        self.register_buffer("bias", _shard(layer.bias, 0, rank, tp))

    def forward(self, x):
        xq, xscale = quantize_symmetric(x, (x.dim() - 1,), keepdim=True)
        lead = xq.shape[:-1]
        y = int_mm(xq.reshape(-1, xq.shape[-1]), self.kernel_q.t(),
                   self.path).view(*lead, -1)
        y = y.float() * (xscale * self.kernel_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class RowParallelInt8Dense(nn.Module):
    """This rank's input channels of an `Int8Dense` (dynamic scales): the
    per-token amax is all-reduced (max) so the codes are the single-device
    ones, the int32 products are all-reduced exactly, then dequantized."""

    def __init__(self, layer: nn.Module, rank: int, tp: int, group):
        super().__init__()
        self.path = layer.path
        self.group = group
        self.register_buffer("kernel_q", _shard(layer.kernel_q, 1, rank, tp))
        self.register_buffer("kernel_scale", layer.kernel_scale)
        self.register_buffer("bias", layer.bias)

    def forward(self, x):
        xf = x.float()
        amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True),
                              self.group)
        xscale = amax.clamp_min(1e-8) / QMAX
        xq = torch.clamp(torch.round(xf / xscale), -QMAX,
                         QMAX).to(torch.int8)
        lead = xq.shape[:-1]
        y = int_mm(xq.reshape(-1, xq.shape[-1]), self.kernel_q.t(),
                   self.path)
        y = all_reduce_sum(y, self.group).view(*lead, -1)
        y = y.float() * (xscale * self.kernel_scale)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class GatheredOutput(nn.Module):
    """A column-parallel layer whose output slices are gathered over
    `group`: the lm_head, so every rank holds all the logits (greedy argmax
    needs them)."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner = inner
        self.group = group

    def forward(self, x):
        return all_gather_cat(self.inner(x), self.group, dim=-1)


def _col(m: nn.Module, rank: int, tp: int, halves: bool = False):
    return ColumnParallelLinear(_shard(m.weight.detach(), 0, rank, tp, halves),
                                _shard(None if m.bias is None
                                       else m.bias.detach(), 0, rank, tp,
                                       halves))


def _row(m: nn.Module, rank: int, tp: int, group):
    return RowParallelLinear(_shard(m.weight.detach(), 1, rank, tp),
                             None if m.bias is None else m.bias.detach(),
                             group)


def shared_copy(module: nn.Module) -> nn.Module:
    """A copy of `module`'s module tree that shares its parameters and
    buffers (so the copy can be split without touching the original)."""
    memo = {id(t): t for t in list(module.parameters())
            + list(module.buffers())}
    return copy.deepcopy(module, memo)


# ------------------------------------------------------------------ UNet

def apply_tensor_parallel(unet: nn.Module, mesh) -> nn.Module:
    """Split a UNet's transformer attention and feed-forward over the
    mesh's model group, in place; returns it. A mesh without a model axis
    leaves it as it is. Raises ValueError where the degree does not divide
    an attention's heads, and where LoRA deltas are unfolded."""
    from ..models.layers import Attention, GEGLUFeedForward

    tp = model_axis_size(mesh)
    if tp == 1:
        return unet
    rank, group = mesh.model_rank, mesh.model_group
    plan = unet_split_plan(unet.state_dict())
    for name, m in unet.named_modules():
        if isinstance(m, Attention):
            if plan.get(f"{name}.to_q.weight") != COL:
                continue            # int8: JAX's rule splits nothing here
            if m.lora_rank:
                raise ValueError(f"{name}: fold LoRA into the base weights "
                                 "before the tensor-parallel split")
            if m.heads % tp:
                raise ValueError(f"{name}: {m.heads} attention heads do not "
                                 f"split over a tensor-parallel degree of "
                                 f"{tp}")
            for proj in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
                if hasattr(m, proj):
                    setattr(m, proj, _col(getattr(m, proj), rank, tp))
            m.to_out = _row(m.to_out, rank, tp, group)
            m.heads //= tp
        elif (isinstance(m, GEGLUFeedForward)
              and plan.get(f"{name}.proj.weight") == COL):
            m.proj = _col(m.proj, rank, tp, halves=True)
            m.out = _row(m.out, rank, tp, group)
    return unet


def tensor_parallel_unet(unet: nn.Module, mesh) -> nn.Module:
    """`apply_tensor_parallel` on a `shared_copy` of `unet` (the given
    module is left whole)."""
    if model_axis_size(mesh) == 1:
        return unet
    return apply_tensor_parallel(shared_copy(unet), mesh)


# ----------------------------------------------------------------- Llama

def apply_llama_tensor_parallel(llama: nn.Module, mesh) -> nn.Module:
    """Split a `LlamaForCausalLM` (float or int8) over the mesh's model
    group, in place; returns it. Heads and KV heads become local (the KV
    cache holds this rank's), the logits are gathered. Under gloo the
    decode step runs eagerly: gloo's collectives cannot be captured in a
    CUDA graph."""
    from ..models.layers import Int8Dense

    tp = model_axis_size(mesh)
    if tp == 1:
        return llama
    cfg = llama.config
    rank, group = mesh.model_rank, mesh.model_group
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV "
                         f"heads do not split over a tensor-parallel degree "
                         f"of {tp}")

    def col(m):
        if isinstance(m, Int8Dense):
            return ColumnParallelInt8Dense(m, rank, tp)
        return _col(m, rank, tp)

    def row(m):
        if isinstance(m, Int8Dense):
            return RowParallelInt8Dense(m, rank, tp, group)
        return _row(m, rank, tp, group)

    for i in range(cfg.num_layers):
        layer = getattr(llama, f"layers_{i}")
        attn, mlp = layer.self_attn, layer.mlp
        attn.q_proj, attn.k_proj, attn.v_proj = (
            col(attn.q_proj), col(attn.k_proj), col(attn.v_proj))
        attn.o_proj = row(attn.o_proj)
        attn.num_heads = cfg.num_heads // tp
        attn.num_kv_heads = cfg.num_kv_heads // tp
        mlp.gate_proj, mlp.up_proj = col(mlp.gate_proj), col(mlp.up_proj)
        mlp.down_proj = row(mlp.down_proj)
    if not cfg.tie_word_embeddings:
        llama.lm_head = GatheredOutput(col(llama.lm_head), group)
    llama.kv_heads = cfg.num_kv_heads // tp
    llama.eager_decode = mesh.backend == "gloo"
    return llama
