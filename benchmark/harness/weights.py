"""Raw weights from a seed, made on the device in a few large draws, and
handed alike to the system under test and to the reference.

Diffusion side (UNet, VAE, text towers, ViT-H, adapters), in the serving
dtype: fan-in scaled normals, so that every block's output is of order one
as in a trained network (a flat N(0, 0.02) makes the UNet's noise
prediction about 1% of its input, and the image all but independent of the
UNet): weight matrices and kernels N(0, 1/fan_in) (the LoRA up-projections
too, so the LoRA delta is as large as the base weight), norm scales
1 + N(0, 0.02^2), biases, position and class embeddings N(0, 0.02^2),
perceiver latents N(0, 1/width), token embeddings N(0, 0.02^2).

Perception side (SCRFD-10g, iresnet50, BiSeNet, the safety checker), fp32:
the rules that keep a random stack of 50 layers finite and non-degenerate
(He-scaled kernels, BatchNorm statistics near identity, residual branches
that start small, the checker's concept thresholds U(0.15, 0.25)).

Each side is one normal draw and one uniform draw of its total size; a leaf
is a view of them, scaled in place. The same seed gives the same bits.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
from torch import nn


def _draws(total: int, seed: int, device, dtype):
    gen = torch.Generator(device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device, dtype=dtype)
    uniform = torch.rand(total, generator=gen, device=device, dtype=dtype)
    return normal, uniform


def _leaves(module: nn.Module) -> Iterable[Tuple[str, nn.Module, str,
                                                 torch.Tensor]]:
    for mod_name, mod in module.named_modules():
        for leaf, t in [*mod.named_parameters(recurse=False),
                        *mod.named_buffers(recurse=False)]:
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            yield name, mod, leaf, t


def diffusion_weights(model: nn.Module, seed: int, device,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every parameter and buffer of `model` (built on
    the meta device), in `dtype` on `device`."""
    leaves = list(_leaves(model))
    total = sum(t.numel() for *_, t in leaves)
    normal, _ = _draws(total, seed, device, dtype)
    out, at = {}, 0
    for name, mod, leaf, t in leaves:
        x = normal[at:at + t.numel()].view(t.shape)
        at += t.numel()
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) and leaf == "weight":
            x.mul_(0.02).add_(1.0)
        elif leaf == "latents":
            x.mul_(t.shape[-1] ** -0.5)
        elif isinstance(mod, nn.Embedding) or leaf in (
                "position_embedding", "class_embedding") or t.dim() < 2:
            x.mul_(0.02)
        else:                    # Linear (out, in), Conv (out, in, kh, kw)
            x.mul_(t[0].numel() ** -0.5)
        out[name] = x
    return out


def perception_weights(model: nn.Module, seed: int,
                       device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for a perception model (built on the meta device),
    fp32 on `device`."""
    closing = set()
    for mod in model.modules():
        if hasattr(mod, "has_downsample"):
            norms = [m for n, m in mod.named_children()
                     if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d))
                     and not n.startswith("downsample")]
            closing.add(id(norms[-1]))
    leaves = list(_leaves(model))
    total = sum(t.numel() for *_, t in leaves)
    normal, uniform = _draws(total, seed, device, torch.float32)
    out, at = {}, 0
    for name, mod, leaf, t in leaves:
        n = normal[at:at + t.numel()].view(t.shape)
        u = uniform[at:at + t.numel()].view(t.shape)
        at += t.numel()
        if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            if leaf == "weight":
                x = n.mul_(0.1).add_(0.0 if id(mod) in closing else 1.0)
            elif leaf in ("bias", "running_mean"):
                x = n.mul_(0.1)
            elif leaf == "running_var":
                x = u.add_(0.5)
            else:                                    # num_batches_tracked
                x = torch.zeros(t.shape, dtype=t.dtype, device=device)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            x = n.fill_(1.0 if leaf == "weight" else 0.0)
        elif type(mod).__name__ == "PReLU":
            x = n.fill_(0.25)
        elif leaf.startswith("scale_"):
            x = n.fill_(1.0)
        elif leaf == "weight" and t.dim() >= 2:
            fan_in = t[0].numel()
            x = n.mul_(math.sqrt(2.0 / fan_in) if t.dim() == 4
                       else 1.0 / math.sqrt(fan_in))
        elif leaf.endswith("_embeds"):
            x = n
        elif leaf.endswith("_embeds_weights"):        # checker thresholds
            x = u.mul_(0.1).add_(0.15)
        else:
            x = n.mul_(0.02)
        out[name] = x
    return out
