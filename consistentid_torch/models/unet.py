"""SD UNet (UNet2DConditionModel layout, SD1.5 and SDXL) with the
ConsistentID adapter hooks: LoRA on every attention projection and
decoupled-IP cross-attention.

Counterpart of the JAX package's models/unet.py. The SDXL layout (`addition_embed_type="text_time"`)
adds the pooled-text and time-ids embedding to the time embedding and takes
linear transformer projections. The public forward takes and returns NHWC
latents and runs NCHW inside.

Two hooks for the inference paths, both in that inner NCHW layout, so
nothing crosses between modules or steps through a layout conversion:
  - ControlNet residuals (models/controlnet.py): `down_block_residuals`, one
    per skip, are added to the skips after the down stack, and
    `mid_residual` to the mid block's output (diffusers semantics);
  - the DeepCache split (Ma et al. 2023): `return_deep` also returns the
    hidden state entering the last (level-0) up block, everything below
    level 0 computed; `deep_feature` skips those deep blocks and runs only
    conv_in, the level-0 down blocks (fresh skips), the last up block and
    conv_out on the given feature. The timestep and the context still enter
    through the level-0 blocks. Both read the same parameters.

Attention-probability capture for the facial localization loss follows the
JAX package: `capture_layers` names blocks of UNET_LAYER_NAMES (`up_i` counts
from the deepest up block, so `up_2` is level 1), and every attn2 in them
returns its softmax, column-gathered at `capture_cols`. The forward then
returns `(out, {module path: probs})`, keyed as the JAX package's sown
tensors are; training.losses.collect_attn_probs orders them as it does.

Rematerialisation (`remat`, the JAX package's `nn.remat` of the blocks,
:134-168): under autograd each ResnetBlock and each Transformer2D whose
attention probabilities are not captured runs inside a non-reentrant
`torch.utils.checkpoint`, so its activations are recomputed in the backward
instead of kept. `remat_policy="full"` keeps nothing of the block;
`"dots"` (JAX's `dots_with_no_batch_dims_saveable`) keeps the outputs of
its 2-D products, the linear layers' `mm` / `addmm`, and recomputes the
rest: the batched attention products and the convolutions too.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.config import REMAT_POLICIES, UNetConfig
from .layers import (GN_EPS, Downsample, Int8Conv, Int8Dense, ResnetBlock,
                     TimestepEmbedding, Transformer2D, Upsample,
                     timestep_embedding)

UNET_LAYER_NAMES = ("down_0", "down_1", "down_2", "mid", "up_1", "up_2",
                    "up_3")


def localization_layer_names(num_layers: int) -> Tuple[str, ...]:
    """The centred window of `num_layers` capture blocks (reference
    functions.py:266-278): 5 -> down_1, down_2, mid, up_1, up_2."""
    start = (len(UNET_LAYER_NAMES) - num_layers) // 2
    return UNET_LAYER_NAMES[start:start + num_layers]


# the 2-D products "dots" keeps (JAX: dot_general with no batch dimension)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_with(block: nn.Module, params: Dict[str, torch.Tensor], *args):
    return torch.func.functional_call(block, params, args)


class UNet(nn.Module):
    """`quant` (JAX `UNet.quant`): False for the float UNet; True or
    "static" for the W8A8 serving twin (models/layers.py; dynamic or
    calibrated activation scales), which takes a lora_rank=0 config and the
    state `ops.quant.quantize_state_like` makes from the folded weights.
    conv_in, conv_out, the time embeddings, the norms and the IP branch
    stay float. Each int8 layer's `path` is its module path here, the key of
    its calibration record and its act_scale."""

    def __init__(self, config: UNetConfig, quant=False):
        super().__init__()
        self.remat = False
        self.remat_policy = "full"
        cfg = self.config = config
        boc = cfg.block_out_channels
        n = len(boc)
        temb = cfg.time_embed_dim
        groups = cfg.norm_num_groups

        def transformer(level: int, depth: int) -> Transformer2D:
            return Transformer2D(
                boc[level], cfg.num_attention_heads[level],
                cfg.cross_attention_dim, depth=depth, groups=groups,
                lora_rank=cfg.lora_rank, ip_num_tokens=cfg.ip_num_tokens,
                use_linear_projection=cfg.is_sdxl, quant=quant)

        self.conv_in = nn.Conv2d(cfg.sample_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        if cfg.is_sdxl:
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb)

        skip_ch = [boc[0]]
        ch = boc[0]
        for level in range(n):
            out_ch = boc[level]
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_resnet_{j}",
                                ResnetBlock(ch, out_ch, temb, groups, quant))
                ch = out_ch
                if cfg.down_block_has_attn[level]:
                    self.add_module(f"down_{level}_attn_{j}", transformer(
                        level, cfg.transformer_layers_per_block[level]))
                skip_ch.append(ch)
            if level < n - 1:
                self.add_module(f"down_{level}_downsample",
                                Downsample(ch, quant))
                skip_ch.append(ch)

        self.mid_resnet_0 = ResnetBlock(ch, boc[-1], temb, groups, quant)
        self.mid_attn = transformer(n - 1, cfg.mid_transformer_depth)
        self.mid_resnet_1 = ResnetBlock(boc[-1], boc[-1], temb, groups,
                                        quant)
        ch = boc[-1]

        for i in range(n):
            level = n - 1 - i
            out_ch = boc[level]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnet_{j}", ResnetBlock(
                    ch + skip_ch.pop(), out_ch, temb, groups, quant))
                ch = out_ch
                if cfg.down_block_has_attn[level]:
                    self.add_module(f"up_{i}_attn_{j}", transformer(
                        level, cfg.transformer_layers_per_block[level]))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch, quant))

        self.conv_norm_out = nn.GroupNorm(groups, boc[0], eps=GN_EPS)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)
        self.quant = quant
        for name, module in self.named_modules():
            if isinstance(module, (Int8Conv, Int8Dense)):
                module.path = name

    def _block(self, block: nn.Module, *args):
        """block(*args), rematerialised when `remat` is on and autograd
        records. The recomputation in the backward runs on the tensors the
        block's parameters were in this forward (under the bundle's
        `call`, the masters cast to the compute dtype, which `call` no
        longer holds by then), so they are passed in explicitly."""
        if not (self.remat and torch.is_grad_enabled()):
            return block(*args)
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of "
                             f"{REMAT_POLICIES}")
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _save_products)
        return checkpoint(_run_with, block, dict(block.named_parameters()),
                          *args, use_reentrant=False, **kw)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, lora_scale: float = 1.0,
                ip_scale: float = 1.0, capture_layers: Sequence[str] = (),
                capture_cols: Optional[torch.Tensor] = None,
                added_cond: Optional[Dict[str, torch.Tensor]] = None,
                down_block_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None,
                deep_feature: Optional[torch.Tensor] = None,
                return_deep: bool = False):
        """sample (B, H, W, C) latents, timesteps (B,) or scalar, context
        (B, L + ip_num_tokens, cross_attention_dim) -> (B, H, W, C_out);
        with capture_layers, (out, {module path: probs (B, H, Sq, N or K)
        fp32}). The SDXL layout needs added_cond {"text_embeds": (B, Dp)
        pooled text, "time_ids": (B, 6)}.

        down_block_residuals (one (B, C, h, w) per skip) and mid_residual
        (B, C, h, w) add a ControlNet's outputs; return_deep=True returns
        (out, deep), deep (B, C, H, W) the last up block's input;
        deep_feature=deep runs the shallow path on it (neither with
        residuals, capture_layers or return_deep)."""
        cfg = self.config
        skip_deep = deep_feature is not None
        if skip_deep:
            if down_block_residuals is not None or mid_residual is not None:
                raise ValueError("deep-feature caching is incompatible with "
                                 "ControlNet residual injection")
            if capture_layers:
                raise ValueError("attention-probability capture (training) "
                                 "never runs the cached path")
            if return_deep:
                raise ValueError("deep_feature and return_deep exclude each "
                                 "other")
        dtype = self.conv_in.weight.dtype
        n = len(cfg.block_out_channels)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))
        if cfg.is_sdxl:
            if added_cond is None:
                raise ValueError("the SDXL UNet needs added_cond "
                                 "(text_embeds, time_ids)")
            time_ids = added_cond["time_ids"]
            t_emb = timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift)
            add = torch.cat([added_cond["text_embeds"].float(),
                             t_emb.reshape(time_ids.shape[0], -1)], dim=-1)
            temb = temb + self.add_embedding(add.to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        captured = {}

        def attn(name, block, h):
            if block not in capture_layers:
                return self._block(getattr(self, name), h, ctx, lora_scale,
                                   ip_scale)
            h, probs = getattr(self, name)(h, ctx, lora_scale, ip_scale,
                                           True, capture_cols)
            for sub, p in probs.items():
                # keyed by the path the JAX package sows the tensor under
                captured[f"['{name}']['{sub}']['attn2']"] = p
            return h

        def up_block(i, h):
            level = n - 1 - i
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = self._block(getattr(self, f"up_{i}_resnet_{j}"), h,
                                temb)
                if cfg.down_block_has_attn[level]:
                    h = attn(f"up_{i}_attn_{j}", f"up_{i}", h)
            return h

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for level in range(1 if skip_deep else n):
            for j in range(cfg.layers_per_block):
                h = self._block(getattr(self, f"down_{level}_resnet_{j}"),
                                h, temb)
                if cfg.down_block_has_attn[level]:
                    h = attn(f"down_{level}_attn_{j}", f"down_{level}", h)
                skips.append(h)
            if level < n - 1 and not skip_deep:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)

        if down_block_residuals is not None:
            if len(down_block_residuals) != len(skips):
                raise ValueError(f"{len(down_block_residuals)} residuals vs "
                                 f"{len(skips)} skips")
            skips = [s + r.to(s.dtype)
                     for s, r in zip(skips, down_block_residuals)]

        if skip_deep:
            h = deep_feature.to(dtype)
        else:
            h = self._block(self.mid_resnet_0, h, temb)
            h = attn("mid_attn", "mid", h)
            h = self._block(self.mid_resnet_1, h, temb)
            if mid_residual is not None:
                h = h + mid_residual.to(h.dtype)
            for i in range(n - 1):
                h = getattr(self, f"up_{i}_upsample")(up_block(i, h))
        deep = h
        h = up_block(n - 1, h)

        out = self.conv_out(F.silu(self.conv_norm_out(h))).permute(0, 2, 3, 1)
        if return_deep:
            return out, deep
        return (out, captured) if capture_layers else out
