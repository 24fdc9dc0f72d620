"""HF-layout state dicts of the frozen backbones -> flax-shaped trees.

A copy of the JAX package's io/convert_backbones.py (without the llama and
llava converters): diffusers UNet2DConditionModel / AutoencoderKL and
transformers CLIP state dicts (the checkpoints the reference loads at
pipline_StableDiffusion_ConsistentID.py:41-57 and train.py:112-117) onto
the trees of the JAX package's models/unet.py, models/vae.py,
models/clip.py, which `io.from_jax.params_from_jax` carries into the port's
modules. The inverse maps are in io/export_backbones.py.

All functions take dict[str, np.ndarray] (io.safetensors_reader output).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from ..core.config import CLIPTextConfig, CLIPVisionConfig, UNetConfig, VAEConfig
from .convert import conv, layernorm, linear


def _gn(sd, p):
    return {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def _resnet(sd, p, has_time=True):
    out = {
        "norm1": _gn(sd, f"{p}.norm1"),
        "conv1": conv(sd, f"{p}.conv1"),
        "norm2": _gn(sd, f"{p}.norm2"),
        "conv2": conv(sd, f"{p}.conv2"),
    }
    if has_time and f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = linear(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = conv(sd, f"{p}.conv_shortcut")
    return out


def _attention(sd, p):
    """Base cross/self attention projections (adapter overlays come from the
    ConsistentID checkpoint via convert.load_consistentid_checkpoint)."""
    return {
        "to_q": linear(sd, f"{p}.to_q", bias=False),
        "to_k": linear(sd, f"{p}.to_k", bias=False),
        "to_v": linear(sd, f"{p}.to_v", bias=False),
        "to_out": linear(sd, f"{p}.to_out.0"),
    }


def _transformer_block(sd, p):
    return {
        "norm1": layernorm(sd, f"{p}.norm1"),
        "attn1": _attention(sd, f"{p}.attn1"),
        "norm2": layernorm(sd, f"{p}.norm2"),
        "attn2": _attention(sd, f"{p}.attn2"),
        "norm3": layernorm(sd, f"{p}.norm3"),
        "ff": {"proj": linear(sd, f"{p}.ff.net.0.proj"),
               "out": linear(sd, f"{p}.ff.net.2")},
    }


def _transformer2d(sd, p, depth, use_linear):
    # 1x1 conv projections (SD1.5) or linear ones (SDXL)
    out = {"norm": _gn(sd, f"{p}.norm")}
    io_fn = linear if use_linear else conv
    out["proj_in"] = io_fn(sd, f"{p}.proj_in")
    out["proj_out"] = io_fn(sd, f"{p}.proj_out")
    for k in range(depth):
        out[f"blocks_{k}"] = _transformer_block(
            sd, f"{p}.transformer_blocks.{k}")
    return out


def unet_from_diffusers(sd: Mapping[str, np.ndarray],
                        cfg: UNetConfig) -> Dict:
    """diffusers UNet2DConditionModel -> models.unet.UNet params.

    Adapter parameters (LoRA/IP) are NOT populated here; merge a ConsistentID
    checkpoint afterwards or keep them at their zero/warm-start init.
    """
    use_linear = cfg.is_sdxl
    n = len(cfg.block_out_channels)
    out: Dict = {
        "conv_in": conv(sd, "conv_in"),
        "time_embedding": {
            "linear_1": linear(sd, "time_embedding.linear_1"),
            "linear_2": linear(sd, "time_embedding.linear_2"),
        },
        "conv_norm_out": _gn(sd, "conv_norm_out"),
        "conv_out": conv(sd, "conv_out"),
    }
    if use_linear:
        out["add_embedding"] = {
            "linear_1": linear(sd, "add_embedding.linear_1"),
            "linear_2": linear(sd, "add_embedding.linear_2"),
        }

    for level in range(n):
        p = f"down_blocks.{level}"
        for j in range(cfg.layers_per_block):
            out[f"down_{level}_resnet_{j}"] = _resnet(sd, f"{p}.resnets.{j}")
            if cfg.down_block_has_attn[level]:
                out[f"down_{level}_attn_{j}"] = _transformer2d(
                    sd, f"{p}.attentions.{j}",
                    cfg.transformer_layers_per_block[level], use_linear)
        if level < n - 1:
            out[f"down_{level}_downsample"] = {
                "conv": conv(sd, f"{p}.downsamplers.0.conv")}

    out["mid_resnet_0"] = _resnet(sd, "mid_block.resnets.0")
    out["mid_resnet_1"] = _resnet(sd, "mid_block.resnets.1")
    out["mid_attn"] = _transformer2d(sd, "mid_block.attentions.0",
                                     cfg.mid_transformer_depth, use_linear)

    for i in range(n):
        level = n - 1 - i
        p = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            out[f"up_{i}_resnet_{j}"] = _resnet(sd, f"{p}.resnets.{j}")
            if cfg.down_block_has_attn[level]:
                out[f"up_{i}_attn_{j}"] = _transformer2d(
                    sd, f"{p}.attentions.{j}",
                    cfg.transformer_layers_per_block[level], use_linear)
        if i < n - 1:
            out[f"up_{i}_upsample"] = {
                "conv": conv(sd, f"{p}.upsamplers.0.conv")}
    return out


def _vae_attention(sd, p):
    return {
        "group_norm": _gn(sd, f"{p}.group_norm"),
        "to_q": linear(sd, f"{p}.to_q"),
        "to_k": linear(sd, f"{p}.to_k"),
        "to_v": linear(sd, f"{p}.to_v"),
        "to_out": linear(sd, f"{p}.to_out.0"),
    }


def vae_from_diffusers(sd: Mapping[str, np.ndarray],
                       cfg: VAEConfig) -> Dict:
    n = len(cfg.block_out_channels)
    enc: Dict = {"conv_in": conv(sd, "encoder.conv_in"),
                 "conv_norm_out": _gn(sd, "encoder.conv_norm_out"),
                 "conv_out": conv(sd, "encoder.conv_out")}
    for level in range(n):
        p = f"encoder.down_blocks.{level}"
        for j in range(cfg.layers_per_block):
            enc[f"down_{level}_resnet_{j}"] = _resnet(
                sd, f"{p}.resnets.{j}", has_time=False)
        if level < n - 1:
            enc[f"down_{level}_downsample"] = conv(
                sd, f"{p}.downsamplers.0.conv")
    enc["mid_resnet_0"] = _resnet(sd, "encoder.mid_block.resnets.0",
                                  has_time=False)
    enc["mid_resnet_1"] = _resnet(sd, "encoder.mid_block.resnets.1",
                                  has_time=False)
    enc["mid_attn"] = _vae_attention(sd, "encoder.mid_block.attentions.0")

    dec: Dict = {"conv_in": conv(sd, "decoder.conv_in"),
                 "conv_norm_out": _gn(sd, "decoder.conv_norm_out"),
                 "conv_out": conv(sd, "decoder.conv_out")}
    dec["mid_resnet_0"] = _resnet(sd, "decoder.mid_block.resnets.0",
                                  has_time=False)
    dec["mid_resnet_1"] = _resnet(sd, "decoder.mid_block.resnets.1",
                                  has_time=False)
    dec["mid_attn"] = _vae_attention(sd, "decoder.mid_block.attentions.0")
    for i in range(n):
        p = f"decoder.up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            dec[f"up_{i}_resnet_{j}"] = _resnet(
                sd, f"{p}.resnets.{j}", has_time=False)
        if i < n - 1:
            dec[f"up_{i}_upsample"] = conv(sd, f"{p}.upsamplers.0.conv")

    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv(sd, "quant_conv"),
            "post_quant_conv": conv(sd, "post_quant_conv")}


def _clip_layer(sd, p):
    return {
        "layer_norm1": layernorm(sd, f"{p}.layer_norm1"),
        "self_attn": {
            "q_proj": linear(sd, f"{p}.self_attn.q_proj"),
            "k_proj": linear(sd, f"{p}.self_attn.k_proj"),
            "v_proj": linear(sd, f"{p}.self_attn.v_proj"),
            "out_proj": linear(sd, f"{p}.self_attn.out_proj"),
        },
        "layer_norm2": layernorm(sd, f"{p}.layer_norm2"),
        "fc1": linear(sd, f"{p}.mlp.fc1"),
        "fc2": linear(sd, f"{p}.mlp.fc2"),
    }


def clip_text_from_hf(sd: Mapping[str, np.ndarray],
                      cfg: CLIPTextConfig) -> Dict:
    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    out: Dict = {
        "token_embedding": {
            "embedding": sd[f"{pre}embeddings.token_embedding.weight"]},
        "position_embedding":
            sd[f"{pre}embeddings.position_embedding.weight"],
        "final_layer_norm": layernorm(sd, f"{pre}final_layer_norm"),
    }
    for i in range(cfg.num_layers):
        out[f"layers_{i}"] = _clip_layer(sd, f"{pre}encoder.layers.{i}")
    return out


def clip_vision_from_hf(sd: Mapping[str, np.ndarray],
                        cfg: CLIPVisionConfig) -> Dict:
    pre = ("vision_model."
           if any(k.startswith("vision_model.") for k in sd) else "")
    out: Dict = {
        "patch_embedding": conv(
            sd, f"{pre}embeddings.patch_embedding", bias=False),
        "class_embedding": sd[f"{pre}embeddings.class_embedding"].reshape(-1),
        "position_embedding":
            sd[f"{pre}embeddings.position_embedding.weight"],
        "pre_layrnorm": layernorm(sd, f"{pre}pre_layrnorm"),
        "post_layernorm": layernorm(sd, f"{pre}post_layernorm"),
    }
    for i in range(cfg.num_layers):
        out[f"layers_{i}"] = _clip_layer(sd, f"{pre}encoder.layers.{i}")
    return out


def safety_checker_from_hf(sd: Mapping[str, np.ndarray],
                           cfg: CLIPVisionConfig) -> Dict:
    """diffusers safety_checker/ dump (StableDiffusionSafetyChecker:
    vision_model.vision_model.* CLIP tower, visual_projection, and the
    concept/special-care embedding banks with their thresholds) ->
    models.safety_checker.SafetyChecker params
    (reference pipline_StableDiffusion_ConsistentID.py:586-594)."""
    # index via sd[k] (not .items()) so consumption-recording wrappers see
    # every vision-tower key (apps/validate unconsumed-key detection)
    inner = {k[len("vision_model."):]: sd[k] for k in sd
             if k.startswith("vision_model.")}
    return {
        "vision_model": clip_vision_from_hf(inner, cfg),
        "visual_projection": {
            "kernel": np.ascontiguousarray(
                sd["visual_projection.weight"].T)},
        "concept_embeds": sd["concept_embeds"],
        "special_care_embeds": sd["special_care_embeds"],
        "concept_embeds_weights": sd["concept_embeds_weights"],
        "special_care_embeds_weights": sd["special_care_embeds_weights"],
    }
