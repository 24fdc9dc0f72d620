"""HF-layout state dicts of the frozen backbones -> flax-shaped trees.

A copy of the JAX package's io/convert_backbones.py: diffusers
UNet2DConditionModel / AutoencoderKL and transformers CLIP state dicts (the
checkpoints the reference loads at
pipline_StableDiffusion_ConsistentID.py:41-57 and train.py:112-117), and
the HF Llama / LLaVA-1.5 state dicts of the FGID captioner
(data/FGID_caption.py:20), onto the trees of the JAX package's
models/unet.py, models/vae.py, models/clip.py, models/llama.py and
models/llava.py, which `io.from_jax.params_from_jax` carries into the
port's modules. The inverse maps are in io/export_backbones.py.

All tree converters take dict[str, np.ndarray] (io.safetensors_reader
output). `llava_names_from_hf` maps the same HF keys straight onto the
port's `models.llava.Llava` state-dict names, for a loader that copies
tensors shard by shard without a tree (the two agree: a test holds
`params_from_jax(llava_from_hf(sd))` to it).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

from ..core.config import (CLIPTextConfig, CLIPVisionConfig, LlamaConfig,
                           LlavaConfig, UNetConfig, VAEConfig)
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


def _llama_layer(sd, p):
    return {
        "input_layernorm": {"weight": sd[f"{p}.input_layernorm.weight"]},
        "self_attn": {
            "q_proj": linear(sd, f"{p}.self_attn.q_proj", bias=False),
            "k_proj": linear(sd, f"{p}.self_attn.k_proj", bias=False),
            "v_proj": linear(sd, f"{p}.self_attn.v_proj", bias=False),
            "o_proj": linear(sd, f"{p}.self_attn.o_proj", bias=False),
        },
        "post_attention_layernorm": {
            "weight": sd[f"{p}.post_attention_layernorm.weight"]},
        "mlp": {
            "gate_proj": linear(sd, f"{p}.mlp.gate_proj", bias=False),
            "up_proj": linear(sd, f"{p}.mlp.up_proj", bias=False),
            "down_proj": linear(sd, f"{p}.mlp.down_proj", bias=False),
        },
    }


def llama_from_hf(sd: Mapping[str, np.ndarray], cfg: LlamaConfig) -> Dict:
    """HF LlamaForCausalLM state dict -> the JAX LlamaForCausalLM tree (the
    LLaVA-1.5 language model, data/FGID_caption.py:20)."""
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    out: Dict = {
        "embed_tokens": {"embedding": sd[f"{pre}embed_tokens.weight"]},
        "norm": {"weight": sd[f"{pre}norm.weight"]},
    }
    for i in range(cfg.num_layers):
        out[f"layers_{i}"] = _llama_layer(sd, f"{pre}layers.{i}")
    if not cfg.tie_word_embeddings:
        out["lm_head"] = linear(sd, "lm_head", bias=False)
    return out


def _llava_prefixes(keys: Iterable[str]):
    """(vision tower, projector, language model) key prefixes of the modern
    `model.language_model.*` or the legacy `language_model.model.*` HF
    LLaVA layout."""
    modern = any(k.startswith("model.language_model.") for k in keys)
    if modern:
        return ("model.vision_tower.", "model.multi_modal_projector.",
                "model.language_model.")
    return "vision_tower.", "multi_modal_projector.", "language_model.model."


_LM_HEAD_KEYS = ("lm_head.weight", "language_model.lm_head.weight")


def llava_from_hf(sd: Mapping[str, np.ndarray], cfg: LlavaConfig) -> Dict:
    """HF LlavaForConditionalGeneration state dict -> the JAX
    {"mm": LlavaModel, "llama": LlamaForCausalLM} tree of models/llava.py,
    from the modern or the legacy HF key layout."""
    vt, mm, lm = _llava_prefixes(sd)
    vision_sd = {k[len(vt):]: sd[k] for k in sd if k.startswith(vt)}
    llama_sd = {"model." + k[len(lm):]: sd[k] for k in sd
                if k.startswith(lm)}
    for head_key in _LM_HEAD_KEYS:
        if head_key in sd:
            llama_sd["lm_head.weight"] = sd[head_key]
            break
    return {
        "mm": {
            "vision_tower": clip_vision_from_hf(vision_sd, cfg.vision),
            "multi_modal_projector": {
                "linear_1": linear(sd, f"{mm}linear_1"),
                "linear_2": linear(sd, f"{mm}linear_2"),
            },
        },
        "llama": llama_from_hf(llama_sd, cfg.text),
    }


_CLIP_LAYER_LEAVES = (
    "layer_norm1.weight", "layer_norm1.bias", "layer_norm2.weight",
    "layer_norm2.bias", "self_attn.q_proj.weight", "self_attn.q_proj.bias",
    "self_attn.k_proj.weight", "self_attn.k_proj.bias",
    "self_attn.v_proj.weight", "self_attn.v_proj.bias",
    "self_attn.out_proj.weight", "self_attn.out_proj.bias")
_LLAMA_LAYER_LEAVES = (
    "input_layernorm.weight", "post_attention_layernorm.weight",
    "self_attn.q_proj.weight", "self_attn.k_proj.weight",
    "self_attn.v_proj.weight", "self_attn.o_proj.weight",
    "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight")


def llava_names_from_hf(keys: Iterable[str],
                        cfg: LlavaConfig) -> Dict[str, str]:
    """{port `Llava` state-dict name: HF key} for a LLaVA-1.5 checkpoint
    with these keys (either layout), every name the float model has. The
    tensors need no transpose: both sides are torch layouts (a flattened
    vision class embedding aside, reshaped by the loader)."""
    keys = list(keys)
    vt, mm, lm = _llava_prefixes(keys)
    if any(k.startswith(vt + "vision_model.") for k in keys):
        vt += "vision_model."
    names = {
        "mm.vision_tower.patch_embedding.weight":
            f"{vt}embeddings.patch_embedding.weight",
        "mm.vision_tower.class_embedding": f"{vt}embeddings.class_embedding",
        "mm.vision_tower.position_embedding":
            f"{vt}embeddings.position_embedding.weight",
        "llama.embed_tokens.weight": f"{lm}embed_tokens.weight",
        "llama.norm.weight": f"{lm}norm.weight",
    }
    for ln in ("pre_layrnorm", "post_layernorm"):
        for leaf in ("weight", "bias"):
            names[f"mm.vision_tower.{ln}.{leaf}"] = f"{vt}{ln}.{leaf}"
    for i in range(cfg.vision.num_layers):
        for leaf in _CLIP_LAYER_LEAVES:
            names[f"mm.vision_tower.layers_{i}.{leaf}"] = \
                f"{vt}encoder.layers.{i}.{leaf}"
        for fc in ("fc1", "fc2"):
            for leaf in ("weight", "bias"):
                names[f"mm.vision_tower.layers_{i}.{fc}.{leaf}"] = \
                    f"{vt}encoder.layers.{i}.mlp.{fc}.{leaf}"
    for lin in ("linear_1", "linear_2"):
        for leaf in ("weight", "bias"):
            names[f"mm.multi_modal_projector.{lin}.{leaf}"] = \
                f"{mm}{lin}.{leaf}"
    for i in range(cfg.text.num_layers):
        for leaf in _LLAMA_LAYER_LEAVES:
            names[f"llama.layers_{i}.{leaf}"] = f"{lm}layers.{i}.{leaf}"
    if not cfg.text.tie_word_embeddings:
        head = [k for k in _LM_HEAD_KEYS if k in keys]
        names["llama.lm_head.weight"] = head[0] if head else "lm_head.weight"
    return names
