"""Inverse converters: flax-shaped trees -> reference-layout state dicts.

A copy of the JAX package's io/export_backbones.py: the maps of
io/convert_backbones.py and io/convert.py the other way, producing
diffusers-layout (UNet2DConditionModel, AutoencoderKL), transformers-layout
(CLIP text/vision, safety checker) and torch-layout (BiSeNet
face_parsing.pth, ArcFace iresnet, SCRFD) flat numpy dicts, and the
port's LLaVA-1.5 captioner as an HF llava state dict of its tensors
(`llava_to_hf`). With
`io.from_jax.tree_from_module` in front they write a port module's weights
as reference checkpoint files (chip_smoke.py's load phase, the tests'
round trips).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _arr(x) -> np.ndarray:
    return np.asarray(x)


def _linear(tree, p: str, out, bias: bool = True):
    out[f"{p}.weight"] = np.ascontiguousarray(_arr(tree["kernel"]).T)
    if bias and "bias" in tree:
        out[f"{p}.bias"] = _arr(tree["bias"])


def _conv(tree, p: str, out, bias: bool = True):
    # flax (kh, kw, I, O) -> torch (O, I, kh, kw)
    out[f"{p}.weight"] = np.ascontiguousarray(
        _arr(tree["kernel"]).transpose(3, 2, 0, 1))
    if bias and "bias" in tree:
        out[f"{p}.bias"] = _arr(tree["bias"])


def _norm(tree, p: str, out):
    out[f"{p}.weight"] = _arr(tree["scale"])
    out[f"{p}.bias"] = _arr(tree["bias"])


def _bn(params, stats, p: str, out):
    _norm(params, p, out)
    out[f"{p}.running_mean"] = _arr(stats["mean"])
    out[f"{p}.running_var"] = _arr(stats["var"])
    out[f"{p}.num_batches_tracked"] = np.zeros((), np.int64)


# -- diffusers UNet / VAE ------------------------------------------------------

def _resnet(tree, p: str, out):
    _norm(tree["norm1"], f"{p}.norm1", out)
    _conv(tree["conv1"], f"{p}.conv1", out)
    _norm(tree["norm2"], f"{p}.norm2", out)
    _conv(tree["conv2"], f"{p}.conv2", out)
    if "time_emb_proj" in tree:
        _linear(tree["time_emb_proj"], f"{p}.time_emb_proj", out)
    if "conv_shortcut" in tree:
        _conv(tree["conv_shortcut"], f"{p}.conv_shortcut", out)


def _attention(tree, p: str, out):
    _linear(tree["to_q"], f"{p}.to_q", out, bias=False)
    _linear(tree["to_k"], f"{p}.to_k", out, bias=False)
    _linear(tree["to_v"], f"{p}.to_v", out, bias=False)
    _linear(tree["to_out"], f"{p}.to_out.0", out)


def _transformer_block(tree, p: str, out):
    _norm(tree["norm1"], f"{p}.norm1", out)
    _attention(tree["attn1"], f"{p}.attn1", out)
    _norm(tree["norm2"], f"{p}.norm2", out)
    _attention(tree["attn2"], f"{p}.attn2", out)
    _norm(tree["norm3"], f"{p}.norm3", out)
    _linear(tree["ff"]["proj"], f"{p}.ff.net.0.proj", out)
    _linear(tree["ff"]["out"], f"{p}.ff.net.2", out)


def _transformer2d(tree, p: str, out, depth: int, use_linear: bool):
    # 1x1 conv projections (SD1.5) or linear ones (SDXL)
    _norm(tree["norm"], f"{p}.norm", out)
    io_fn = _linear if use_linear else _conv
    io_fn(tree["proj_in"], f"{p}.proj_in", out)
    io_fn(tree["proj_out"], f"{p}.proj_out", out)
    for k in range(depth):
        _transformer_block(tree[f"blocks_{k}"],
                           f"{p}.transformer_blocks.{k}", out)


def unet_to_diffusers(tree, cfg) -> Dict[str, np.ndarray]:
    """models.unet.UNet params -> diffusers UNet2DConditionModel state dict.

    Adapter params (LoRA / to_k_ip / to_v_ip) are intentionally skipped —
    those belong in the ConsistentID .bin
    (convert.export_consistentid_checkpoint)."""
    use_linear = cfg.is_sdxl
    n = len(cfg.block_out_channels)
    out: Dict[str, np.ndarray] = {}
    _conv(tree["conv_in"], "conv_in", out)
    _linear(tree["time_embedding"]["linear_1"], "time_embedding.linear_1", out)
    _linear(tree["time_embedding"]["linear_2"], "time_embedding.linear_2", out)
    _norm(tree["conv_norm_out"], "conv_norm_out", out)
    _conv(tree["conv_out"], "conv_out", out)
    if use_linear:
        _linear(tree["add_embedding"]["linear_1"],
                "add_embedding.linear_1", out)
        _linear(tree["add_embedding"]["linear_2"],
                "add_embedding.linear_2", out)

    for level in range(n):
        p = f"down_blocks.{level}"
        for j in range(cfg.layers_per_block):
            _resnet(tree[f"down_{level}_resnet_{j}"], f"{p}.resnets.{j}", out)
            if cfg.down_block_has_attn[level]:
                _transformer2d(tree[f"down_{level}_attn_{j}"],
                               f"{p}.attentions.{j}", out,
                               cfg.transformer_layers_per_block[level],
                               use_linear)
        if level < n - 1:
            _conv(tree[f"down_{level}_downsample"]["conv"],
                  f"{p}.downsamplers.0.conv", out)

    _resnet(tree["mid_resnet_0"], "mid_block.resnets.0", out)
    _resnet(tree["mid_resnet_1"], "mid_block.resnets.1", out)
    _transformer2d(tree["mid_attn"], "mid_block.attentions.0", out,
                   cfg.mid_transformer_depth, use_linear)

    for i in range(n):
        level = n - 1 - i
        p = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            _resnet(tree[f"up_{i}_resnet_{j}"], f"{p}.resnets.{j}", out)
            if cfg.down_block_has_attn[level]:
                _transformer2d(tree[f"up_{i}_attn_{j}"],
                               f"{p}.attentions.{j}", out,
                               cfg.transformer_layers_per_block[level],
                               use_linear)
        if i < n - 1:
            _conv(tree[f"up_{i}_upsample"]["conv"],
                  f"{p}.upsamplers.0.conv", out)
    return out


def _vae_attention(tree, p: str, out):
    _norm(tree["group_norm"], f"{p}.group_norm", out)
    for name in ("to_q", "to_k", "to_v"):
        _linear(tree[name], f"{p}.{name}", out)
    _linear(tree["to_out"], f"{p}.to_out.0", out)


def vae_to_diffusers(tree, cfg) -> Dict[str, np.ndarray]:
    n = len(cfg.block_out_channels)
    out: Dict[str, np.ndarray] = {}
    enc = tree["encoder"]
    _conv(enc["conv_in"], "encoder.conv_in", out)
    _norm(enc["conv_norm_out"], "encoder.conv_norm_out", out)
    _conv(enc["conv_out"], "encoder.conv_out", out)
    for level in range(n):
        p = f"encoder.down_blocks.{level}"
        for j in range(cfg.layers_per_block):
            _resnet(enc[f"down_{level}_resnet_{j}"], f"{p}.resnets.{j}", out)
        if level < n - 1:
            _conv(enc[f"down_{level}_downsample"],
                  f"{p}.downsamplers.0.conv", out)
    _resnet(enc["mid_resnet_0"], "encoder.mid_block.resnets.0", out)
    _resnet(enc["mid_resnet_1"], "encoder.mid_block.resnets.1", out)
    _vae_attention(enc["mid_attn"], "encoder.mid_block.attentions.0", out)

    dec = tree["decoder"]
    _conv(dec["conv_in"], "decoder.conv_in", out)
    _norm(dec["conv_norm_out"], "decoder.conv_norm_out", out)
    _conv(dec["conv_out"], "decoder.conv_out", out)
    _resnet(dec["mid_resnet_0"], "decoder.mid_block.resnets.0", out)
    _resnet(dec["mid_resnet_1"], "decoder.mid_block.resnets.1", out)
    _vae_attention(dec["mid_attn"], "decoder.mid_block.attentions.0", out)
    for i in range(n):
        p = f"decoder.up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            _resnet(dec[f"up_{i}_resnet_{j}"], f"{p}.resnets.{j}", out)
        if i < n - 1:
            _conv(dec[f"up_{i}_upsample"], f"{p}.upsamplers.0.conv", out)

    _conv(tree["quant_conv"], "quant_conv", out)
    _conv(tree["post_quant_conv"], "post_quant_conv", out)
    return out


# -- transformers CLIP ---------------------------------------------------------

def _clip_layer(tree, p: str, out):
    _norm(tree["layer_norm1"], f"{p}.layer_norm1", out)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(tree["self_attn"][name], f"{p}.self_attn.{name}", out)
    _norm(tree["layer_norm2"], f"{p}.layer_norm2", out)
    _linear(tree["fc1"], f"{p}.mlp.fc1", out)
    _linear(tree["fc2"], f"{p}.mlp.fc2", out)


def clip_text_to_hf(tree, cfg, prefix: str = "text_model.") -> Dict:
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}embeddings.token_embedding.weight"] = _arr(
        tree["token_embedding"]["embedding"])
    out[f"{prefix}embeddings.position_embedding.weight"] = _arr(
        tree["position_embedding"])
    _norm(tree["final_layer_norm"], f"{prefix}final_layer_norm", out)
    for i in range(cfg.num_layers):
        _clip_layer(tree[f"layers_{i}"], f"{prefix}encoder.layers.{i}", out)
    return out


def clip_vision_to_hf(tree, cfg, prefix: str = "vision_model.") -> Dict:
    out: Dict[str, np.ndarray] = {}
    _conv(tree["patch_embedding"], f"{prefix}embeddings.patch_embedding",
          out, bias=False)
    out[f"{prefix}embeddings.class_embedding"] = _arr(
        tree["class_embedding"]).reshape(-1)
    out[f"{prefix}embeddings.position_embedding.weight"] = _arr(
        tree["position_embedding"])
    _norm(tree["pre_layrnorm"], f"{prefix}pre_layrnorm", out)
    _norm(tree["post_layernorm"], f"{prefix}post_layernorm", out)
    for i in range(cfg.num_layers):
        _clip_layer(tree[f"layers_{i}"], f"{prefix}encoder.layers.{i}", out)
    return out


def safety_checker_to_hf(tree, cfg) -> Dict[str, np.ndarray]:
    out = clip_vision_to_hf(tree["vision_model"], cfg,
                            prefix="vision_model.vision_model.")
    out["visual_projection.weight"] = np.ascontiguousarray(
        _arr(tree["visual_projection"]["kernel"]).T)
    for k in ("concept_embeds", "special_care_embeds",
              "concept_embeds_weights", "special_care_embeds_weights"):
        out[k] = _arr(tree[k])
    return out


# -- torch BiSeNet / ArcFace iresnet / SCRFD -----------------------------------

def _conv_bn_relu(params, stats, p: str, out):
    _conv(params["conv"], f"{p}.conv", out, bias=False)
    _bn(params["bn"], stats["bn"], f"{p}.bn", out)


def _basic_block(params, stats, p: str, out, v1e: bool = False):
    _conv(params["conv1"], f"{p}.conv1", out, bias=False)
    _bn(params["bn1"], stats["bn1"], f"{p}.bn1", out)
    _conv(params["conv2"], f"{p}.conv2", out, bias=False)
    _bn(params["bn2"], stats["bn2"], f"{p}.bn2", out)
    if "downsample_conv" in params:
        # ResNetV1e avg_down shortcut parks a param-free AvgPool at .0
        ci, bi = ((1, 2) if v1e else (0, 1))
        _conv(params["downsample_conv"], f"{p}.downsample.{ci}", out,
              bias=False)
        _bn(params["downsample_bn"], stats["downsample_bn"],
            f"{p}.downsample.{bi}", out)


def bisenet_to_torch(params, stats) -> Dict[str, np.ndarray]:
    """Inverse of convert.bisenet_from_torch (face_parsing.pth layout)."""
    out: Dict[str, np.ndarray] = {}
    rp, rs = params["cp"]["resnet"], stats["cp"]["resnet"]
    _conv(rp["conv1"], "cp.resnet.conv1", out, bias=False)
    _bn(rp["bn1"], rs["bn1"], "cp.resnet.bn1", out)
    for layer in range(1, 5):
        for i in range(2):
            _basic_block(rp[f"layer{layer}_{i}"], rs[f"layer{layer}_{i}"],
                         f"cp.resnet.layer{layer}.{i}", out)
    for arm in ("arm16", "arm32"):
        ap, as_ = params["cp"][arm], stats["cp"][arm]
        _conv_bn_relu(ap["conv"], as_["conv"], f"cp.{arm}.conv", out)
        _conv(ap["conv_atten"], f"cp.{arm}.conv_atten", out, bias=False)
        _bn(ap["bn_atten"], as_["bn_atten"], f"cp.{arm}.bn_atten", out)
    for head in ("conv_head16", "conv_head32", "conv_avg"):
        _conv_bn_relu(params["cp"][head], stats["cp"][head],
                      f"cp.{head}", out)
    _conv_bn_relu(params["ffm"]["convblk"], stats["ffm"]["convblk"],
                  "ffm.convblk", out)
    _conv(params["ffm"]["conv1"], "ffm.conv1", out, bias=False)
    _conv(params["ffm"]["conv2"], "ffm.conv2", out, bias=False)
    for head in ("conv_out", "conv_out16", "conv_out32"):
        _conv_bn_relu(params[head]["conv"], stats[head]["conv"],
                      f"{head}.conv", out)
        _conv(params[head]["conv_out"], f"{head}.conv_out", out, bias=False)
    return out


def iresnet_to_torch(params, stats, layers=(3, 4, 14, 3),
                     spatial: int = 7) -> Dict[str, np.ndarray]:
    """Inverse of convert.iresnet_from_torch (w600k_r50-style layout)."""
    out: Dict[str, np.ndarray] = {}
    _conv(params["conv1"], "conv1", out, bias=False)
    _bn(params["bn1"], stats["bn1"], "bn1", out)
    out["prelu.weight"] = _arr(params["prelu"]["alpha"])
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            p = f"layer{li + 1}.{bi}"
            bp, bs = params[f"layer{li + 1}_{bi}"], stats[f"layer{li + 1}_{bi}"]
            _bn(bp["bn1"], bs["bn1"], f"{p}.bn1", out)
            _conv(bp["conv1"], f"{p}.conv1", out, bias=False)
            _bn(bp["bn2"], bs["bn2"], f"{p}.bn2", out)
            out[f"{p}.prelu.weight"] = _arr(bp["prelu"]["alpha"])
            _conv(bp["conv2"], f"{p}.conv2", out, bias=False)
            _bn(bp["bn3"], bs["bn3"], f"{p}.bn3", out)
            if "downsample_conv" in bp:
                _conv(bp["downsample_conv"], f"{p}.downsample.0", out,
                      bias=False)
                _bn(bp["downsample_bn"], bs["downsample_bn"],
                    f"{p}.downsample.1", out)
    _bn(params["bn2"], stats["bn2"], "bn2", out)
    # fc kernel (H*W*C, out) with NHWC flatten -> torch (out, C*H*W)
    k = _arr(params["fc"]["kernel"])
    out_dim = k.shape[1]
    c = k.shape[0] // (spatial * spatial)
    w = k.reshape(spatial, spatial, c, out_dim).transpose(3, 2, 0, 1)
    out["fc.weight"] = np.ascontiguousarray(
        w.reshape(out_dim, c * spatial * spatial))
    out["fc.bias"] = _arr(params["fc"]["bias"])
    out["features.weight"] = _arr(params["features"]["scale"])
    out["features.bias"] = _arr(params["features"]["bias"])
    out["features.running_mean"] = _arr(stats["features"]["mean"])
    out["features.running_var"] = _arr(stats["features"]["var"])
    return out


def scrfd_to_torch(params, stats, cfg) -> Dict[str, np.ndarray]:
    """Inverse of convert.scrfd_from_torch (insightface det_*.onnx naming)."""
    out: Dict[str, np.ndarray] = {}
    bp, bs = params["backbone"], stats["backbone"]
    for i, idx in enumerate((0, 3, 6)):
        _conv(bp[f"stem_conv{i}"], f"backbone.stem.{idx}", out, bias=False)
        _bn(bp[f"stem_bn{i}"], bs[f"stem_bn{i}"],
            f"backbone.stem.{idx + 1}", out)
    for li, n_blocks in enumerate(cfg.stage_blocks):
        for bi in range(n_blocks):
            _basic_block(bp[f"layer{li + 1}_{bi}"], bs[f"layer{li + 1}_{bi}"],
                         f"backbone.layer{li + 1}.{bi}", out, v1e=True)
    np_ = params["neck"]
    for i in range(3):
        _conv(np_[f"lateral_{i}"], f"neck.lateral_convs.{i}.conv", out)
        _conv(np_[f"fpn_{i}"], f"neck.fpn_convs.{i}.conv", out)
    for i in range(2):
        _conv(np_[f"downsample_{i}"], f"neck.downsample_convs.{i}.conv", out)
        _conv(np_[f"pafpn_{i}"], f"neck.pafpn_convs.{i}.conv", out)
    hp = params["head"]
    hs = stats.get("head", {})
    keys = ["0"] if cfg.strides_share else [str(s) for s in cfg.strides]
    for key in keys:
        for j in range(cfg.head_stacked_convs):
            branches = [("cls", f"bbox_head.cls_stride_convs.{key}.{j}")]
            if not cfg.cls_reg_share:
                branches.append(
                    ("reg", f"bbox_head.reg_stride_convs.{key}.{j}"))
            for b, tp in branches:
                _conv(hp[f"{b}_convs_{key}_{j}"], f"{tp}.conv", out,
                      bias=False)
                if cfg.norm == "gn":
                    _norm(hp[f"{b}_norm_{key}_{j}"], f"{tp}.gn", out)
                else:
                    _bn(hp[f"{b}_norm_{key}_{j}"], hs[f"{b}_norm_{key}_{j}"],
                        f"{tp}.bn", out)
        _conv(hp[f"cls_pred_{key}"], f"bbox_head.stride_cls.{key}", out)
        _conv(hp[f"reg_pred_{key}"], f"bbox_head.stride_reg.{key}", out)
        if cfg.use_kps:
            _conv(hp[f"kps_pred_{key}"], f"bbox_head.stride_kps.{key}", out)
    for i in range(len(cfg.strides)):
        out[f"bbox_head.scales.{i}.scale"] = _arr(
            hp[f"scale_{i}"]).reshape(())
    return out


def llava_to_hf(state: Mapping, cfg, layout: str = "modern") -> Dict:
    """A `models.llava.Llava` state dict (float) -> an HF
    LlavaForConditionalGeneration state dict in the `modern`
    (model.language_model.*) or `legacy` (language_model.model.*) key
    layout: the inverse of `io.convert_backbones.llava_names_from_hf`,
    the tensors themselves (no copy, no transpose)."""
    from .convert_backbones import llava_names_from_hf

    if layout == "modern":
        keys = ["model.language_model.", "model.vision_tower.vision_model."]
    elif layout == "legacy":
        keys = ["vision_tower.vision_model."]
    else:
        raise ValueError(f"layout {layout!r}: modern or legacy")
    out = {hf: state[port]
           for port, hf in llava_names_from_hf(keys, cfg).items()}
    if layout == "legacy" and "lm_head.weight" in out:
        out["language_model.lm_head.weight"] = out.pop("lm_head.weight")
    return out
