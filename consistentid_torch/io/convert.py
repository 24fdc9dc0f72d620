"""Reference checkpoint layouts -> flax-shaped parameter trees, and back.

A copy of the from-torch half of the JAX package's io/convert.py, numpy
only, with its own nested-dict flattening in place of flax's:
  - ConsistentID-v1.bin: {image_proj(_model), adapter_modules,
    FacialEncoder} (reference evaluation/convert_weights.py:14-25,
    pipline_StableDiffusion_ConsistentID.py:125-144), and its exporter
    `export_consistentid_checkpoint`;
  - face_parsing.pth (BiSeNet), SCRFD and ArcFace iresnet state dicts, with
    the configs read off their names and shapes.
The trees have the JAX package's layout (Dense "kernel" (in, out), conv
HWIO, norm "scale", BatchNorm statistics apart), so `io.from_jax`
(`params_from_jax`, `state_from_jax`) carries them into the port's modules
by the same one mapping that carries JAX parameters. Inputs are plain
dict[str, np.ndarray] (`io.safetensors_reader.read_checkpoint`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np


def flatten_tree(tree: Mapping, prefix: Tuple = ()) -> Dict[Tuple, Any]:
    """Nested mappings -> {path tuple: leaf}."""
    out: Dict[Tuple, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def unflatten_tree(flat: Mapping[Tuple, Any]) -> Dict:
    out: Dict = {}
    for path, val in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return out


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


# -- primitive layer converters ---------------------------------------------

# The kernels are transposed views of the read arrays, not copies: the
# loaders (params_from_jax) transpose them back, which then gives the read
# array's own contiguous layout, so a checkpoint is never copied through a
# strided transpose on the host (numpy's runs at a fraction of memcpy).

def linear(sd: Mapping[str, np.ndarray], prefix: str, bias: bool = True):
    p = {"kernel": sd[f"{prefix}.weight"].T}
    if bias:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def layernorm(sd: Mapping[str, np.ndarray], prefix: str):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def groupnorm(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def conv(sd: Mapping[str, np.ndarray], prefix: str, bias: bool = True):
    # torch conv weight (O, I, kh, kw) -> flax (kh, kw, I, O)
    p = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}
    if bias:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def embedding(sd, prefix):
    return {"embedding": sd[f"{prefix}.weight"]}


# -- adapter converters ------------------------------------------------------

def perceiver_attention(sd, p: str):
    return {
        "norm1": layernorm(sd, _join(p, "norm1")),
        "norm2": layernorm(sd, _join(p, "norm2")),
        "to_q": linear(sd, _join(p, "to_q"), bias=False),
        "to_kv": linear(sd, _join(p, "to_kv"), bias=False),
        "to_out": linear(sd, _join(p, "to_out"), bias=False),
    }


def feedforward(sd, p: str):
    # torch Sequential: 0 LayerNorm, 1 Linear(no bias), 2 GELU, 3 Linear(no bias)
    return {
        "norm": layernorm(sd, _join(p, "0")),
        "fc1": linear(sd, _join(p, "1"), bias=False),
        "fc2": linear(sd, _join(p, "3"), bias=False),
    }


def _count_perceiver_layers(sd, p: str) -> int:
    """Infer a resampler/AttentionMLP stack's depth from its key names, so
    any checkpoint variant loads without a depth table."""
    n = 0
    while _join(p, f"layers.{n}.0.norm1.weight") in sd:
        n += 1
    return n


def face_perceiver_resampler(sd, p: str = "", depth: int = None):
    if depth is None:
        depth = _count_perceiver_layers(sd, p)
    out = {
        "proj_in": linear(sd, _join(p, "proj_in")),
        "proj_out": linear(sd, _join(p, "proj_out")),
        "norm_out": layernorm(sd, _join(p, "norm_out")),
    }
    for i in range(depth):
        out[f"layers_{i}_attn"] = perceiver_attention(sd, _join(p, f"layers.{i}.0"))
        out[f"layers_{i}_ff"] = feedforward(sd, _join(p, f"layers.{i}.1"))
    return out


def proj_plus_model(sd, p: str = "", depth: int = None):
    return {
        "proj_0": linear(sd, _join(p, "proj.0")),
        "proj_2": linear(sd, _join(p, "proj.2")),
        "norm": layernorm(sd, _join(p, "norm")),
        "perceiver_resampler": face_perceiver_resampler(
            sd, _join(p, "perceiver_resampler"), depth),
    }


def attention_mlp(sd, p: str = "", depth: int = None):
    if depth is None:
        depth = _count_perceiver_layers(sd, p)
    out = {
        "latents": sd[_join(p, "latents")],
        "proj_in": linear(sd, _join(p, "proj_in")),
        "proj_out": linear(sd, _join(p, "proj_out")),
        "norm_out": layernorm(sd, _join(p, "norm_out")),
    }
    for i in range(depth):
        out[f"layers_{i}_attn"] = perceiver_attention(sd, _join(p, f"layers.{i}.0"))
        out[f"layers_{i}_ff"] = feedforward(sd, _join(p, f"layers.{i}.1"))
    return out


def mlp(sd, p: str):
    return {
        "layernorm": layernorm(sd, _join(p, "layernorm")),
        "fc1": linear(sd, _join(p, "fc1")),
        "fc2": linear(sd, _join(p, "fc2")),
    }


def fuse_module(sd, p: str = ""):
    return {
        "mlp1": mlp(sd, _join(p, "mlp1")),
        "mlp2": mlp(sd, _join(p, "mlp2")),
        "layer_norm": layernorm(sd, _join(p, "layer_norm")),
    }


def facial_encoder(sd, p: str = "", depth: int = None):
    return {
        "visual_projection": attention_mlp(sd, _join(p, "visual_projection"), depth),
        "fuse_module": fuse_module(sd, _join(p, "fuse_module")),
    }


def lora_layer(sd, p: str):
    return {
        "down": linear(sd, _join(p, "down"), bias=False),
        "up": linear(sd, _join(p, "up"), bias=False),
    }


def consistent_att_processor(sd, p: str):
    """LoRA-only self-attn processor params (reference attention.py:90-108)."""
    return {
        "to_q_lora": lora_layer(sd, _join(p, "to_q_lora")),
        "to_k_lora": lora_layer(sd, _join(p, "to_k_lora")),
        "to_v_lora": lora_layer(sd, _join(p, "to_v_lora")),
        "to_out_lora": lora_layer(sd, _join(p, "to_out_lora")),
    }


def consistent_ip_att_processor(sd, p: str):
    """LoRA + decoupled-IP cross-attn processor params (attention.py:177-205)."""
    out = consistent_att_processor(sd, p)
    out["to_k_ip"] = linear(sd, _join(p, "to_k_ip"), bias=False)
    out["to_v_ip"] = linear(sd, _join(p, "to_v_ip"), bias=False)
    return out


# -- UNet attention-processor ordering ---------------------------------------

def unet_attention_paths(cfg) -> list:
    """Flax param paths of every UNet attention module, in the reference's
    adapter_modules ModuleList order (= diffusers unet.attn_processors
    iteration order: down_blocks, up_blocks, mid_block — torch registers
    mid_block last because its first assignment is `None`; see
    reference train.py:155-177, pipline_StableDiffusion_ConsistentID.py:143).

    Returns [(path_tuple, is_cross), ...] where each attention contributes
    its attn1 (self) then attn2 (cross) processor.
    """
    paths = []
    n = len(cfg.block_out_channels)

    def add(block, depth):
        for k in range(depth):
            paths.append(((*block, f"blocks_{k}", "attn1"), False))
            paths.append(((*block, f"blocks_{k}", "attn2"), True))

    for level in range(n):
        if not cfg.down_block_has_attn[level]:
            continue
        for j in range(cfg.layers_per_block):
            add((f"down_{level}_attn_{j}",),
                cfg.transformer_layers_per_block[level])
    for i in range(n):
        level = n - 1 - i
        if not cfg.down_block_has_attn[level]:
            continue
        for j in range(cfg.layers_per_block + 1):
            add((f"up_{i}_attn_{j}",),
                cfg.transformer_layers_per_block[level])
    add(("mid_attn",), cfg.mid_transformer_depth)
    return paths


def adapter_processor_params(sd: Mapping[str, np.ndarray], index: int,
                             is_cross: bool) -> Dict[str, Any]:
    """Params of adapter_modules.{index} mapped onto our attention module's
    LoRA (+ IP) parameter names."""
    p = f"{index}"
    out = {
        "to_q_lora": lora_layer(sd, f"{p}.to_q_lora"),
        "to_k_lora": lora_layer(sd, f"{p}.to_k_lora"),
        "to_v_lora": lora_layer(sd, f"{p}.to_v_lora"),
        "to_out_lora": lora_layer(sd, f"{p}.to_out_lora"),
    }
    if is_cross:
        out["to_k_ip"] = linear(sd, f"{p}.to_k_ip", bias=False)
        out["to_v_ip"] = linear(sd, f"{p}.to_v_ip", bias=False)
    return out


def consistentid_checkpoint_tree(state_dict: Mapping, unet_cfg) -> Dict:
    """The tree a reference ConsistentID checkpoint ({FacialEncoder,
    image_proj, adapter_modules}; SDXL names image_proj_model) carries:
    {"proj", "facial_encoder", "unet": every attention's LoRA (+ IP)}."""
    proj_sd = state_dict.get("image_proj") or state_dict["image_proj_model"]
    flat = {("proj",) + k: v for k, v in flatten_tree(
        proj_plus_model(proj_sd)).items()}
    flat.update({("facial_encoder",) + k: v for k, v in flatten_tree(
        facial_encoder(state_dict["FacialEncoder"])).items()})
    ad_sd = state_dict["adapter_modules"]
    for idx, (path, is_cross) in enumerate(unet_attention_paths(unet_cfg)):
        proc = adapter_processor_params(ad_sd, idx, is_cross)
        for k, v in flatten_tree(proc).items():
            flat[("unet",) + path + k] = v
    return unflatten_tree(flat)


def load_consistentid_checkpoint(params: Dict, state_dict: Dict,
                                 unet_cfg) -> Dict:
    """Merge a reference ConsistentID checkpoint into a params bundle tree
    (pipline_StableDiffusion_ConsistentID.py:141-144): every adapter leaf
    must already be in the tree, at its shape. Tensors must be numpy."""
    new = dict(flatten_tree(params))
    for full, v in flatten_tree(
            consistentid_checkpoint_tree(state_dict, unet_cfg)).items():
        if full[0] == "unet" and full not in new:
            raise KeyError(f"unknown adapter target {full}")
        if full[0] == "unet" and new[full].shape != v.shape:
            raise ValueError(f"{full}: {new[full].shape} vs {v.shape}")
        new[full] = v
    return unflatten_tree(new)


# -- BiSeNet (face_parsing.pth layout) ----------------------------------------

def _bn(sd, p):
    params = {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}
    stats = {"mean": sd[f"{p}.running_mean"], "var": sd[f"{p}.running_var"]}
    return params, stats


def _conv_bn_relu(sd, p, out_p, out_s):
    out_p["conv"] = conv(sd, f"{p}.conv", bias=False)
    bn_p, bn_s = _bn(sd, f"{p}.bn")
    out_p["bn"], out_s["bn"] = bn_p, bn_s


def _basic_block(sd, p):
    params, stats = {}, {}
    params["conv1"] = conv(sd, f"{p}.conv1", bias=False)
    params["bn1"], stats["bn1"] = _bn(sd, f"{p}.bn1")
    params["conv2"] = conv(sd, f"{p}.conv2", bias=False)
    params["bn2"], stats["bn2"] = _bn(sd, f"{p}.bn2")
    if f"{p}.downsample.0.weight" in sd:
        params["downsample_conv"] = conv(sd, f"{p}.downsample.0", bias=False)
        params["downsample_bn"], stats["downsample_bn"] = _bn(
            sd, f"{p}.downsample.1")
    return params, stats


def _arm(sd, p):
    params, stats = {"conv": {}}, {"conv": {}}
    _conv_bn_relu(sd, f"{p}.conv", params["conv"], stats["conv"])
    params["conv_atten"] = conv(sd, f"{p}.conv_atten", bias=False)
    params["bn_atten"], stats["bn_atten"] = _bn(sd, f"{p}.bn_atten")
    return params, stats


def _bisenet_output(sd, p):
    params, stats = {"conv": {}}, {"conv": {}}
    _conv_bn_relu(sd, f"{p}.conv", params["conv"], stats["conv"])
    params["conv_out"] = conv(sd, f"{p}.conv_out", bias=False)
    return params, stats


def bisenet_from_torch(sd: Mapping[str, np.ndarray]):
    """face_parsing.pth (reference BiSeNet state dict,
    pipline_StableDiffusion_ConsistentID.py:67-71) -> (params, batch_stats)."""
    params, stats = {"cp": {"resnet": {}}}, {"cp": {"resnet": {}}}
    rp, rs = params["cp"]["resnet"], stats["cp"]["resnet"]
    rp["conv1"] = conv(sd, "cp.resnet.conv1", bias=False)
    rp["bn1"], rs["bn1"] = _bn(sd, "cp.resnet.bn1")
    for layer in range(1, 5):
        for i in range(2):
            name = f"layer{layer}_{i}"
            rp[name], rs[name] = _basic_block(
                sd, f"cp.resnet.layer{layer}.{i}")
    for arm in ("arm16", "arm32"):
        params["cp"][arm], stats["cp"][arm] = _arm(sd, f"cp.{arm}")
    for head in ("conv_head16", "conv_head32", "conv_avg"):
        params["cp"][head], stats["cp"][head] = {}, {}
        _conv_bn_relu(sd, f"cp.{head}", params["cp"][head],
                      stats["cp"][head])
    params["ffm"], stats["ffm"] = {"convblk": {}}, {"convblk": {}}
    _conv_bn_relu(sd, "ffm.convblk", params["ffm"]["convblk"],
                  stats["ffm"]["convblk"])
    params["ffm"]["conv1"] = conv(sd, "ffm.conv1", bias=False)
    params["ffm"]["conv2"] = conv(sd, "ffm.conv2", bias=False)
    for head in ("conv_out", "conv_out16", "conv_out32"):
        params[head], stats[head] = _bisenet_output(sd, head)
    return params, stats


# -- SCRFD face detector (mmdet-style torch/ONNX-export naming) ---------------

def scrfd_config_from_state(sd: Mapping[str, np.ndarray]):
    """Infer an SCRFDConfig from a checkpoint's names+shapes, so a wrong
    variant-table entry can never silently corrupt a real-weight load
    (the ONNX pack is the source of truth for the NAS-derived widths)."""
    from ..models.scrfd import SCRFDConfig

    stem_channels = sd["backbone.stem.0.weight"].shape[0]
    stage_blocks, stage_planes = [], []
    for li in range(1, 9):
        if f"backbone.layer{li}.0.conv1.weight" not in sd:
            break
        n = 0
        while f"backbone.layer{li}.{n}.conv1.weight" in sd:
            n += 1
        stage_blocks.append(n)
        stage_planes.append(sd[f"backbone.layer{li}.0.conv1.weight"].shape[0])
    neck_out = sd["neck.lateral_convs.0.conv.weight"].shape[0]
    strides_share = "bbox_head.stride_cls.0.weight" in sd or \
        "bbox_head.cls_stride_convs.0.0.conv.weight" in sd
    key = "0" if strides_share else "8"
    n_stack = 0
    while f"bbox_head.cls_stride_convs.{key}.{n_stack}.conv.weight" in sd:
        n_stack += 1
    feat = sd[f"bbox_head.cls_stride_convs.{key}.0.conv.weight"].shape[0]
    norm = "gn" if f"bbox_head.cls_stride_convs.{key}.0.gn.weight" in sd \
        else "bn"
    use_kps = any(k.startswith("bbox_head.stride_kps") for k in sd)
    cls_reg_share = not any(
        k.startswith("bbox_head.reg_stride_convs") for k in sd)
    num_anchors = sd[f"bbox_head.stride_cls.{key}.weight"].shape[0]
    return SCRFDConfig(
        stem_channels=stem_channels, stage_blocks=tuple(stage_blocks),
        stage_planes=tuple(stage_planes), neck_out_channels=neck_out,
        head_stacked_convs=n_stack, head_feat_channels=feat,
        num_anchors=num_anchors, use_kps=use_kps, norm=norm,
        strides_share=strides_share, cls_reg_share=cls_reg_share)


def _head_norm(sd, p, norm):
    if norm == "gn":
        return ({"scale": sd[f"{p}.gn.weight"],
                 "bias": sd[f"{p}.gn.bias"]}, None)
    return _bn(sd, f"{p}.bn")


def scrfd_from_torch(sd: Mapping[str, np.ndarray], cfg=None):
    """SCRFD state dict (mmdet naming as preserved by the insightface ONNX
    export: backbone.stem/layer{i}, neck.lateral_convs/fpn_convs/
    downsample_convs/pafpn_convs, bbox_head.cls_stride_convs/stride_cls/
    stride_reg/stride_kps/scales) -> (params, batch_stats, config) for
    models.scrfd.SCRFD."""
    if cfg is None:
        cfg = scrfd_config_from_state(sd)
    bp, bs = {}, {}
    for i, idx in enumerate((0, 3, 6)):
        bp[f"stem_conv{i}"] = conv(sd, f"backbone.stem.{idx}", bias=False)
        bp[f"stem_bn{i}"], bs[f"stem_bn{i}"] = _bn(
            sd, f"backbone.stem.{idx + 1}")
    for li, n_blocks in enumerate(cfg.stage_blocks):
        for bi in range(n_blocks):
            p = f"backbone.layer{li + 1}.{bi}"
            name = f"layer{li + 1}_{bi}"
            blk_p, blk_s = _basic_block(sd, p)
            # ResNetV1e avg_down shortcut: downsample.0 is a (param-free)
            # AvgPool, conv sits at .1 and bn at .2
            if f"{p}.downsample.1.weight" in sd and \
                    f"{p}.downsample.0.weight" not in sd:
                blk_p["downsample_conv"] = conv(sd, f"{p}.downsample.1",
                                                bias=False)
                blk_p["downsample_bn"], blk_s["downsample_bn"] = _bn(
                    sd, f"{p}.downsample.2")
            bp[name], bs[name] = blk_p, blk_s

    np_, ns_ = {}, {}
    n_levels = 3
    for i in range(n_levels):
        np_[f"lateral_{i}"] = conv(sd, f"neck.lateral_convs.{i}.conv")
        np_[f"fpn_{i}"] = conv(sd, f"neck.fpn_convs.{i}.conv")
    for i in range(n_levels - 1):
        np_[f"downsample_{i}"] = conv(sd, f"neck.downsample_convs.{i}.conv")
        np_[f"pafpn_{i}"] = conv(sd, f"neck.pafpn_convs.{i}.conv")

    hp, hs = {}, {}
    keys = ["0"] if cfg.strides_share else [str(s) for s in cfg.strides]
    for key in keys:
        for j in range(cfg.head_stacked_convs):
            tp = f"bbox_head.cls_stride_convs.{key}.{j}"
            hp[f"cls_convs_{key}_{j}"] = conv(sd, f"{tp}.conv", bias=False)
            n_p, n_s = _head_norm(sd, tp, cfg.norm)
            hp[f"cls_norm_{key}_{j}"] = n_p
            if n_s is not None:
                hs[f"cls_norm_{key}_{j}"] = n_s
            if not cfg.cls_reg_share:
                tp = f"bbox_head.reg_stride_convs.{key}.{j}"
                hp[f"reg_convs_{key}_{j}"] = conv(sd, f"{tp}.conv",
                                                  bias=False)
                n_p, n_s = _head_norm(sd, tp, cfg.norm)
                hp[f"reg_norm_{key}_{j}"] = n_p
                if n_s is not None:
                    hs[f"reg_norm_{key}_{j}"] = n_s
        hp[f"cls_pred_{key}"] = conv(sd, f"bbox_head.stride_cls.{key}")
        hp[f"reg_pred_{key}"] = conv(sd, f"bbox_head.stride_reg.{key}")
        if cfg.use_kps:
            hp[f"kps_pred_{key}"] = conv(sd, f"bbox_head.stride_kps.{key}")
    for i in range(len(cfg.strides)):
        hp[f"scale_{i}"] = np.asarray(
            sd[f"bbox_head.scales.{i}.scale"]).reshape(())

    params = {"backbone": bp, "neck": np_, "head": hp}
    stats = {"backbone": bs}
    if hs:
        stats["head"] = hs
    return params, stats, cfg


# -- ArcFace iresnet (torch-export naming, e.g. insightface ONNX/pt) ----------

def iresnet_config_from_state(sd: Mapping[str, np.ndarray]):
    """(layers, spatial) inferred from an iresnet state dict's names+shapes
    (r50 = (3,4,14,3)/7, r100 = (3,13,30,3)/7, tiny test packs vary)."""
    layers = []
    for li in range(1, 5):
        n = 0
        while f"layer{li}.{n}.conv1.weight" in sd:
            n += 1
        layers.append(n)
    c = sd["bn2.weight"].shape[0]
    spatial = int(round((sd["fc.weight"].shape[1] // c) ** 0.5))
    return tuple(layers), spatial


def iresnet_from_torch(sd: Mapping[str, np.ndarray],
                       layers=None, spatial: int = None):
    """ArcFace iresnet state dict (conv1/bn1/prelu/layer{i}.{j}.*/bn2/fc/
    features naming, as preserved by torch-exported insightface packs) ->
    (params, batch_stats) for models.arcface.IResNet.

    layers/spatial default to inference from the state dict itself
    (iresnet_config_from_state), so r50/r100/tiny packs all load without a
    variant table.

    The fc weight is permuted for NHWC flattening: torch flattens (C,H,W),
    our model flattens (H,W,C)."""
    inf_layers, inf_spatial = iresnet_config_from_state(sd)
    layers = inf_layers if layers is None else layers
    spatial = inf_spatial if spatial is None else spatial
    params, stats = {}, {}
    params["conv1"] = conv(sd, "conv1", bias=False)
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    params["prelu"] = {"alpha": sd["prelu.weight"].reshape(-1)}
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            p = f"layer{li + 1}.{bi}"
            name = f"layer{li + 1}_{bi}"
            blk_p, blk_s = {}, {}
            blk_p["bn1"], blk_s["bn1"] = _bn(sd, f"{p}.bn1")
            blk_p["conv1"] = conv(sd, f"{p}.conv1", bias=False)
            blk_p["bn2"], blk_s["bn2"] = _bn(sd, f"{p}.bn2")
            blk_p["prelu"] = {"alpha": sd[f"{p}.prelu.weight"].reshape(-1)}
            blk_p["conv2"] = conv(sd, f"{p}.conv2", bias=False)
            blk_p["bn3"], blk_s["bn3"] = _bn(sd, f"{p}.bn3")
            if f"{p}.downsample.0.weight" in sd:
                blk_p["downsample_conv"] = conv(sd, f"{p}.downsample.0",
                                                bias=False)
                blk_p["downsample_bn"], blk_s["downsample_bn"] = _bn(
                    sd, f"{p}.downsample.1")
            params[name], stats[name] = blk_p, blk_s
    params["bn2"], stats["bn2"] = _bn(sd, "bn2")
    # fc: (out, C*H*W) with torch CHW flatten -> NHWC HWC flatten
    w = sd["fc.weight"]
    out_dim = w.shape[0]
    c = w.shape[1] // (spatial * spatial)
    w = w.reshape(out_dim, c, spatial, spatial).transpose(2, 3, 1, 0)
    params["fc"] = {"kernel": np.ascontiguousarray(
        w.reshape(-1, out_dim)), "bias": sd["fc.bias"]}
    fs_p = {"scale": sd["features.weight"], "bias": sd["features.bias"]}
    fs_s = {"mean": sd["features.running_mean"],
            "var": sd["features.running_var"]}
    params["features"], stats["features"] = fs_p, fs_s
    return params, stats


# -- export back to the reference checkpoint layout ---------------------------

def _linear_out(tree, prefix: str, out, bias: bool = True):
    out[f"{prefix}.weight"] = np.ascontiguousarray(
        np.asarray(tree["kernel"]).T)
    if bias and "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _layernorm_out(tree, prefix: str, out):
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _perceiver_attention_out(tree, p: str, out):
    _layernorm_out(tree["norm1"], f"{p}.norm1", out)
    _layernorm_out(tree["norm2"], f"{p}.norm2", out)
    for name in ("to_q", "to_kv", "to_out"):
        _linear_out(tree[name], f"{p}.{name}", out, bias=False)


def _feedforward_out(tree, p: str, out):
    _layernorm_out(tree["norm"], f"{p}.0", out)
    _linear_out(tree["fc1"], f"{p}.1", out, bias=False)
    _linear_out(tree["fc2"], f"{p}.3", out, bias=False)


def _resampler_out(tree, p: str, out, depth: int):
    _linear_out(tree["proj_in"], _join(p, "proj_in"), out)
    _linear_out(tree["proj_out"], _join(p, "proj_out"), out)
    _layernorm_out(tree["norm_out"], _join(p, "norm_out"), out)
    for i in range(depth):
        _perceiver_attention_out(tree[f"layers_{i}_attn"],
                                 _join(p, f"layers.{i}.0"), out)
        _feedforward_out(tree[f"layers_{i}_ff"],
                         _join(p, f"layers.{i}.1"), out)


def export_proj_plus(tree, depth: int = 4) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _linear_out(tree["proj_0"], "proj.0", out)
    _linear_out(tree["proj_2"], "proj.2", out)
    _layernorm_out(tree["norm"], "norm", out)
    _resampler_out(tree["perceiver_resampler"], "perceiver_resampler", out,
                   depth)
    return out


def export_facial_encoder(tree, depth: int = 8) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    vp = tree["visual_projection"]
    out["visual_projection.latents"] = np.asarray(vp["latents"])
    _linear_out(vp["proj_in"], "visual_projection.proj_in", out)
    _linear_out(vp["proj_out"], "visual_projection.proj_out", out)
    _layernorm_out(vp["norm_out"], "visual_projection.norm_out", out)
    for i in range(depth):
        _perceiver_attention_out(vp[f"layers_{i}_attn"],
                                 f"visual_projection.layers.{i}.0", out)
        _feedforward_out(vp[f"layers_{i}_ff"],
                         f"visual_projection.layers.{i}.1", out)
    fm = tree["fuse_module"]
    for m in ("mlp1", "mlp2"):
        _layernorm_out(fm[m]["layernorm"], f"fuse_module.{m}.layernorm", out)
        _linear_out(fm[m]["fc1"], f"fuse_module.{m}.fc1", out)
        _linear_out(fm[m]["fc2"], f"fuse_module.{m}.fc2", out)
    _layernorm_out(fm["layer_norm"], "fuse_module.layer_norm", out)
    return out


def export_consistentid_checkpoint(params: Dict, unet_cfg,
                                   proj_depth: int = 4,
                                   facial_depth: int = 8) -> Dict:
    """Inverse of load_consistentid_checkpoint: produce the reference's
    {image_proj, adapter_modules, FacialEncoder} .bin layout from a params
    bundle, so adapters trained here load in the reference ecosystem
    (the distributable artifact of evaluation/convert_weights.py). The
    SDXL file names the projection `image_proj_model` (reference
    pipline_StableDiffusionXL_ConsistentID.py:104-176)."""
    adapters: Dict[str, np.ndarray] = {}
    flat_unet = flatten_tree(params["unet"])
    for idx, (path, is_cross) in enumerate(unet_attention_paths(unet_cfg)):
        def attn_tree(name):
            sub = {}
            for k, v in flat_unet.items():
                if k[:len(path)] == path and k[len(path)] == name:
                    sub[k[len(path) + 1:]] = v
            return unflatten_tree(sub)

        for lora in ("to_q_lora", "to_k_lora", "to_v_lora", "to_out_lora"):
            t = attn_tree(lora)
            _linear_out(t["down"], f"{idx}.{lora}.down", adapters, bias=False)
            _linear_out(t["up"], f"{idx}.{lora}.up", adapters, bias=False)
        if is_cross:
            _linear_out(attn_tree("to_k_ip"), f"{idx}.to_k_ip", adapters,
                        bias=False)
            _linear_out(attn_tree("to_v_ip"), f"{idx}.to_v_ip", adapters,
                        bias=False)

    return {
        "image_proj_model" if unet_cfg.is_sdxl else "image_proj":
            export_proj_plus(params["proj"], proj_depth),
        "FacialEncoder": export_facial_encoder(params["facial_encoder"],
                                               facial_depth),
        "adapter_modules": adapters,
    }
