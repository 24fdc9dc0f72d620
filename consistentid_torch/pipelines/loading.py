"""Checkpoint assembly: ready-to-run pipelines from local checkpoint files,
the port's counterpart of the JAX package's pipelines/loading.py (the
reference's load_ConsistentID_model,
pipline_StableDiffusion_ConsistentID.py:36-150), with no download.

Expected inputs (all local paths):
  base_dir/            diffusers-format SD1.5 or SDXL dump with subfolders
    unet/diffusion_pytorch_model.safetensors
    vae/diffusion_pytorch_model.safetensors
    text_encoder/model.safetensors
    text_encoder_2/model.safetensors   (SDXL: OpenCLIP bigG)
    tokenizer/vocab.json, merges.txt   (else a warned word-hash fallback)
    tokenizer_2/                       (SDXL; its declared pad token read)
    safety_checker/                    (SD1.5, optional; config.json read)
  image_encoder.safetensors  CLIP ViT-H vision tower
  ConsistentID-v1.bin        adapter checkpoint (torch pickle or
                             safetensors with the reference's
                             {FacialEncoder, image_proj, adapter_modules};
                             SDXL's names image_proj_model)
  face_parsing.pth           BiSeNet weights
  arcface (.onnx or .pt)     iresnet recognition backbone
  scrfd (.onnx or .pt)       SCRFD detector (optional)

Each file is read to numpy (io/safetensors_reader.py, io/onnx_reader.py:
no safetensors, onnx or transformers package), mapped onto the JAX
package's tree layout by io/convert*.py and carried into the port's modules
by io/from_jax.py, the one mapping the parity tests hold; the tensors are
cast to the bundle's dtype once, on its device.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..conditioning import CLIPBPETokenizer, SimpleTokenizer
from ..core.config import (AdapterConfig, CLIPVisionConfig, PipelineConfig,
                           VAEConfig, sd15_unet_config, sdxl_unet_config)
from ..core.dtypes import resolve_device, resolve_dtype
from ..io import convert
from ..io.convert_backbones import (clip_text_from_hf, clip_vision_from_hf,
                                    safety_checker_from_hf,
                                    unet_from_diffusers, vae_from_diffusers)
from ..io.from_jax import params_from_jax, state_from_jax
from ..io.safetensors_reader import read_checkpoint
from ..models.arcface import make_face_embedder
from ..models.bisenet import make_face_parser
from ..models.safety_checker import SAFETY_VISION_CONFIG, make_safety_checker
from ..models.scrfd import make_face_detector
from ..training.train_step import warm_start_ip_projections
from .consistentid_sd15 import (ConsistentIDPipeline, SD15Bundle,
                               check_quant)
from .consistentid_sdxl import (ConsistentIDXLPipeline, SDXLBundle,
                                sdxl_adapter_config)
from .inpaint import ConsistentIDControlNetInpaintPipeline


def _read_maybe_onnx(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".onnx"):
        from ..io.onnx_reader import read_onnx_initializers
        return read_onnx_initializers(path)
    return read_checkpoint(path)


def _default_tokenizer(base_dir: str, subfolder: str = "tokenizer"):
    """The CLIP BPE tokenizer from the dump's own vocab files; the
    word-hash SimpleTokenizer, with a warning, when the dump has none."""
    tok_dir = os.path.join(base_dir, subfolder)
    if os.path.isfile(os.path.join(tok_dir, "vocab.json")):
        return CLIPBPETokenizer.from_pretrained(tok_dir)
    warnings.warn(
        f"no {subfolder}/vocab.json under {base_dir}; falling back to the "
        "hash-based SimpleTokenizer (token ids will NOT match reference "
        "checkpoints)")
    return SimpleTokenizer()


def _safety_checker_vision_config(sc_dir: str) -> CLIPVisionConfig:
    """Vision tower of a diffusers safety_checker/ dump: its config.json's
    vision_config when present, else the stock SD1.5 checker's."""
    cfg = SAFETY_VISION_CONFIG
    cfg_path = os.path.join(sc_dir, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            vc = json.load(f).get("vision_config", {})
        cfg = CLIPVisionConfig(
            image_size=vc.get("image_size", cfg.image_size),
            patch_size=vc.get("patch_size", cfg.patch_size),
            hidden_size=vc.get("hidden_size", cfg.hidden_size),
            intermediate_size=vc.get("intermediate_size",
                                     cfg.intermediate_size),
            num_layers=vc.get("num_hidden_layers", cfg.num_layers),
            num_heads=vc.get("num_attention_heads", cfg.num_heads),
            hidden_act=vc.get("hidden_act", cfg.hidden_act))
    return cfg


def _variables(params: Mapping, stats: Mapping, **kw) -> Dict:
    return state_from_jax({"params": params, "batch_stats": stats}, **kw)


def load_face_stack(bisenet_path: Optional[str] = None,
                    arcface_path: Optional[str] = None,
                    scrfd_path: Optional[str] = None, det_size: int = 640,
                    allow_center_crop: bool = False,
                    device: Union[str, torch.device] = "cuda"):
    """(face_parser, face_embedder) hooks from local checkpoint files: the
    reference's BiSeNet and FaceAnalysis (SCRFD detect -> align -> ArcFace)
    stack (pipline_StableDiffusion_ConsistentID.py:63-71,217-226), the
    models in fp32 on `device`. det_size: 640 for SD1.5, 512 for SDXL."""
    face_parser = face_embedder = None
    if bisenet_path:
        params, stats = convert.bisenet_from_torch(
            read_checkpoint(bisenet_path))
        face_parser = make_face_parser(_variables(params, stats),
                                       device=device)
    if arcface_path:
        detector = None
        if scrfd_path:
            params, stats, cfg = convert.scrfd_from_torch(
                _read_maybe_onnx(scrfd_path))
            detector = make_face_detector(_variables(params, stats), cfg=cfg,
                                          input_size=det_size, device=device)
        params, stats = convert.iresnet_from_torch(
            _read_maybe_onnx(arcface_path))
        channels = int(np.asarray(params["bn2"]["scale"]).shape[0])
        face_embedder = make_face_embedder(
            _variables(params, stats, flatten_nhwc={"fc": channels}),
            detector=detector,
            allow_center_crop=allow_center_crop or detector is None,
            device=device)
    return face_parser, face_embedder


def load_models(bundle: SD15Bundle, base_dir: str,
                consistentid_path: Optional[str] = None,
                image_encoder_path: Optional[str] = None,
                with_unet: bool = True) -> None:
    """The dump's UNet (IP projections warm-started from the base ones;
    skipped without `with_unet`), VAE and text encoders, the image encoder
    and the adapter checkpoint, where given, into the bundle. Leaves no file
    provides keep the bundle's initialisation."""
    if with_unet:
        _load_tree(bundle.unet, unet_from_diffusers(
            read_checkpoint(os.path.join(base_dir, "unet")),
            bundle.unet_config))
        warm_start_ip_projections(bundle.unet)
    _load_tree(bundle.vae, vae_from_diffusers(
        read_checkpoint(os.path.join(base_dir, "vae")), bundle.vae_config))
    towers = [("text_encoder", bundle.text_config)]
    if bundle.unet_config.is_sdxl:
        towers.append(("text_encoder_2", bundle.text_config_2))
    for sub, cfg in towers:
        _load_tree(getattr(bundle, sub), clip_text_from_hf(
            read_checkpoint(os.path.join(base_dir, sub)), cfg))
    if image_encoder_path:
        _load_tree(bundle.image_encoder, clip_vision_from_hf(
            read_checkpoint(image_encoder_path), bundle.vision_config))
    if consistentid_path:
        _load_tree(bundle, convert.consistentid_checkpoint_tree(
            read_checkpoint(consistentid_path), bundle.unet_config))


@torch.no_grad()
def _load_tree(module: nn.Module, tree: Mapping) -> None:
    """Carry a tree into `module`'s parameters: each tensor moved to the
    module's device, then cast to its parameter's dtype there; every leaf
    must name a parameter of the module's shape."""
    device = next(module.parameters()).device
    state = {k: v.to(device) for k, v in params_from_jax(tree).items()}
    result = module.load_state_dict(state, strict=False)
    if result.unexpected_keys:
        raise KeyError(f"checkpoint leaves the module does not have: "
                       f"{result.unexpected_keys[:5]}")


def load_sd15_consistentid(
    base_dir: str,
    consistentid_path: Optional[str] = None,
    image_encoder_path: Optional[str] = None,
    bisenet_path: Optional[str] = None,
    arcface_path: Optional[str] = None,
    scrfd_path: Optional[str] = None,
    tokenizer=None,
    dtype: Union[str, torch.dtype] = torch.bfloat16,
    lora_rank: int = 128,
    num_tokens: int = 4,
    pipeline_config: Optional[PipelineConfig] = None,
    with_safety_checker: bool = True,
    bundle: Optional[SD15Bundle] = None,
    device: Union[str, torch.device] = "cuda",
    pipeline_cls: Optional[type] = None,
    quant: str = "none",
) -> ConsistentIDPipeline:
    """The SD1.5 ConsistentID pipeline from local checkpoints, on `device`
    (the card unless the caller asks for the CPU).

    bundle: the models to fill (default: full-size SD1.5 in `dtype` on
    `device`), e.g. `testing.tiny_bundle(device="cpu")` to drive the whole
    load path at toy scale; `dtype` and `device` are then the bundle's.
    Leaves no file provides keep the bundle's initialisation, as the JAX
    loader keeps its init tree's.
    pipeline_cls: the ConsistentIDPipeline subclass to assemble (img2img
    and inpainting read the same files, as the reference's Base mixin
    composes them). The ControlNet-inpaint pipeline is refused, as the JAX
    loader refuses it: no file here holds a ControlNet.
    quant: "int8" serves the W8A8 UNet (the checkpoints stay float; the
    folded weights are quantized per generate call); a given bundle keeps
    its own mode unless quant names another. "int8_static" needs
    calibrated scales, so it is refused here as in JAX: load "none", then
    `pipe.calibrate_int8(...)` or `pipe.with_quant("int8_static",
    act_scales=io.quant_scales.load_act_scales(path))`."""
    if pipeline_cls is not None and issubclass(
            pipeline_cls, ConsistentIDControlNetInpaintPipeline):
        raise ValueError(
            "load_sd15_consistentid does not load a ControlNet; construct "
            "ConsistentIDControlNetInpaintPipeline directly with one "
            "(pipelines/inpaint.py)")
    check_quant(quant, None)
    if bundle is None:
        bundle = SD15Bundle(
            unet_config=sd15_unet_config(lora_rank=lora_rank,
                                         ip_num_tokens=num_tokens),
            adapter_config=AdapterConfig(num_id_tokens=num_tokens),
            dtype=resolve_dtype(dtype), device=resolve_device(device))
    if quant != "none":
        bundle = bundle.quantized(quant)
    device = bundle.device
    load_models(bundle, base_dir, consistentid_path, image_encoder_path)

    face_parser, face_embedder = load_face_stack(
        bisenet_path, arcface_path, scrfd_path, det_size=640, device=device)

    # the reference runs the CLIP safety checker on every output
    # (:586-594): loaded when the dump ships one, unless opted out
    safety_checker = None
    sc_dir = os.path.join(base_dir, "safety_checker")
    if with_safety_checker and os.path.isdir(sc_dir):
        sc_cfg = _safety_checker_vision_config(sc_dir)
        safety_checker = make_safety_checker(
            params_from_jax(safety_checker_from_hf(read_checkpoint(sc_dir),
                                                   sc_cfg)),
            vision_config=sc_cfg, device=device)

    if tokenizer is None:
        tokenizer = _default_tokenizer(base_dir)
    return (pipeline_cls or ConsistentIDPipeline)(
        bundle, tokenizer, pipeline_config=pipeline_config,
        face_parser=face_parser, face_embedder=face_embedder,
        safety_checker=safety_checker)


# the reference's method name
load_ConsistentID_model = load_sd15_consistentid


def load_sdxl_consistentid(
    base_dir: str,
    consistentid_path: Optional[str] = None,
    image_encoder_path: Optional[str] = None,
    bisenet_path: Optional[str] = None,
    arcface_path: Optional[str] = None,
    scrfd_path: Optional[str] = None,
    tokenizer=None,
    tokenizer_2=None,
    dtype: Union[str, torch.dtype] = torch.bfloat16,
    lora_rank: int = 128,
    num_tokens: int = 4,
    pipeline_config: Optional[PipelineConfig] = None,
    bundle: Optional[SDXLBundle] = None,
    device: Union[str, torch.device] = "cuda",
    quant: str = "none",
) -> ConsistentIDXLPipeline:
    """The SDXL ConsistentID pipeline from local checkpoints, on `device`
    (the JAX package's load_sdxl_consistentid; reference
    pipline_StableDiffusionXL_ConsistentID.py:104-176): the dump's
    text_encoder_2 and tokenizer_2 besides SD1.5's files, the VAE decoding
    in fp32 (force_upcast, scaling factor 0.13025), the face stack's
    detector at 512, no safety checker. bundle: as for
    `load_sd15_consistentid` (e.g. `testing.tiny_sdxl_bundle`); quant: as
    there."""
    check_quant(quant, None)
    if bundle is None:
        bundle = SDXLBundle(
            unet_config=sdxl_unet_config(lora_rank=lora_rank,
                                         ip_num_tokens=num_tokens),
            adapter_config=sdxl_adapter_config(num_id_tokens=num_tokens),
            vae_config=VAEConfig(scaling_factor=0.13025, force_upcast=True),
            dtype=resolve_dtype(dtype), device=resolve_device(device))
    if quant != "none":
        bundle = bundle.quantized(quant)
    load_models(bundle, base_dir, consistentid_path, image_encoder_path)
    face_parser, face_embedder = load_face_stack(
        bisenet_path, arcface_path, scrfd_path, det_size=512,
        device=bundle.device)
    if tokenizer is None:
        tokenizer = _default_tokenizer(base_dir)
    if tokenizer_2 is None:
        tokenizer_2 = _default_tokenizer(base_dir, subfolder="tokenizer_2")
    return ConsistentIDXLPipeline(
        bundle, tokenizer, tokenizer_2=tokenizer_2,
        pipeline_config=pipeline_config, face_parser=face_parser,
        face_embedder=face_embedder)
