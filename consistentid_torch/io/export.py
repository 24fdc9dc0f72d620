"""Write a port bundle and perception models as a reference-layout
checkpoint set: the files `pipelines.loading.load_sd15_consistentid` (or,
for an SDXL bundle, `load_sdxl_consistentid`) and `load_face_stack` read
(diffusers SD1.5 or SDXL dump, image encoder, the ConsistentID .bin,
BiSeNet .pth, iresnet .pt, SCRFD .onnx, the safety checker and the
tokenizer vocabs). The trees come from
`io.from_jax.tree_from_module` and go through the exporters of
io/export_backbones.py and io/convert.py, the inverse of the maps the
loader reads with, so loading the set gives the modules' weights back
(after the cast to `dtype`, fp16 as diffusers dumps ship)."""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .convert import export_consistentid_checkpoint
from .export_backbones import (bisenet_to_torch, clip_text_to_hf,
                               clip_vision_to_hf, iresnet_to_torch,
                               safety_checker_to_hf, scrfd_to_torch,
                               unet_to_diffusers, vae_to_diffusers)
from .from_jax import tree_from_module
from .onnx_reader import write_onnx_initializers
from .safetensors_reader import write_safetensors


def _cast(sd: Mapping[str, np.ndarray], dtype) -> Dict[str, np.ndarray]:
    return {k: np.ascontiguousarray(np.asarray(v).astype(dtype))
            for k, v in sd.items()}


def _depth(tree: Mapping) -> int:
    return sum(1 for k in tree if k.endswith("_attn"))


def write_reference_checkpoints(
        outdir: str, bundle: nn.Module,
        parser: Optional[nn.Module] = None,
        embedder: Optional[nn.Module] = None,
        detector: Optional[nn.Module] = None,
        safety_checker: Optional[nn.Module] = None,
        vocab: Optional[Mapping[str, int]] = None,
        dtype=np.float16,
        image_encoder: bool = True,
        consistentid: bool = True) -> Tuple[Dict[str, str], int]:
    """Write the set under `outdir`; returns ({name: path} in the
    loaders' argument names, bytes written). bundle: an SD15Bundle (dump in
    sd15/, ConsistentID-v1.bin) or an SDXLBundle (dump in sdxl/ with
    text_encoder_2/ and tokenizer_2/, whose pad token is "!", and
    ConsistentID_SDXL-v1.bin under the SDXL prefixes); the perception
    models are the port's BiSeNet, IResNet, SCRFD and SafetyChecker
    modules; vocab: a CLIP BPE vocab (no merges); image_encoder=False
    leaves the image encoder out (a set that shares another's), and
    consistentid=False the adapter checkpoint (a base dump alone)."""
    sdxl = bundle.unet_config.is_sdxl
    # the trees in the written dtype, cast on the modules' devices (the
    # same values as casting the fp32 trees: round to nearest even)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype

    def tree(module, **kw):
        return tree_from_module(module, dtype=tdtype, **kw)

    name = "sdxl" if sdxl else "sd15"
    base = os.path.join(outdir, name)
    paths = {"base": base}
    written = 0

    def save_st(rel: str, sd: Mapping[str, np.ndarray]) -> str:
        nonlocal written
        path = os.path.join(outdir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        written += write_safetensors(path, _cast(sd, dtype))
        return path

    def save_torch(rel: str, sd: Mapping) -> str:
        nonlocal written

        def tensors(d):
            return {k: tensors(v) if isinstance(v, Mapping)
                    else torch.from_numpy(np.ascontiguousarray(
                        np.asarray(v).astype(dtype)))
                    for k, v in d.items()}
        path = os.path.join(outdir, rel)
        torch.save(tensors(sd), path)
        written += os.path.getsize(path)
        return path

    unet, _ = tree(bundle.unet)
    save_st(f"{name}/unet/diffusion_pytorch_model.safetensors",
            unet_to_diffusers(unet, bundle.unet_config))
    vae, _ = tree(bundle.vae)
    save_st(f"{name}/vae/diffusion_pytorch_model.safetensors",
            vae_to_diffusers(vae, bundle.vae_config))
    del vae
    save_st(f"{name}/text_encoder/model.safetensors", clip_text_to_hf(
        tree(bundle.text_encoder)[0], bundle.text_config))
    if sdxl:
        save_st(f"{name}/text_encoder_2/model.safetensors", clip_text_to_hf(
            tree(bundle.text_encoder_2)[0],
            bundle.text_config_2))
    if image_encoder:
        paths["image_encoder_path"] = save_st(
            "image_encoder.safetensors", clip_vision_to_hf(
                tree(bundle.image_encoder)[0],
                bundle.vision_config))
    if consistentid:
        adapters = {"unet": unet, "proj": tree(bundle.proj)[0],
                    "facial_encoder": tree(
                        bundle.facial_encoder)[0]}
        paths["consistentid_path"] = save_torch(
            "ConsistentID_SDXL-v1.bin" if sdxl else "ConsistentID-v1.bin",
            export_consistentid_checkpoint(
                adapters, bundle.unet_config,
                proj_depth=_depth(adapters["proj"]["perceiver_resampler"]),
                facial_depth=_depth(
                    adapters["facial_encoder"]["visual_projection"])))
        del adapters
    del unet

    if parser is not None:
        paths["bisenet_path"] = save_torch(
            "face_parsing.pth", bisenet_to_torch(*tree(parser)))
    if embedder is not None:
        from ..models.arcface import iresnet_arch_from_params
        layers, _, input_size = iresnet_arch_from_params(
            embedder.state_dict())
        channels = embedder.bn2.num_features
        params, stats = tree(embedder,
                                         flatten_nhwc={"fc": channels})
        paths["arcface_path"] = save_torch(
            "arcface.pt", iresnet_to_torch(params, stats, layers=layers,
                                           spatial=input_size // 16))
    if detector is not None:
        path = os.path.join(outdir, "scrfd.onnx")
        write_onnx_initializers(path, _cast(scrfd_to_torch(
            *tree(detector), detector.cfg), dtype))
        written += os.path.getsize(path)
        paths["scrfd_path"] = path
    if safety_checker is not None:
        vc = safety_checker.vision_config
        save_st(f"{name}/safety_checker/model.safetensors",
                safety_checker_to_hf(tree(safety_checker)[0],
                                     vc))
        with open(os.path.join(base, "safety_checker", "config.json"),
                  "w") as f:
            json.dump({"vision_config": {
                "image_size": vc.image_size, "patch_size": vc.patch_size,
                "hidden_size": vc.hidden_size,
                "intermediate_size": vc.intermediate_size,
                "num_hidden_layers": vc.num_layers,
                "num_attention_heads": vc.num_heads,
                "hidden_act": vc.hidden_act}}, f)
    if vocab is not None:
        tokenizers = [("tokenizer", None)]
        if sdxl:
            tokenizers.append(("tokenizer_2", {"pad_token": "!"}))
        for sub, tok_cfg in tokenizers:
            tok_dir = os.path.join(base, sub)
            os.makedirs(tok_dir, exist_ok=True)
            with open(os.path.join(tok_dir, "vocab.json"), "w") as f:
                json.dump(dict(vocab), f)
            with open(os.path.join(tok_dir, "merges.txt"), "w") as f:
                f.write("#version: 0.2\n")
            if tok_cfg:
                with open(os.path.join(tok_dir, "tokenizer_config.json"),
                          "w") as f:
                    json.dump(tok_cfg, f)
    return paths, written
