"""Build the system under test and the reference from a configuration
file and the run's seed.

The system under test is `consistentid_torch` at the configuration's
widths and serving dtype; the benchmark makes every weight (harness/
weights.py) and loads them into it, so the reference, built from the same
seed, holds the same values. Perception runs in fp32 on both sides.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..reference import config as rcfg
from ..reference.arcface import IResNet
from ..reference.bisenet import BiSeNet
from ..reference.pipeline import Models
from ..reference.safety_checker import SafetyChecker
from ..reference.scrfd import SCRFD, SCRFD_VARIANTS
from .inputs import mix, tokenizer_args
from .weights import diffusion_weights, perception_weights

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
PERCEPTION = ("detector", "embedder", "parser", "safety_checker")


def _tuples(d: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def config_kwargs(config: Dict, module) -> Dict:
    """The Models / bundle keyword arguments, as dataclasses of `module`
    (the reference's config module or the system's)."""
    out = dict(unet=module.UNetConfig(**_tuples(config["unet"])),
               adapter=module.AdapterConfig(**_tuples(config["adapter"])),
               vae=module.VAEConfig(**_tuples(config["vae"])),
               text=module.CLIPTextConfig(**_tuples(config["text"])),
               vision=module.CLIPVisionConfig(**_tuples(config["vision"])))
    if "text_2" in config:
        out["text_2"] = module.CLIPTextConfig(**_tuples(config["text_2"]))
    return out


def is_sdxl(config: Dict) -> bool:
    return "text_2" in config


def raw_diffusion(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        models = Models(**config_kwargs(config, rcfg))
    return diffusion_weights(models, mix(seed, 1), device,
                             DTYPES[config["dtype"]])


def raw_perception(config: Dict, seed: int, device) -> Dict[str, Dict]:
    p = config["perception"]
    builders = {
        "detector": lambda: SCRFD(SCRFD_VARIANTS[p["detector"]]),
        "embedder": IResNet,
        "parser": lambda: BiSeNet(p["parser_classes"]),
        "safety_checker": SafetyChecker,
    }
    out = {}
    for i, name in enumerate(PERCEPTION):
        if name == "safety_checker" and not p.get("safety_checker"):
            continue
        with torch.device("meta"):
            model = builders[name]()
        out[name] = perception_weights(model, mix(seed, 2, i), device)
    return out


def hooks(config: Dict, states: Dict, device, side) -> Dict:
    """face_parser, face_embedder and (if configured) safety_checker of
    `side`: a module exposing make_face_parser, make_face_detector,
    make_face_embedder, make_safety_checker and SCRFD_VARIANTS."""
    p = config["perception"]
    detector = side.make_face_detector(
        states["detector"], side.SCRFD_VARIANTS[p["detector"]],
        input_size=p["detector_input"], device=device)
    out = dict(
        face_parser=side.make_face_parser(states["parser"],
                                          size=p["parser_size"],
                                          device=device),
        face_embedder=side.make_face_embedder(states["embedder"],
                                              detector=detector,
                                              device=device))
    if "safety_checker" in states:
        out["safety_checker"] = side.make_safety_checker(
            states["safety_checker"], device=device)
    return out


class _ProgramHooks:
    """The system's perception makers under one namespace."""

    def __init__(self):
        from consistentid_torch.models import arcface, bisenet, scrfd
        from consistentid_torch.models import safety_checker
        self.make_face_detector = scrfd.make_face_detector
        self.SCRFD_VARIANTS = scrfd.SCRFD_VARIANTS
        self.make_face_parser = bisenet.make_face_parser
        self.make_face_embedder = arcface.make_face_embedder
        self.make_safety_checker = safety_checker.make_safety_checker


class _ReferenceHooks:
    def __init__(self):
        from ..reference import arcface, bisenet, safety_checker, scrfd
        self.make_face_detector = scrfd.make_face_detector
        self.SCRFD_VARIANTS = scrfd.SCRFD_VARIANTS
        self.make_face_parser = bisenet.make_face_parser
        self.make_face_embedder = arcface.make_face_embedder
        self.make_safety_checker = safety_checker.make_safety_checker


OPTIONS = ("quant", "cache_interval")


def build_program(config: Dict, request: Dict, seed: int, device="cuda",
                  options: Optional[Dict] = None):
    """The system's pipeline (SD1.5 or SDXL) with its perception hooks,
    every weight from `seed`. `request`: height, width, steps,
    guidance_scale, start_merge_step of the traffic mix; `options` the
    pipeline's options (OPTIONS) of the configuration or the mix:
    `cache_interval` is set here, `quant` by `with_options`."""
    options = options or {}
    unknown = set(options) - set(OPTIONS)
    if unknown:
        raise ValueError(f"unknown pipeline options {sorted(unknown)}; "
                         f"known: {OPTIONS}")
    from consistentid_torch import core
    from consistentid_torch.conditioning import CLIPBPETokenizer
    from consistentid_torch.pipelines import (ConsistentIDPipeline,
                                              ConsistentIDXLPipeline,
                                              SD15Bundle, SDXLBundle)

    # the configuration's fp32 stages (perception, SDXL's decode) in fp32,
    # not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = config_kwargs(config, core.config)
    sdxl = is_sdxl(config)
    dtype = DTYPES[config["dtype"]]
    common = dict(adapter_config=kw["adapter"], vae_config=kw["vae"],
                  text_config=kw["text"], vision_config=kw["vision"],
                  dtype=dtype, device=device)
    if sdxl:
        bundle = SDXLBundle(kw["unet"], text_config_2=kw["text_2"], **common)
    else:
        bundle = SD15Bundle(kw["unet"], **common)
    raw = raw_diffusion(config, seed, device)
    bundle.load_state_dict(raw)
    del raw
    states = raw_perception(config, seed, device)
    h = hooks(config, states, device, _ProgramHooks())
    toks = [CLIPBPETokenizer(v, m, **k) for v, m, k in tokenizer_args(sdxl)]
    pcfg = core.PipelineConfig(
        height=request["height"], width=request["width"],
        num_inference_steps=request["steps"],
        guidance_scale=request["guidance_scale"],
        start_merge_step=request["start_merge_step"], scheduler="ddim",
        cache_interval=int(options.get("cache_interval", 1)))
    if sdxl:
        return ConsistentIDXLPipeline(
            bundle, toks[0], tokenizer_2=toks[1], pipeline_config=pcfg,
            face_parser=h["face_parser"], face_embedder=h["face_embedder"])
    return ConsistentIDPipeline(bundle, toks[0], pipeline_config=pcfg, **h)


def with_options(pipe, options: Dict, reqs):
    """`pipe` serving its UNet at `options["quant"]` ("none", "int8",
    "int8_static"; the last calibrated on the first warm-up request of
    `reqs`, as `apps.serve --quant int8_static` calibrates on one photo)."""
    quant = options.get("quant", "none")
    if quant == "int8_static":
        prompt, face, _ = reqs.get(-1, 0)
        return pipe.calibrate_int8(prompt, reqs.faces[face])
    return pipe if quant == "none" else pipe.with_quant(quant)


def build_reference(config: Dict, request: Dict, seed: int, device="cuda"):
    """The fp32 reference (reference/pipeline.py), from the same seed."""
    from ..reference.clip_tokenizer import CLIPBPETokenizer
    from ..reference.pipeline import (Reference, RequestSpec, build_models,
                                      tf32_off)

    tf32_off()
    sdxl = is_sdxl(config)
    models = build_models(config_kwargs(config, rcfg),
                          raw_diffusion(config, seed, device), device)
    states = raw_perception(config, seed, device)
    h = hooks(config, states, device, _ReferenceHooks())
    toks = [CLIPBPETokenizer(v, m, **k) for v, m, k in tokenizer_args(sdxl)]
    spec = RequestSpec(request["height"], request["width"], request["steps"],
                       request["guidance_scale"], request["start_merge_step"])
    return Reference(models, toks[0], spec, h["face_parser"],
                     h["face_embedder"], tokenizer_2=toks[-1],
                     safety_checker=h.get("safety_checker"))
