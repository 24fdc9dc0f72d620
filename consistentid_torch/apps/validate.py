"""Checkpoint validation CLI (the JAX package's apps/validate.py): prove
that weight files load correctly, on the card unless `--device cpu` is
given.

One command runs every converter with per-layer sanity checks, builds
every pipeline, generates one image each, and scores FaceSim / CLIP-T: the
reference's load_ConsistentID_model
(pipline_StableDiffusion_ConsistentID.py:36-150) plus the quality metrics.

Real weights:
    python -m consistentid_torch.apps.validate \
        --base /ckpt/sd15 --sdxl-base /ckpt/sdxl \
        --consistentid ConsistentID-v1.bin --image-encoder vit_h.safetensors \
        --bisenet face_parsing.pth --arcface w600k_r50.onnx \
        --scrfd det_10g.onnx --face face.png --out report.json

Self-test without weights (writes a tiny reference-layout checkpoint set
with the port's exporters, then validates it end to end):
    python -m consistentid_torch.apps.validate --synthesize /tmp/synth \
        --device cpu

Checks per file: every converted leaf finite, no all-zero kernels, and,
through a recording wrapper, which source keys the converter never
consumed (unconsumed keys are layout drift, the classic silent-corruption
failure). A stage that fails, a metric that raises or a non-finite or
blank image makes the report's "ok" false and the exit code 1. The report
also holds the seconds of the converter stage and of the pipeline stages.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np


# ---------------------------------------------------------------- reporting

class RecordingSD(dict):
    """Wraps a raw state dict; records which keys a converter consumed."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)


def layer_sanity(tree) -> Dict:
    """Flattened-leaf report of a converter's nested-dict tree: parameter
    count, non-finite leaves, all-zero kernels."""
    from ..io.convert import flatten_tree

    flat = flatten_tree(tree)
    n_params = 0
    nonfinite, zero_kernels = [], []
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        n_params += arr.size
        name = "/".join(map(str, path))
        # numpy's own dtypes checked as they are: a float32 copy of a
        # full-size fp16 set costs seconds per file
        if not np.isfinite(arr if arr.dtype.kind in "fiub"
                           else arr.astype(np.float32)).all():
            nonfinite.append(name)
        # LoRA up-projections are zero-init by design (diffusers
        # LoRALinearLayer semantics): never flag them
        lora_up = len(path) >= 2 and path[-2] == "up" and \
            any("_lora" in str(part) for part in path)
        if path[-1] == "kernel" and arr.ndim >= 2 and not lora_up and \
                not arr.any():
            zero_kernels.append(name)
    return {"leaves": len(flat), "params": int(n_params),
            "nonfinite": nonfinite, "zero_kernels": zero_kernels}


def validate_file(path: str, convert_fn, ignore_unconsumed=()) -> Dict:
    """Read a checkpoint file, run its converter under recording,
    sanity-check the converted tree. Returns the report entry; raises on a
    converter error."""
    from ..io.safetensors_reader import read_checkpoint

    raw = read_checkpoint(path)
    rec = RecordingSD(raw)
    converted = convert_fn(rec)
    tree = converted[0] if isinstance(converted, tuple) else converted
    entry = {"path": path, "source_keys": len(raw)}
    unconsumed = sorted(
        k for k in raw if k not in rec.consumed
        and not any(m in k for m in ignore_unconsumed))
    entry["unconsumed_source_keys"] = unconsumed
    entry.update(layer_sanity(tree))
    if isinstance(converted, tuple) and len(converted) > 1 and \
            isinstance(converted[1], dict):
        stats_report = layer_sanity(converted[1])
        entry["nonfinite"] += stats_report["nonfinite"]
        entry["params"] += stats_report["params"]
    entry["ok"] = not entry["nonfinite"] and not entry["zero_kernels"] \
        and not unconsumed
    return entry


# ---------------------------------------------------------------- synthesis

def synthesize(outdir: str) -> Dict[str, str]:
    """Write a complete tiny reference-layout checkpoint set (seeded random
    weights, fp32) so the whole validation runs with no real files: the
    JAX package's file list, written by the port's exporters from the
    tiny SD1.5 and SDXL bundles and tiny perception models. Returns
    {name: path} in this CLI's argument names."""
    import torch

    from ..io.export import write_reference_checkpoints
    from ..io.export_backbones import scrfd_to_torch
    from ..io.from_jax import tree_from_module
    from ..io.onnx_reader import write_onnx_initializers
    from ..io.safetensors_reader import read_checkpoint, write_safetensors
    from ..models.arcface import IResNet
    from ..models.bisenet import BiSeNet
    from ..models.safety_checker import SafetyChecker
    from ..models.scrfd import SCRFD, SCRFD_VARIANTS
    from ..testing import (randomize_perception_module,
                           synthetic_clip_tokenizer, tiny_bundle,
                           tiny_sdxl_bundle)

    os.makedirs(outdir, exist_ok=True)
    gen = torch.Generator().manual_seed(0)

    def seeded(module):
        randomize_perception_module(module, gen)
        return module

    bundle = tiny_bundle(device="cpu", seed=7)
    a = bundle.adapter_config
    detector = seeded(SCRFD(SCRFD_VARIANTS["tiny"]))
    checker = seeded(SafetyChecker(vision_config=bundle.vision_config,
                                   projection_dim=16, num_concepts=3,
                                   num_special=2))
    with torch.no_grad():   # thresholds at 1, the JAX module's init: the
        # tiny checker flags nothing, so the generated images stay
        checker.concept_embeds_weights.fill_(1.0)
        checker.special_care_embeds_weights.fill_(1.0)
    vocab = synthetic_clip_tokenizer().encoder
    sd15, _ = write_reference_checkpoints(
        outdir, bundle, parser=seeded(BiSeNet(n_classes=19)),
        embedder=seeded(IResNet(layers=(1, 1, 1, 1),
                                embedding_dim=a.id_embeddings_dim,
                                input_size=32)),
        safety_checker=checker, vocab=vocab, dtype=np.float32)
    sdxl, _ = write_reference_checkpoints(
        outdir, tiny_sdxl_bundle(device="cpu", seed=8), vocab=vocab,
        dtype=np.float32, image_encoder=False, consistentid=False)
    paths = {"base": sd15["base"], "image_encoder": sd15["image_encoder_path"],
             "consistentid": sd15["consistentid_path"],
             "sdxl_base": sdxl["base"], "bisenet": sd15["bisenet_path"],
             "arcface": sd15["arcface_path"]}

    # SCRFD as a torch file, and the ArcFace tensors again as an ONNX
    # initializer pack (the insightface load path), as the JAX set has them
    paths["scrfd"] = os.path.join(outdir, "scrfd.pt")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
                scrfd_to_torch(*tree_from_module(detector),
                               detector.cfg).items()}, paths["scrfd"])
    paths["safety_checker"] = os.path.join(sd15["base"], "safety_checker")
    paths["arcface_onnx"] = os.path.join(outdir, "arcface.onnx")
    write_onnx_initializers(paths["arcface_onnx"],
                            read_checkpoint(paths["arcface"]))

    # CLIP-T projection heads into a shared space (HF CLIPModel layout:
    # (shared, D) torch linear weights)
    rng = np.random.RandomState(4)
    paths["clip_projections"] = os.path.join(outdir,
                                             "clip_projections.safetensors")
    write_safetensors(paths["clip_projections"], {
        "text_projection.weight": rng.randn(
            16, bundle.text_config.hidden_size).astype(np.float32) * 0.1,
        "visual_projection.weight": rng.randn(
            16, bundle.vision_config.hidden_size).astype(np.float32) * 0.1,
    })
    return paths


# ------------------------------------------------------- accelerator modes

# (mode, quant, cache_interval)
SERVING_MODES = (("exact", "none", 1), ("int8", "int8", 1),
                 ("int8_static", "int8_static", 1),
                 ("cache2", "none", 2), ("cache3", "none", 3),
                 # the composed accelerators: calibrated int8 x DeepCache
                 ("int8_static_cache2", "int8_static", 2),
                 ("int8_static_cache3", "int8_static", 3))


def clip_t_scorer(pipe, clip_projections: str):
    """CLIPTScorer over the pipeline's towers, with the projection heads of
    a CLIP model file (text_projection.weight / visual_projection.weight)."""
    from ..eval.metrics import CLIPTScorer
    from ..io.safetensors_reader import read_checkpoint

    proj = read_checkpoint(clip_projections)
    return CLIPTScorer(pipe.bundle, pipe.tokenizer,
                       text_projection=proj["text_projection.weight"].T,
                       visual_projection=proj["visual_projection.weight"].T)


def _sweep_rows(n_rows: int):
    from ..eval.runner import SweepRow
    from ..eval.styles import STYLES

    styles = list(STYLES)[:4]
    return [SweepRow("id0.png", f"a man with a face, variation {i}",
                     style=styles[i % len(styles)]) for i in range(n_rows)]


def _write_face(directory: str, face: np.ndarray) -> None:
    from ..utils.png import encode_png

    with open(os.path.join(directory, "id0.png"), "wb") as f:
        f.write(encode_png(face))


# steps of each mode's warm-up request (fewer where the config runs fewer):
# one full UNet call and at least one cached call at every DeepCache
# interval of SERVING_MODES
WARMUP_STEPS = 4


def run_mode_sweep(pipe, face: np.ndarray, n_rows: int,
                   clip_projections=None) -> Dict:
    """Score every serving mode (exact / int8 W8A8 dynamic / int8_static
    calibrated / DeepCache 2 and 3 / int8_static with DeepCache) on the
    same rows and seeds: {mode: {img_per_min, face_sim, clip_t, d_face_sim,
    d_clip_t}}. Quality deltas are against the exact row: the identity
    metrics rather than pixel bounds, so a mode that degrades identity
    shows here. int8_static is calibrated on the sweep's identity image and
    first prompt (calibrate_int8)."""
    from ..eval.metrics import FaceSimScorer
    from ..eval.runner import run_sweep

    rows = _sweep_rows(n_rows)
    face_scorer = (FaceSimScorer(pipe.face_embedder)
                   if pipe.face_embedder else None)
    clip_scorer = (clip_t_scorer(pipe, clip_projections)
                   if clip_projections else None)

    static = pipe.calibrate_int8(rows[0].prompt, face, num_calib_steps=4)
    by_quant = {"none": pipe, "int8": pipe.with_quant("int8"),
                "int8_static": static}

    out: Dict = {}
    batch = max(1, min(4, n_rows))
    with tempfile.TemporaryDirectory() as td:
        _write_face(td, face)
        for mode, quant, interval in SERVING_MODES:
            p_ = by_quant[quant]
            kw = {} if interval == 1 else {"cache_interval": interval}
            # warm the mode (its kernels built and loaded, the allocator
            # grown) so the measured latency is steady-state; nothing is
            # traced per step count, so a few steps do it
            p_.generate_batch(["warmup"] * batch, [face] * batch,
                              negative_prompts=[""] * batch,
                              seeds=list(range(batch)),
                              num_inference_steps=min(
                                  WARMUP_STEPS,
                                  p_.config.num_inference_steps), **kw)
            res = run_sweep(p_, rows, td, face_sim_scorer=face_scorer,
                            clip_t_scorer=clip_scorer, batch_size=batch,
                            **kw)
            s = res.summary()
            rec = {"img_per_min": round(60.0 / s["mean_latency_s"], 2)}
            for key in ("face_sim", "clip_t"):
                if f"mean_{key}" in s:
                    rec[key] = round(s[f"mean_{key}"], 4)
                    if mode != "exact":
                        rec[f"d_{key}"] = round(
                            s[f"mean_{key}"] - out["exact"][key], 4)
            out[mode] = rec
            cells = "  ".join(f"{k}={v}" for k, v in rec.items())
            print(f"  {mode:>6}: {cells}")
    return out


# ------------------------------------------------------------------- main

def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--base", help="diffusers SD1.5 dump dir")
    p.add_argument("--sdxl-base", help="diffusers SDXL dump dir")
    p.add_argument("--consistentid", help="ConsistentID-v1.bin")
    p.add_argument("--image-encoder", help="CLIP ViT-H vision checkpoint")
    p.add_argument("--bisenet", help="face_parsing.pth")
    p.add_argument("--arcface", help="w600k_r50.onnx / .pt")
    p.add_argument("--scrfd", help="det_10g.onnx / .pt")
    p.add_argument("--arcface-onnx",
                   help="ONNX-format ArcFace pack (exercises the ONNX "
                        "initializer reader; --synthesize writes one)")
    p.add_argument("--safety-checker",
                   help="diffusers safety_checker/ dump dir")
    p.add_argument("--sweep", type=int, metavar="N", default=0,
                   help="run an N-row scored FGIS sweep (FaceSim) through "
                        "eval.runner after the pipeline stage; "
                        "apps/eval_sweep.py runs the full 15x45 protocol")
    p.add_argument("--mode-sweep", type=int, metavar="N", default=0,
                   help="run an N-row sweep in each serving mode (exact / "
                        "int8 / int8_static / cache-2 / cache-3 / "
                        "int8_static with cache-2 and -3) with identical "
                        "rows and seeds, and report img/min and the "
                        "FaceSim / CLIP-T deltas against exact")
    p.add_argument("--clip-projections",
                   help="CLIP model file with text_projection.weight / "
                        "visual_projection.weight (for CLIP-T)")
    p.add_argument("--face", help="reference face image, .png or .npy "
                                  "(default: seeded noise)")
    p.add_argument("--prompt", default="portrait photo of a man with a "
                                       "strong face and blue eyes")
    p.add_argument("--out", default="validate_report.json")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--skip-generate", action="store_true",
                   help="converter + layer checks only")
    p.add_argument("--synthesize", metavar="DIR",
                   help="write tiny synthetic reference-layout checkpoints "
                        "to DIR and validate those (self-test, no real "
                        "weights needed; implies --tiny)")
    p.add_argument("--tiny", action="store_true",
                   help="validate against the tiny test-bundle configs "
                        "(for checkpoints written by --synthesize)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return p


def _sd15_bundle(tiny: bool, device: str):
    """The SD1.5 bundle the files are checked against and loaded into: the
    tiny test bundle, or the loader's full-size default (bf16)."""
    import torch

    from ..core.config import AdapterConfig, sd15_unet_config
    from ..pipelines import SD15Bundle
    from ..testing import tiny_bundle

    if tiny:
        return tiny_bundle(device=device)
    return SD15Bundle(
        unet_config=sd15_unet_config(lora_rank=128, ip_num_tokens=4),
        adapter_config=AdapterConfig(num_id_tokens=4),
        dtype=torch.bfloat16, device=device)


def _sdxl_configs(tiny: bool):
    """(unet, vae, text, text_2) configs of the SDXL dump: the tiny test
    bundle's, or the loader's full-size defaults."""
    from ..core.config import (CLIPTextConfig, VAEConfig,
                               clip_text_bigg_config, sdxl_unet_config)
    from ..testing import tiny_sdxl_bundle

    if tiny:
        xl = tiny_sdxl_bundle(device="cpu")
        return xl.unet_config, xl.vae_config, xl.text_config, \
            xl.text_config_2
    return (sdxl_unet_config(lora_rank=128, ip_num_tokens=4),
            VAEConfig(scaling_factor=0.13025, force_upcast=True),
            CLIPTextConfig(), clip_text_bigg_config())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    tiny = bool(args.synthesize) or args.tiny
    if args.synthesize:
        print(f"synthesizing tiny reference-layout checkpoints in "
              f"{args.synthesize} ...")
        paths = synthesize(args.synthesize)
        for k, v in paths.items():
            if getattr(args, k, None) is None:
                setattr(args, k, v)

    from ..io import convert
    from ..io.convert_backbones import (clip_text_from_hf,
                                        clip_vision_from_hf,
                                        safety_checker_from_hf,
                                        unet_from_diffusers,
                                        vae_from_diffusers)
    from ..io.from_jax import tree_from_module
    from ..models.safety_checker import SAFETY_VISION_CONFIG

    bundle = _sd15_bundle(tiny, args.device)
    report: Dict = {"files": {}, "pipelines": {}, "metrics": {},
                    "seconds": {}}

    def stage(name, path, fn, ignore=()):
        if not path:
            return
        try:
            entry = validate_file(path, fn, ignore_unconsumed=ignore)
        except Exception as e:  # noqa: BLE001 (the converter's error is
            # the finding: it is reported, and fails the run)
            entry = {"path": path, "ok": False,
                     "error": f"{type(e).__name__}: {e}"}
        report["files"][name] = entry
        status = "ok" if entry["ok"] else "FAIL"
        print(f"  [{status}] {name}: {entry.get('params', 0):,} params, "
              f"{len(entry.get('unconsumed_source_keys', []))} unconsumed, "
              f"{len(entry.get('nonfinite', []))} non-finite "
              f"{entry.get('error', '')}")

    print("stage 1: converters + per-layer sanity")
    t0 = time.perf_counter()
    ignore_bn = ("num_batches_tracked",)
    if args.base:
        stage("unet", os.path.join(args.base, "unet"),
              lambda sd: unet_from_diffusers(sd, bundle.unet_config))
        stage("vae", os.path.join(args.base, "vae"),
              lambda sd: vae_from_diffusers(sd, bundle.vae_config))
        stage("text_encoder", os.path.join(args.base, "text_encoder"),
              lambda sd: clip_text_from_hf(sd, bundle.text_config),
              ignore=("position_ids",))
    if args.sdxl_base:
        xl_unet, xl_vae, xl_text, xl_text_2 = _sdxl_configs(tiny)
        stage("sdxl_unet", os.path.join(args.sdxl_base, "unet"),
              lambda sd: unet_from_diffusers(sd, xl_unet))
        stage("sdxl_vae", os.path.join(args.sdxl_base, "vae"),
              lambda sd: vae_from_diffusers(sd, xl_vae))
        stage("sdxl_text_encoder",
              os.path.join(args.sdxl_base, "text_encoder"),
              lambda sd: clip_text_from_hf(sd, xl_text),
              ignore=("position_ids",))
        stage("sdxl_text_encoder_2",
              os.path.join(args.sdxl_base, "text_encoder_2"),
              lambda sd: clip_text_from_hf(sd, xl_text_2),
              ignore=("position_ids", "text_projection"))
    stage("image_encoder", args.image_encoder,
          lambda sd: clip_vision_from_hf(sd, bundle.vision_config),
          ignore=("position_ids",))
    # merged into the bundle's whole tree, as the JAX stage merges it into
    # its init tree; section-level recording only (nested dict), so the
    # unconsumed check is skipped
    stage("consistentid", args.consistentid,
          lambda sd: convert.load_consistentid_checkpoint(
              tree_from_module(bundle)[0], dict(sd), bundle.unet_config),
          ignore=("image_proj", "adapter_modules", "FacialEncoder"))
    stage("bisenet", args.bisenet, convert.bisenet_from_torch,
          ignore=ignore_bn)
    stage("arcface", args.arcface, convert.iresnet_from_torch,
          ignore=ignore_bn)
    stage("scrfd", args.scrfd, lambda sd: convert.scrfd_from_torch(sd)[:2],
          ignore=ignore_bn)
    stage("arcface_onnx", args.arcface_onnx, convert.iresnet_from_torch,
          ignore=ignore_bn)
    if args.safety_checker:
        sc_cfg = bundle.vision_config if tiny else SAFETY_VISION_CONFIG
        stage("safety_checker", args.safety_checker,
              lambda sd: safety_checker_from_hf(sd, sc_cfg),
              ignore=("position_ids",))

    report["seconds"]["converters"] = time.perf_counter() - t0

    if not args.skip_generate and args.base:
        t0 = time.perf_counter()
        _pipeline_stages(args, tiny, bundle, report)
        report["seconds"]["pipelines"] = time.perf_counter() - t0

    report["ok"] = bool(
        all(e.get("ok") for e in report["files"].values())
        and all(e.get("ok") for e in report["pipelines"].values())
        and not any(k.endswith("_error") for k in report["metrics"]))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report: {args.out}  ok={report['ok']}")
    return 0 if report["ok"] else 1


def _pipeline_stages(args, tiny: bool, bundle, report: Dict) -> None:
    """Stages 2-5: assemble the pipelines and generate one image each,
    score it, then the sweeps; each failure is recorded in the report."""
    from ..core.config import PipelineConfig
    from ..eval.metrics import FaceSimScorer
    from ..eval.runner import run_sweep
    from ..pipelines import ConsistentIDInpaintPipeline
    from ..pipelines.loading import (load_sd15_consistentid,
                                     load_sdxl_consistentid)
    from ..testing import tiny_sdxl_bundle
    from ..utils.png import read_image

    print("stage 2: pipeline assembly + one image each")
    h = args.height or (64 if tiny else 512)
    w = args.width or (64 if tiny else 512)
    steps = args.steps or (3 if tiny else 50)
    cfg = PipelineConfig(height=h, width=w, num_inference_steps=steps,
                         start_merge_step=1 if tiny else 30)
    if args.face:
        face = read_image(args.face)
    else:
        face = np.random.RandomState(0).randint(0, 255, (128, 128, 3),
                                                np.uint8)

    pipe = load_sd15_consistentid(
        args.base, consistentid_path=args.consistentid,
        image_encoder_path=args.image_encoder,
        bisenet_path=args.bisenet, arcface_path=args.arcface,
        scrfd_path=args.scrfd, pipeline_config=cfg, bundle=bundle,
        device=args.device)

    def record(name, fn):
        try:
            arr = np.asarray(fn())
            report["pipelines"][name] = {
                "ok": bool(np.isfinite(arr.astype(np.float32)).all()
                           and arr.std() > 0),
                "shape": list(arr.shape)}
            print(f"  [ok] {name}: {arr.shape}")
            return arr
        except Exception as e:  # noqa: BLE001 (recorded; fails the run)
            report["pipelines"][name] = {
                "ok": False, "error": f"{type(e).__name__}: {e}"}
            print(f"  [FAIL] {name}: {e}")
            return None

    out = record("sd15", lambda: pipe.generate(args.prompt, face, seed=1)[0])
    if out is not None:
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = 255
        inpipe = ConsistentIDInpaintPipeline(
            pipe.bundle, pipe.tokenizer, pipeline_config=cfg,
            face_parser=pipe.face_parser, face_embedder=pipe.face_embedder)
        record("inpaint", lambda: inpipe.generate(
            args.prompt, face, out, mask, strength=0.8, seed=2)[0])

    xl_pipe = None
    if args.sdxl_base:
        xl_pipe = load_sdxl_consistentid(
            args.sdxl_base, image_encoder_path=args.image_encoder,
            bisenet_path=args.bisenet, arcface_path=args.arcface,
            scrfd_path=args.scrfd, pipeline_config=cfg,
            bundle=tiny_sdxl_bundle(device=args.device) if tiny else None,
            device=args.device)
        record("sdxl", lambda: xl_pipe.generate(args.prompt, face,
                                                seed=3)[0])

    metrics = report["metrics"]
    print("stage 3: quality metrics")
    if out is not None and pipe.face_embedder is not None:
        try:
            sim = FaceSimScorer(pipe.face_embedder)(face, out)
            metrics["face_sim"] = float(sim)
            print(f"  face_sim: {sim:.4f}")
        except Exception as e:  # noqa: BLE001 (recorded; fails the run)
            metrics["face_sim_error"] = f"{type(e).__name__}: {e}"
    if out is not None and args.clip_projections:
        try:
            score = clip_t_scorer(pipe, args.clip_projections)(args.prompt,
                                                               out)
            metrics["clip_t"] = float(score)
            print(f"  clip_t: {score:.4f}")
        except Exception as e:  # noqa: BLE001 (recorded; fails the run)
            metrics["clip_t_error"] = f"{type(e).__name__}: {e}"

    if args.sweep > 0:
        print(f"stage 4: scored FGIS sweep ({args.sweep} rows)")
        try:
            with tempfile.TemporaryDirectory() as td:
                _write_face(td, face)
                sweep_out = os.path.join(td, "out")
                res = run_sweep(
                    pipe, _sweep_rows(args.sweep), td, output_dir=sweep_out,
                    face_sim_scorer=(FaceSimScorer(pipe.face_embedder)
                                     if pipe.face_embedder else None),
                    batch_size=min(4, args.sweep))
                with open(os.path.join(sweep_out,
                                       "results_shard0.json")) as f:
                    json.load(f)  # the report JSON must be well-formed
            metrics["sweep"] = res.summary()
            metrics["sweep_rows"] = len(res.rows)
            print(f"  sweep: {len(res.rows)} rows, {res.summary()}")
        except Exception as e:  # noqa: BLE001 (recorded; fails the run)
            metrics["sweep_error"] = f"{type(e).__name__}: {e}"
            print(f"  [FAIL] sweep: {e}")

    if args.mode_sweep > 0:
        for key, p_, proj in (("mode_sweep", pipe, args.clip_projections),
                              ("mode_sweep_xl", xl_pipe, None)):
            if p_ is None:
                continue
            print(f"stage 5: serving-mode sweep, {key} ({args.mode_sweep} "
                  f"rows x {len(SERVING_MODES)} modes)")
            try:
                metrics[key] = run_mode_sweep(p_, face, args.mode_sweep,
                                              clip_projections=proj)
            except Exception as e:  # noqa: BLE001 (recorded; fails it)
                metrics[f"{key}_error"] = f"{type(e).__name__}: {e}"
                print(f"  [FAIL] {key}: {e}")


if __name__ == "__main__":
    sys.exit(main())
