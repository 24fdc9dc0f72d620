"""CLI: ConsistentID generation from checkpoint files (reference
infer.py:10-73; the JAX package's apps/infer.py), on the card unless
`--device cpu` is given.

    python -m consistentid_torch.apps.infer \
        --base /path/sd15 --consistentid ConsistentID-v1.bin \
        --image-encoder image_encoder.safetensors \
        --bisenet face_parsing.pth --arcface w600k_r50.onnx \
        --scrfd det_10g.onnx --image face.png \
        --prompt "cinematic photo, a man ..." --out out.png

Defaults mirror the reference: Euler, 50 steps, start_merge_step 30, CFG
5.0, 768x512 (height x width), seed 2024 (infer.py:48-64). `--sdxl` loads
an SDXL dump (text_encoder_2/, tokenizer_2/ beside SD1.5's subfolders) with
`load_sdxl_consistentid` and applies the same defaults, as the JAX CLI does
(its help names infer_SDXL.py's 864x1152 and CFG 7.5, which it does not
apply). The face image is a PNG or a .npy uint8 array; outputs are PNGs.

`--init-image` edits an image instead of starting from noise (img2img,
SD1.5 only); with `--mask-image` (white regenerates) it inpaints it; a
`--strength` share of the schedule runs. `--cache-interval N` (text to
image) runs the full UNet every N-th step and only its level-0 blocks in
between (DeepCache). The JAX CLI's argument checks apply.

`--quant int8` serves the W8A8 UNet with activation scales found on every
call; `--quant int8_static` with calibrated per-tensor scales: the exact
pipeline is loaded, then either `--act-scales` (a saved .npz, read before
the load) or a calibration on the request's own prompt and face at
`--lora-scale` (`pipe.calibrate_int8`) gives the scales, which
`--save-act-scales` writes. The scale flags apply to int8_static only, and
`--save-act-scales` only to a calibration (the JAX CLI ignores both
silently).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

SCHEDULERS = ["ddim", "euler", "ddpm", "dpmpp_2m", "pndm"]


def build_parser(one_shot: bool = True) -> argparse.ArgumentParser:
    """The CLI's flags; one_shot=False (the server) leaves --image and
    --prompt optional, as requests bring their own."""
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--base", required=True,
                   help="diffusers SD1.5 dir (SDXL with --sdxl)")
    p.add_argument("--consistentid", default=None,
                   help="ConsistentID-v1.bin / .safetensors")
    p.add_argument("--image-encoder", default=None,
                   help="CLIP ViT-H checkpoint")
    p.add_argument("--bisenet", default=None, help="face_parsing.pth")
    p.add_argument("--arcface", default=None, help="w600k_r50.onnx / .pt")
    p.add_argument("--scrfd", default=None,
                   help="det_10g.onnx / .pt face detector (detect -> align "
                        "as insightface FaceAnalysis)")
    p.add_argument("--tokenizer", default=None,
                   help="CLIP tokenizer dir (vocab.json + merges.txt); "
                        "default: <base>/tokenizer")
    p.add_argument("--image", required=one_shot,
                   help="reference face image (.png or .npy)")
    p.add_argument("--prompt", required=one_shot)
    p.add_argument("--negative-prompt", default=(
        "monochrome, lowres, bad anatomy, worst quality, low quality, "
        "blurry"))
    p.add_argument("--out", default="out.png")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=5.0)
    p.add_argument("--start-merge-step", type=int, default=30)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--scheduler", default="euler", choices=SCHEDULERS)
    p.add_argument("--num-images", type=int, default=1)
    p.add_argument("--ip-scale", type=float, default=1.0,
                   help="identity-adapter strength")
    p.add_argument("--lora-scale", type=float, default=1.0)
    p.add_argument("--tiny", action="store_true",
                   help="toy-scale model configs (testing.tiny_bundle or "
                        "tiny_sdxl_bundle, for toy checkpoint sets)")
    p.add_argument("--no-safety-checker", action="store_true",
                   help="skip the CLIP safety checker even if the dump "
                        "ships one")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--cache-interval", type=int, default=1,
                   help="DeepCache: run the full UNet every N-th denoise "
                        "step, only its level-0 blocks in between (1 = "
                        "off; text to image only)")
    p.add_argument("--quant", choices=["none", "int8", "int8_static"],
                   default="none",
                   help="int8: the W8A8 UNet (int8 products, int32 sums; "
                        "the same checkpoints, weights quantized per call, "
                        "activations per call). int8_static: activation "
                        "scales calibrated first on this prompt and face "
                        "(or read from --act-scales), then fixed")
    p.add_argument("--act-scales", default=None,
                   help="int8_static: read calibrated activation scales "
                        "from this .npz (--save-act-scales) instead of "
                        "calibrating at startup")
    p.add_argument("--save-act-scales", default=None,
                   help="int8_static: write the startup calibration's "
                        "activation scales to this .npz")
    p.add_argument("--sdxl", action="store_true",
                   help="SDXL base (reference infer_SDXL.py defaults: "
                        "864x1152, CFG 7.5; not applied, as in the JAX CLI)")
    p.add_argument("--tokenizer-2", default=None,
                   help="SDXL second tokenizer dir; default: "
                        "<base>/tokenizer_2")
    p.add_argument("--init-image", default=None,
                   help="img2img: edit this image (.png or .npy) instead of "
                        "starting from noise (SD1.5 only); with "
                        "--mask-image, inpaint it")
    p.add_argument("--mask-image", default=None,
                   help="binary inpaint mask (.png or .npy; white = "
                        "regenerate); requires --init-image")
    p.add_argument("--strength", type=float, default=0.8,
                   help="img2img/inpaint: share of the schedule applied to "
                        "the init image (1.0 = ignore its content)")
    return p


def check_args(parser: argparse.ArgumentParser,
               args: argparse.Namespace) -> None:
    """Exit through parser.error on the JAX CLI's argument errors, and on
    scale flags that would do nothing (the JAX CLI ignores them)."""
    if args.mask_image and not args.init_image:
        parser.error("--mask-image requires --init-image")
    if args.init_image and args.sdxl:
        parser.error("--init-image is SD1.5-only (the reference has no "
                     "SDXL img2img/inpaint variant either)")
    if not 0.0 < args.strength <= 1.0:
        parser.error(f"--strength must be in (0, 1]: {args.strength}")
    if args.init_image and args.num_images != 1:
        parser.error("--num-images > 1 is text-to-image only; the "
                     "img2img/inpaint paths run one image per call")
    if args.init_image and args.cache_interval != 1:
        parser.error("--cache-interval applies to the text-to-image path "
                     "only; the img2img/inpaint pipelines run the exact UNet")
    if args.cache_interval < 1:
        parser.error(f"--cache-interval must be >= 1: {args.cache_interval}")
    if args.init_image and args.quant == "int8_static":
        parser.error("--quant int8_static calibrates/serves the t2i path "
                     "only; use --quant int8 (dynamic) with --init-image")
    for flag in ("act_scales", "save_act_scales"):
        if getattr(args, flag) and args.quant != "int8_static":
            parser.error(f"--{flag.replace('_', '-')} applies to --quant "
                         "int8_static only")
    if args.act_scales and args.save_act_scales:
        parser.error("--save-act-scales writes a calibration's scales; "
                     "with --act-scales nothing is calibrated")


def read_act_scales(parser: argparse.ArgumentParser,
                    args: argparse.Namespace):
    """The --act-scales tree (None without the flag), read before anything
    is loaded; a file that is not an act-scales artifact exits through
    parser.error."""
    if not args.act_scales:
        return None
    from ..io.quant_scales import load_act_scales
    try:
        return load_act_scales(args.act_scales)
    except (OSError, ValueError) as e:
        parser.error(f"--act-scales: {e}")


def to_int8_static(pipe, act_scales, samples, save_path: Optional[str],
                   **calibrate_kw):
    """`pipe` at int8_static: with the given act_scales, else calibrated
    over `samples` (pipe.calibrate_int8), the scales then written to
    `save_path` if one is given."""
    if act_scales is not None:
        return pipe.with_quant("int8_static", act_scales=act_scales)
    pipe = pipe.calibrate_int8(samples=samples, **calibrate_kw)
    if save_path:
        from ..io.quant_scales import save_act_scales
        save_act_scales(save_path, pipe.bundle.act_scales)
        print(f"saved act scales -> {save_path}")
    return pipe


def load_pipeline(args: argparse.Namespace):
    """The pipeline the flags describe, from the checkpoint files; under
    int8_static the exact one, to be calibrated (`to_int8_static`)."""
    from ..conditioning import CLIPBPETokenizer
    from ..core.config import PipelineConfig
    from ..pipelines.loading import (load_sd15_consistentid,
                                     load_sdxl_consistentid)

    config = PipelineConfig(
        height=args.height, width=args.width,
        num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        start_merge_step=args.start_merge_step, scheduler=args.scheduler,
        cache_interval=args.cache_interval)
    kw = dict(consistentid_path=args.consistentid,
              image_encoder_path=args.image_encoder,
              bisenet_path=args.bisenet, arcface_path=args.arcface,
              scrfd_path=args.scrfd, pipeline_config=config,
              device=args.device,
              quant="none" if args.quant == "int8_static" else args.quant)
    if args.tokenizer:
        kw["tokenizer"] = CLIPBPETokenizer.from_pretrained(args.tokenizer)
    if args.sdxl:
        if args.tokenizer_2:
            kw["tokenizer_2"] = CLIPBPETokenizer.from_pretrained(
                args.tokenizer_2)
        if args.tiny:
            from ..testing import tiny_sdxl_bundle
            kw["bundle"] = tiny_sdxl_bundle(device=args.device)
        return load_sdxl_consistentid(args.base, **kw)
    if args.tiny:
        from ..testing import tiny_bundle
        kw["bundle"] = tiny_bundle(device=args.device)
    if args.init_image:
        from ..pipelines import (ConsistentIDImg2ImgPipeline,
                                 ConsistentIDInpaintPipeline)
        kw["pipeline_cls"] = (ConsistentIDInpaintPipeline if args.mask_image
                              else ConsistentIDImg2ImgPipeline)
    return load_sd15_consistentid(
        args.base, with_safety_checker=not args.no_safety_checker, **kw)


def write_images(images, out: str) -> List[str]:
    from ..utils.png import encode_png

    stem, ext = (out.rsplit(".", 1) + ["png"])[:2]
    names = []
    for i, img in enumerate(images):
        name = out if len(images) == 1 else f"{stem}_{i}.{ext}"
        with open(name, "wb") as f:
            f.write(encode_png(img))
        names.append(name)
    return names


def main(argv: Optional[List[str]] = None):
    """Run the CLI; returns the pipeline (its `last_stage_ms` holds the
    call's stage times)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(parser, args)
    act_scales = read_act_scales(parser, args)

    from ..utils.png import read_array, read_image

    pipe = load_pipeline(args)
    face = read_image(args.image)
    if args.quant == "int8_static":
        # calibrated at the serving lora_scale: a fold at another scale
        # shifts the activations against the calibrated clip points
        pipe = to_int8_static(
            pipe, act_scales,
            [{"prompt": args.prompt, "face_image": face,
              "negative_prompt": args.negative_prompt}],
            args.save_act_scales, lora_scale=args.lora_scale)
    kw = dict(negative_prompt=args.negative_prompt, seed=args.seed,
              ip_scale=args.ip_scale, lora_scale=args.lora_scale)
    if args.mask_image:
        images = pipe.generate(args.prompt, face, read_image(args.init_image),
                               read_array(args.mask_image),
                               strength=args.strength, **kw)
    elif args.init_image:
        images = pipe.generate(args.prompt, face, read_image(args.init_image),
                               strength=args.strength, **kw)
    else:
        images = pipe.generate(args.prompt, face,
                               num_images_per_prompt=args.num_images, **kw)
    for name in write_images(images, args.out):
        print(f"saved {name}")
    return pipe


if __name__ == "__main__":
    main()
