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
between (DeepCache). The JAX CLI's argument checks apply. The int8 flags
exit with an error naming their ROADMAP item (A9).
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
    # flags of a path not ported yet: kept so they fail loudly
    p.add_argument("--quant", choices=["none", "int8", "int8_static"],
                   default="none", help="int8 UNet (not ported yet)")
    p.add_argument("--act-scales", default=None,
                   help="int8_static scales to load (not ported yet)")
    p.add_argument("--save-act-scales", default=None,
                   help="int8_static scales to save (not ported yet)")
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


NOT_PORTED = (("act_scales", "--act-scales"),
              ("save_act_scales", "--save-act-scales"))


def check_args(parser: argparse.ArgumentParser,
               args: argparse.Namespace) -> None:
    """Exit through parser.error on the JAX CLI's argument errors, and for
    the int8 flags, whose path is not ported (ROADMAP A9)."""
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
    for attr, flag in NOT_PORTED:
        if getattr(args, attr):
            parser.error(f"{flag} is not ported yet (ROADMAP A9)")
    if args.quant != "none":
        parser.error(f"--quant {args.quant} is not ported yet (ROADMAP A9)")


def load_pipeline(args: argparse.Namespace):
    """The pipeline the flags describe, from the checkpoint files."""
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
              device=args.device)
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

    from ..utils.png import read_array, read_image

    pipe = load_pipeline(args)
    face = read_image(args.image)
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
