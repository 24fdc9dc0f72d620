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
Flags of paths not ported yet (img2img/inpaint, int8, DeepCache) exit with
an error naming the ROADMAP item.
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
    # flags of paths not ported yet: kept so they fail loudly
    p.add_argument("--cache-interval", type=int, default=1,
                   help="DeepCache (not ported yet: 1 only)")
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
                   help="img2img init image (not ported yet)")
    p.add_argument("--mask-image", default=None,
                   help="inpaint mask (not ported yet)")
    p.add_argument("--strength", type=float, default=0.8,
                   help="img2img/inpaint strength (not ported yet)")
    return p


NOT_PORTED = (
    ("init_image", "--init-image", "A6"), ("mask_image", "--mask-image", "A6"),
    ("act_scales", "--act-scales", "A9"),
    ("save_act_scales", "--save-act-scales", "A9"),
)


def check_args(parser: argparse.ArgumentParser,
               args: argparse.Namespace) -> None:
    """Exit through parser.error for flags whose paths are not ported, and
    for --init-image with --sdxl, which the JAX CLI refuses too."""
    if args.init_image and args.sdxl:
        parser.error("--init-image is SD1.5-only (the reference has no "
                     "SDXL img2img/inpaint variant either)")
    for attr, flag, item in NOT_PORTED:
        if getattr(args, attr):
            parser.error(f"{flag} is not ported yet (ROADMAP {item})")
    if args.quant != "none":
        parser.error(f"--quant {args.quant} is not ported yet (ROADMAP A9)")
    if args.cache_interval != 1:
        parser.error("--cache-interval > 1 is not ported yet (ROADMAP A8)")
    if args.strength != 0.8:
        parser.error("--strength is for --init-image, not ported yet "
                     "(ROADMAP A6)")


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
        start_merge_step=args.start_merge_step, scheduler=args.scheduler)
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

    from ..utils.png import read_image

    pipe = load_pipeline(args)
    face = read_image(args.image)
    images = pipe.generate(
        args.prompt, face, negative_prompt=args.negative_prompt,
        seed=args.seed, num_images_per_prompt=args.num_images,
        ip_scale=args.ip_scale, lora_scale=args.lora_scale)
    for name in write_images(images, args.out):
        print(f"saved {name}")
    return pipe


if __name__ == "__main__":
    main()
