"""Gradio demo (reference app.py:16-98; the JAX package's apps/demo.py), on
the card unless `--device cpu` is given. gradio is optional: it is imported
only to build the interface, and without it `main` exits naming it.

    python -m consistentid_torch.apps.demo \
        --base /path/sd15 --consistentid ConsistentID-v1.bin \
        --image-encoder image_encoder.safetensors \
        --bisenet face_parsing.pth --arcface w600k_r50.onnx \
        --scrfd det_10g.onnx --port 7860

The pipeline is built once and serves every request, as in the JAX demo
(the reference reloads it per request, app.py:24-37). The interface has
the JAX demo's widgets, labels, ranges and defaults; the face arrives as a
numpy (H, W, 3) uint8 array (`gr.Image(type="numpy")`), the form every
entry point of the port takes, where the JAX demo asks gradio for a PIL
image.

Flags: the infer CLI's, none required but `--base` and `--bisenet` (the UI
sends no parsing map, so every request parses its face), plus `--port`.
Honoured: the checkpoint paths (`--consistentid`, `--image-encoder`,
`--bisenet`, `--arcface`, `--scrfd`, `--tokenizer`), `--no-safety-checker`,
`--device`, `--tiny`, `--scheduler` (default ddim, PipelineConfig's, which
the JAX demo samples with) and `--height/--width` (default 512,
PipelineConfig's). Refused through the parser, as the JAX demo accepts and
drops them: what the UI sets per request (`--prompt`, `--image`,
`--negative-prompt`, `--steps`, `--start-merge-step`, `--guidance-scale`,
`--seed`), what it cannot return (`--num-images`, `--out`), and the modes
it does not serve (`--sdxl`, `--tokenizer-2`, `--init-image`,
`--mask-image`, `--strength`, `--quant` other than none, `--act-scales`,
`--save-act-scales`, `--cache-interval` other than 1, `--ip-scale` and
`--lora-scale` other than 1.0).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..core.config import PipelineConfig

TITLE = "ConsistentID on PyTorch/CUDA"

# the flags the UI sets per request or cannot return: None unless given
PER_REQUEST = ("prompt", "image", "negative_prompt", "steps",
               "start_merge_step", "guidance_scale", "seed", "num_images",
               "out")
# the modes the demo does not serve: None unless given
NOT_SERVED = ("tokenizer_2", "init_image", "mask_image", "strength",
              "act_scales", "save_act_scales")


def demo_callback(pipe):
    """The request handler: run(image, prompt, negative_prompt, steps,
    merge_step, guidance, seed) -> the first uint8 (H, W, 3) image of
    `pipe.generate` on the (H, W, 3) uint8 face `image`; the widgets'
    numbers are cast as the JAX demo casts them."""
    def run(image, prompt, negative_prompt, steps, merge_step, guidance,
            seed):
        img = pipe.generate(
            prompt, image, negative_prompt=negative_prompt,
            num_inference_steps=int(steps),
            start_merge_step=int(merge_step),
            guidance_scale=float(guidance), seed=int(seed))
        return img[0]

    return run


def build_interface(pipe):
    import gradio as gr

    return gr.Interface(
        fn=demo_callback(pipe),
        inputs=[
            gr.Image(type="numpy", label="reference face"),
            gr.Textbox(label="prompt"),
            gr.Textbox(label="negative prompt", value=""),
            gr.Slider(1, 100, value=50, label="steps"),
            gr.Slider(0, 100, value=30, label="start merge step"),
            gr.Slider(1.0, 15.0, value=5.0, label="guidance scale"),
            gr.Number(value=2024, label="seed"),
        ],
        outputs=gr.Image(label="result"),
        title=TITLE,
    )


def build_parser() -> argparse.ArgumentParser:
    """The infer CLI's flags (--image and --prompt not required) and
    --port; the flags main refuses default to None."""
    from .infer import build_parser as infer_parser

    p = infer_parser(one_shot=False)
    p.description = __doc__
    cfg = PipelineConfig()
    p.set_defaults(scheduler=cfg.scheduler, height=cfg.height,
                   width=cfg.width,
                   **{flag: None for flag in PER_REQUEST + NOT_SERVED})
    p.add_argument("--port", type=int, default=7860)
    return p


def check_args(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """Exit through p.error on every flag the demo would not honour."""
    if args.bisenet is None:
        p.error("--bisenet is required: the UI sends no parsing map, so "
                "each request's face is parsed")
    for flag in PER_REQUEST:
        if getattr(args, flag) is not None:
            p.error(f"--{flag.replace('_', '-')} is the infer CLI's: the "
                    "UI sets the prompt, face, steps, merge step, guidance "
                    "and seed of each request and shows one image")
    if args.sdxl:
        p.error("--sdxl: the demo serves SD1.5 only, as the JAX demo does")
    for flag in NOT_SERVED:
        if getattr(args, flag) is not None:
            p.error(f"--{flag.replace('_', '-')} is the infer CLI's: the "
                    "demo serves text to image from the exact SD1.5 "
                    "pipeline")
    if args.quant != "none":
        p.error("--quant is the infer CLI's: the demo serves the exact "
                "SD1.5 pipeline")
    if args.cache_interval != 1:
        p.error("--cache-interval is the infer CLI's: the demo serves the "
                "exact SD1.5 pipeline")
    for flag in ("ip_scale", "lora_scale"):
        if getattr(args, flag) != 1.0:
            p.error(f"--{flag.replace('_', '-')} is the infer CLI's: the "
                    "demo serves at 1.0")


def main(argv: Optional[List[str]] = None):
    """Build the pipeline once and launch the interface on --port; returns
    the pipeline when the launch returns."""
    p = build_parser()
    args = p.parse_args(argv)
    check_args(p, args)
    try:
        import gradio  # noqa: F401
    except ImportError as e:
        raise SystemExit("gradio is not installed in this environment; "
                         "use consistentid_torch.apps.infer instead") from e

    from .infer import load_pipeline

    cfg = PipelineConfig()
    # the UI passes steps, merge step and guidance with every request
    pipe = load_pipeline(argparse.Namespace(**{
        **vars(args), "steps": cfg.num_inference_steps,
        "start_merge_step": cfg.start_merge_step,
        "guidance_scale": cfg.guidance_scale}))
    build_interface(pipe).launch(server_port=args.port)
    return pipe


if __name__ == "__main__":
    main()
