"""ConsistentID ControlNet inpainting on PyTorch: the PyTorch twin of
examples/controlnet_demo.py (reference demo/controlnet_demo.py:50-99), on
the card unless `--device cpu` is given.

Inpaints the masked region under a ControlNet spatial condition (e.g. a
pose or edge map) while preserving the reference identity. Runs end to end
with no downloads at tiny config: a synthesized checkpoint set
(consistentid_torch.apps.validate.synthesize, in a temporary directory)
loaded as plain inpainting, then wrapped with a seeded tiny ControlNet.
Its zero-initialised output convolutions make it a no-op until trained or
loaded (tests/test_torch_controlnet.py); a real ControlNet converts with
io.convert.controlnet_from_diffusers.

    python examples/controlnet_demo_torch.py            # tiny, synthesized
    python examples/controlnet_demo_torch.py --device cpu --steps 2
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--prompt",
                   default="photo of a person, cinematic lighting")
    p.add_argument("--negative-prompt", default="blurry, deformed")
    p.add_argument("--controlnet-scale", type=float, default=0.8)
    p.add_argument("--guess-mode", action="store_true",
                   help="condition the text branch only (reference "
                        "StableDIffusionControlNetInpaint :389-392)")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--out", default="controlnet_out.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    args = p.parse_args()

    from consistentid_torch.apps.validate import synthesize
    from consistentid_torch.conditioning import SimpleTokenizer
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import (
        ConsistentIDControlNetInpaintPipeline, ConsistentIDInpaintPipeline)
    from consistentid_torch.pipelines.loading import load_sd15_consistentid
    from consistentid_torch.testing import tiny_bundle, tiny_controlnet
    from consistentid_torch.utils.png import encode_png

    steps = args.steps
    cfg = PipelineConfig(height=64, width=64, num_inference_steps=steps,
                         start_merge_step=max(1, steps * 3 // 5))
    with tempfile.TemporaryDirectory(prefix="consistentid_synth_") as outdir:
        print(f"synthesizing tiny reference-layout checkpoints -> {outdir}")
        paths = synthesize(outdir)
        # the loader assembles everything but a ControlNet (it refuses the
        # ControlNet pipeline for that reason): load the base stack as
        # plain inpainting, then wrap it with the ControlNet
        base = load_sd15_consistentid(
            paths["base"], consistentid_path=paths["consistentid"],
            image_encoder_path=paths["image_encoder"],
            bundle=tiny_bundle(device=args.device),
            tokenizer=SimpleTokenizer(),
            pipeline_cls=ConsistentIDInpaintPipeline, pipeline_config=cfg,
            device=args.device)

    bundle = base.bundle
    pipe = ConsistentIDControlNetInpaintPipeline(
        bundle, SimpleTokenizer(), pipeline_config=cfg,
        controlnet=tiny_controlnet(bundle.unet_config, device=args.device,
                                   seed=1),
        controlnet_scale=args.controlnet_scale, guess_mode=args.guess_mode)

    rng = np.random.RandomState(0)
    face = rng.randint(0, 255, (64, 64, 3), np.uint8)
    init = rng.randint(0, 255, (64, 64, 3), np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 16:48] = 255
    control = (np.indices((64, 64)).sum(0) % 16 * 16).astype(np.uint8)
    labels = np.zeros((64, 64), np.uint8)
    labels[10:50, 10:54] = 1
    labels[16:22, 14:26] = 4
    labels[26:32, 28:36] = 10

    img = pipe.generate(
        args.prompt, face, init, mask, strength=1.0,
        negative_prompt=args.negative_prompt, seed=2024,
        control_image=np.repeat(control[..., None], 3, axis=-1),
        parsing_labels=labels,
        faceid_embeds=np.zeros(
            (1, bundle.adapter_config.id_embeddings_dim), np.float32))
    with open(args.out, "wb") as f:
        f.write(encode_png(img[0]))
    print(f"wrote {args.out}  shape={img.shape}  std={img.std():.1f}")
    return pipe


if __name__ == "__main__":
    main()
