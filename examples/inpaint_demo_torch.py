"""ConsistentID inpainting on PyTorch: the PyTorch twin of
examples/inpaint_demo.py (reference demo/inpaint_demo.py:50-97), on the
card unless `--device cpu` is given.

Regenerates the masked region of an image while preserving the reference
identity. Runs end to end with no downloads: without --base it writes a
complete tiny reference-layout checkpoint set
(consistentid_torch.apps.validate.synthesize) into a temporary directory
and drives the real load path (load_sd15_consistentid with
pipeline_cls=ConsistentIDInpaintPipeline). Point --base/--consistentid
at real checkpoint dumps and pass --full-size for full-size results; the
code path is the same.

The synthetic route injects a parsing map and a zero FaceID embedding.
The --image route reads the identity photo, the image to inpaint and the
mask (PNG or .npy; JPEG is refused, as everywhere in the port) and parses
the face with --bisenet, which it requires (the JAX example loads no face
parser there, so that route cannot run); --arcface and --scrfd embed the
face, else the embedding is zero, as in the JAX pipeline.

    python examples/inpaint_demo_torch.py              # tiny, synthesized
    python examples/inpaint_demo_torch.py --base /ckpt/sd15 \
        --consistentid ConsistentID-v1.bin \
        --image-encoder image_encoder.safetensors \
        --bisenet face_parsing.pth --arcface w600k_r50.onnx \
        --image face.png --init-image room.png --mask-image mask.png \
        --full-size
"""
import argparse
import contextlib
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synthetic_inputs(size=64):
    """Deterministic stand-ins for the reference demo's URL placeholders
    (demo/inpaint_demo.py:23-26): a face, an image to inpaint, a centre
    mask and a parsing map, the JAX example's at 64 px, its regions scaled
    with `size`."""
    rng = np.random.RandomState(0)
    face = rng.randint(0, 255, (size, size, 3), np.uint8)
    init = rng.randint(0, 255, (size, size, 3), np.uint8)
    mask = np.zeros((size, size), np.uint8)
    mask[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = 255

    def px(v):
        return v * size // 64

    labels = np.zeros((size, size), np.uint8)
    labels[px(10):size - px(14), px(10):size - px(10)] = 1     # skin
    labels[px(16):px(22), px(14):px(26)] = 4                   # eyes
    labels[px(26):px(32), px(28):px(36)] = 10                  # nose
    labels[px(36):px(42), px(22):px(40)] = 12                  # mouth
    return face, init, mask, labels


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--base", default=None, help="SD1.5 diffusers dump")
    p.add_argument("--consistentid", default=None)
    p.add_argument("--image-encoder", default=None)
    p.add_argument("--bisenet", default=None,
                   help="face_parsing.pth; required with --image")
    p.add_argument("--arcface", default=None, help="w600k_r50.onnx / .pt")
    p.add_argument("--scrfd", default=None, help="det_10g.onnx / .pt")
    p.add_argument("--image", default=None,
                   help="identity photo (.png or .npy)")
    p.add_argument("--init-image", default=None, help="image to inpaint")
    p.add_argument("--mask-image", default=None,
                   help="white = regenerate, black = keep")
    p.add_argument("--prompt",
                   default="photo of a person in a library, bookshelves")
    p.add_argument("--negative-prompt", default="blurry, deformed")
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--out", default="inpaint_out.png")
    p.add_argument("--full-size", action="store_true",
                   help="full SD1.5 config (needs real checkpoints)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return p


def main():
    p = build_parser()
    args = p.parse_args()
    if args.image and not (args.bisenet and args.init_image
                           and args.mask_image):
        p.error("--image needs --bisenet (its face is parsed), "
                "--init-image and --mask-image")
    if not args.image and (args.init_image or args.mask_image):
        p.error("--init-image and --mask-image belong to the --image "
                "route; without --image every input is synthetic")

    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import ConsistentIDInpaintPipeline
    from consistentid_torch.pipelines.loading import load_sd15_consistentid
    from consistentid_torch.utils.png import encode_png, read_array, read_image

    tiny = not args.full_size
    h = w = 64 if tiny else 512
    steps = args.steps or (4 if tiny else 50)
    with contextlib.ExitStack() as stack:
        if args.base is None:
            from consistentid_torch.apps.validate import synthesize
            outdir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="consistentid_synth_"))
            print(f"synthesizing tiny reference-layout checkpoints -> "
                  f"{outdir}")
            paths = synthesize(outdir)
            args.base = paths["base"]
            args.consistentid = paths["consistentid"]
            args.image_encoder = paths["image_encoder"]

        kw = {}
        if tiny:
            from consistentid_torch.conditioning import SimpleTokenizer
            from consistentid_torch.testing import tiny_bundle
            kw["bundle"] = tiny_bundle(device=args.device)
            kw["tokenizer"] = SimpleTokenizer()
        pipe = load_sd15_consistentid(
            args.base, consistentid_path=args.consistentid,
            image_encoder_path=args.image_encoder, bisenet_path=args.bisenet,
            arcface_path=args.arcface, scrfd_path=args.scrfd,
            pipeline_cls=ConsistentIDInpaintPipeline,
            pipeline_config=PipelineConfig(
                height=h, width=w, num_inference_steps=steps,
                start_merge_step=max(1, steps * 3 // 5)),
            device=args.device, **kw)

    labels = faceid = None
    if args.image:
        face = read_image(args.image)
        init = read_image(args.init_image)
        mask = read_array(args.mask_image)
    else:
        face, init, mask, labels = synthetic_inputs(h)
        faceid = np.zeros((1, pipe.bundle.adapter_config.id_embeddings_dim),
                          np.float32)

    img = pipe.generate(
        args.prompt, face, init, mask, strength=args.strength,
        negative_prompt=args.negative_prompt, seed=2024,
        parsing_labels=labels, faceid_embeds=faceid)
    with open(args.out, "wb") as f:
        f.write(encode_png(img[0]))
    print(f"wrote {args.out}  shape={img.shape}  std={img.std():.1f}")
    return pipe


if __name__ == "__main__":
    main()
