"""BiSeNet face-parsing tools (the JAX package's apps/bisenet_tools.py;
reference models/BiSeNet/ evaluate.py:59-95, test.py:51-88, makeup.py,
prepropess_data.py), on the card unless `--device cpu` is given.

  evaluate    batched parse over a directory -> colour overlays for
              eyeballing
  makeup      parsing-guided recolouring demo (hair and lip colour)
  preprocess  CelebAMask-HQ per-part masks -> combined grey label PNGs

Without PIL: images are read by their content (PNG through utils/png.py,
JPEG through the native loader where it builds, else refused with the
reason; training/bisenet_train.read_face_image), resized with PIL's
default BICUBIC bit for bit (`resize_bicubic_uint8`), part masks made grey
with convert("L")'s fixed point (`to_grey_uint8`), and PNGs written by
utils/png.encode_png.

    python -m consistentid_torch.apps.bisenet_tools evaluate \\
        --images faces/ --out parsed/ --bisenet face_parsing.pth
"""
from __future__ import annotations

import argparse
import os

import numpy as np

# CelebAMask-HQ part file suffixes -> the 19-class label ids (the combine
# order of the reference prepropess_data.py)
CELEBA_PARTS = [
    ("skin", 1), ("l_brow", 2), ("r_brow", 3), ("l_eye", 4), ("r_eye", 5),
    ("eye_g", 6), ("l_ear", 7), ("r_ear", 8), ("ear_r", 9), ("nose", 10),
    ("mouth", 11), ("u_lip", 12), ("l_lip", 13), ("neck", 14),
    ("neck_l", 15), ("cloth", 16), ("hair", 17), ("hat", 18),
]

# reference makeup.py label ids: hair 17 is CelebA-combined; the BiSeNet
# 19-class head uses hair=6 per the FGID mapping table
MAKEUP_PARTS = {"hair": 6, "upper_lip": 12, "lower_lip": 13}


def _parser_fn(bisenet_path: str, device="cuda"):
    """(B, H, W, 3) fp32 ImageNet-normalised NHWC -> (B, H, W) uint8
    labels, the checkpoint's BiSeNet in fp32 on `device`."""
    import torch

    from ..io import convert
    from ..io.from_jax import state_from_jax
    from ..io.safetensors_reader import read_checkpoint
    from ..models.bisenet import make_face_parser

    params, stats = convert.bisenet_from_torch(read_checkpoint(bisenet_path))
    model = make_face_parser(
        state_from_jax({"params": params, "batch_stats": stats}),
        device=device).model
    dev = next(model.parameters()).device

    @torch.no_grad()
    def parse(x: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        logits = model.forward_nchw(t.permute(0, 3, 1, 2))[0]
        return logits.argmax(dim=1).to(torch.uint8).cpu().numpy()

    return parse


def _read_resized(path: str, size: int) -> np.ndarray:
    """PIL's `Image.open(p).convert("RGB").resize((size, size))`."""
    from ..training.bisenet_train import read_face_image
    from ..utils.image import resize_bicubic_uint8

    return resize_bicubic_uint8(read_face_image(path), size, size)


def _write_png(path: str, image: np.ndarray) -> None:
    from ..utils.png import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(image))


def run_evaluate(images_dir: str, out_dir: str, bisenet_path: str,
                 batch: int = 8, size: int = 512, device="cuda"):
    """Directory sweep -> colour overlays `{stem}_parsed.png` (reference
    evaluate.py/test.py); the last batch is padded with zeros."""
    from ..utils.image import imagenet_preprocess
    from .fgid import PART_COLORS, _image_paths

    parse = _parser_fn(bisenet_path, device)
    os.makedirs(out_dir, exist_ok=True)
    paths = _image_paths(images_dir)
    for start in range(0, len(paths), batch):
        chunk = paths[start:start + batch]
        ims = [_read_resized(p, size) for p in chunk]
        x = np.concatenate([imagenet_preprocess(im, size) for im in ims])
        pad = batch - len(chunk)
        if pad:
            x = np.concatenate([x, np.zeros((pad, size, size, 3),
                                            np.float32)])
        labels = parse(x)[:len(chunk)]
        for p, im, lab in zip(chunk, ims, labels):
            color = PART_COLORS[np.clip(lab, 0, len(PART_COLORS) - 1)]
            overlay = (0.4 * im + 0.6 * color).astype(np.uint8)
            stem = os.path.splitext(os.path.basename(p))[0]
            _write_png(os.path.join(out_dir, f"{stem}_parsed.png"), overlay)
    print(f"evaluated {len(paths)} images -> {out_dir}")


def recolor(image: np.ndarray, labels: np.ndarray, part: str,
            color, alpha: float = 0.7) -> np.ndarray:
    """Parsing-guided recolouring (reference makeup.py hair/lip demo):
    blend `color` into the pixels of `part`."""
    out = image.astype(np.float32).copy()
    mask = labels == MAKEUP_PARTS[part]
    tint = np.asarray(color, np.float32)
    out[mask] = out[mask] * (1 - alpha) + tint * alpha
    return out.astype(np.uint8)


def run_makeup(image_path: str, out_path: str, bisenet_path: str,
               hair_color=(30, 30, 160), lip_color=(160, 30, 60),
               device="cuda"):
    from ..utils.image import imagenet_preprocess

    parse = _parser_fn(bisenet_path, device)
    arr = _read_resized(image_path, 512)
    labels = parse(imagenet_preprocess(arr, 512))[0]
    arr = recolor(arr, labels, "hair", hair_color)
    arr = recolor(arr, labels, "upper_lip", lip_color)
    arr = recolor(arr, labels, "lower_lip", lip_color)
    _write_png(out_path, arr)
    print(f"saved {out_path}")


def run_preprocess_celeba(mask_root: str, out_dir: str,
                          num_images: int = 30000):
    """Combine CelebAMask-HQ per-part binary masks
    (`{idx // 2000}/{idx:05d}_{part}.png`) into grey label PNGs
    `{idx}.png` (reference prepropess_data.py:1-37)."""
    from ..utils.image import to_grey_uint8
    from ..utils.png import read_array

    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for idx in range(num_images):
        folder = os.path.join(mask_root, str(idx // 2000))
        label = np.zeros((512, 512), np.uint8)
        found = False
        for part, value in CELEBA_PARTS:
            p = os.path.join(folder, f"{idx:05d}_{part}.png")
            if os.path.exists(p):
                m = to_grey_uint8(read_array(p))
                label[m == 225] = value
                label[m == 255] = value
                found = True
        if found:
            _write_png(os.path.join(out_dir, f"{idx}.png"), label)
            done += 1
    print(f"combined {done} label maps -> {out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("evaluate")
    e.add_argument("--images", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--bisenet", required=True)
    e.add_argument("--batch", type=int, default=8)
    m = sub.add_parser("makeup")
    m.add_argument("--image", required=True)
    m.add_argument("--out", required=True)
    m.add_argument("--bisenet", required=True)
    for sp in (e, m):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no fallback between "
                             "them")
    c = sub.add_parser("preprocess")
    c.add_argument("--mask-root", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--num-images", type=int, default=30000)
    args = p.parse_args(argv)
    if args.cmd == "evaluate":
        run_evaluate(args.images, args.out, args.bisenet, args.batch,
                     device=args.device)
    elif args.cmd == "makeup":
        run_makeup(args.image, args.out, args.bisenet, device=args.device)
    else:
        run_preprocess_celeba(args.mask_root, args.out, args.num_images)


if __name__ == "__main__":
    main()
