"""FGID dataset production (the JAX package's apps/fgid.py; reference
data/FGID.sh with FGID_mask.py, FGID_caption.py, FGID_faceid_embeds.py and
FGID_fuse_JSON.py), on the card unless `--device cpu` is given:

  mask     BiSeNet parse over the image tree in batches -> resized copy,
           grey mask PNG, colour overlay PNG, per-image JSON stub
  caption  facial captions from a pluggable captioner: the in-repo LLaVA-1.5
           (--captioner-llava DIR), an external worker or endpoint, or the
           reference's fixed template
  faceid   ArcFace embeddings in batches -> .bin + JSON field
  fuse     merge the per-image JSONs -> the JSON_all.json manifest that
           training/dataset.py's FGIDDataset and apps/precompute.py read

    python -m consistentid_torch.apps.fgid mask --images DIR --out OUT \\
        --bisenet face_parsing.pth
    python -m consistentid_torch.apps.fgid caption --images DIR --out OUT \\
        --captioner-llava llava-1.5-7b-hf --batch 4
    python -m consistentid_torch.apps.fgid faceid --images DIR --out OUT \\
        --arcface arcface.onnx
    python -m consistentid_torch.apps.fgid fuse --out OUT

Images are decoded by the native loader (native/fgid_loader.cpp through
io/native_loader.py: JPEG and PNG) where it builds, else by the port's
numpy path (PNG only, PIL's BILINEAR bit for bit, the counterpart of the
JAX package's PIL route); the route is printed. Output PNGs are written
with utils/png.encode_png.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Optional

import numpy as np

FACE_CAPTION_TEMPLATE = (
    "The person has one face, one nose, two eyes, two ears, and one mouth.")

PART_COLORS = np.array([
    [0, 0, 0], [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 0, 85],
    [255, 0, 170], [0, 0, 255], [85, 0, 255], [170, 0, 255], [0, 255, 85],
    [0, 255, 0], [0, 255, 170], [85, 255, 0], [170, 255, 0], [0, 85, 255],
    [0, 170, 255], [255, 255, 0], [255, 0, 255], [255, 85, 255],
    [255, 255, 85],
], np.uint8)


def _image_paths(root: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".webp")
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(exts):
                out.append(os.path.join(dirpath, f))
    return out


def _json_path(out_dir: str, image_path: str) -> str:
    stem = os.path.splitext(os.path.basename(image_path))[0]
    return os.path.join(out_dir, "json", f"{stem}.json")


def _update_json(out_dir: str, image_path: str, fields: dict):
    path = _json_path(out_dir, image_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data.update(fields)
    with open(path, "w") as f:
        json.dump(data, f)


def _numpy_batches(paths: List[str], height: int, width: int,
                   batch_size: int, mean, std, center_crop: bool):
    """The numpy route: PNG (or .npy) decode, PIL's crop and BILINEAR
    resize, normalization in fp32, as the JAX package's PIL route. A file
    that does not decode (a JPEG, say) is skipped with its reason."""
    from ..utils.image import resize_bilinear_uint8
    from ..utils.png import read_image

    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        batch = np.zeros((batch_size, height, width, 3), np.float32)
        ok = np.zeros((batch_size,), bool)
        for i, p in enumerate(chunk):
            try:
                im = read_image(p)
            except (OSError, ValueError) as e:
                print(f"skipped {p}: {e}")
                continue
            if center_crop:
                h, w = im.shape[:2]
                side = min(w, h)
                top, left = (h - side) // 2, (w - side) // 2
                im = im[top:top + side, left:left + side]
            im = resize_bilinear_uint8(im, height, width)
            batch[i] = (np.asarray(im, np.float32) / 255.0 - mean_a) / std_a
            ok[i] = True
        yield chunk, batch, ok


def _decoded_batches(paths: List[str], height: int, width: int,
                     batch_size: int, mean, std, center_crop: bool = False,
                     threads: int = 4):
    """Yield (path_chunk, (B, H, W, 3) fp32 normalized, ok flags): the C++
    worker pool (native/fgid_loader.cpp) decodes, resizes and normalizes
    off the Python thread in path order; the numpy route where it did not
    build. The route is printed."""
    from ..io import native_loader

    print(f"decode route: {native_loader.route()}")
    if native_loader.get_lib() is None:
        yield from _numpy_batches(paths, height, width, batch_size, mean,
                                  std, center_crop)
        return
    loader = native_loader.NativeImageLoader(
        paths, height, width, batch_size, threads=threads, mean=mean,
        std=std, center_crop=center_crop)
    try:
        for b in loader:
            yield (paths[b.start:b.start + batch_size], b.images, b.ok)
    finally:
        loader.close()


def run_mask(images_dir: str, out_dir: str, bisenet_path: str,
             batch_size: int = 8, size: int = 512, device="cuda"):
    """Batched BiSeNet parsing over the image tree (argmax on `device`)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ..pipelines.loading import load_face_stack
    from ..utils.image import IMAGENET_MEAN, IMAGENET_STD
    from ..utils.png import encode_png

    parser, _ = load_face_stack(bisenet_path=bisenet_path, device=device)
    model = parser.model
    device = next(model.parameters()).device

    @torch.no_grad()
    def parse_batch(x: np.ndarray) -> np.ndarray:
        logits = model.forward_nchw(
            torch.from_numpy(x).to(device).permute(0, 3, 1, 2))[0]
        return logits.argmax(dim=1).to(torch.uint8).cpu().numpy()

    paths = _image_paths(images_dir)
    for d in ("resize", "mask", "color", "json"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    def save_outputs(p, rgb_uint8, lab):
        stem = os.path.splitext(os.path.basename(p))[0]
        color = PART_COLORS[np.clip(lab, 0, len(PART_COLORS) - 1)]
        overlay = (0.4 * rgb_uint8 + 0.6 * color).astype(np.uint8)
        for sub, img in (("resize", rgb_uint8), ("mask", lab),
                         ("color", overlay)):
            with open(os.path.join(out_dir, sub, f"{stem}.png"), "wb") as f:
                f.write(encode_png(img))
        _update_json(out_dir, p, {
            "image_path": os.path.join("resize", f"{stem}.png"),
            "parsing_mask_path": os.path.join("mask", f"{stem}.png"),
        })

    # three PNGs an image: off the CPU the saves of batch i overlap the
    # parse of batch i + 1 (zlib releases the GIL; each task writes only
    # its own image's files); on the CPU they would take the parse's cores
    pool = ThreadPoolExecutor(max_workers=8) if device.type != "cpu" \
        else None
    n_done = n_failed = 0
    futures = []
    try:
        for chunk, batch, ok in _decoded_batches(
                paths, size, size, batch_size,
                mean=tuple(IMAGENET_MEAN.reshape(-1)),
                std=tuple(IMAGENET_STD.reshape(-1))):
            labels = parse_batch(batch)[:len(chunk)]
            for i, (p, lab) in enumerate(zip(chunk, labels)):
                if not ok[i]:
                    n_failed += 1
                    continue
                rgb = np.clip(
                    (batch[i] * IMAGENET_STD + IMAGENET_MEAN) * 255.0,
                    0, 255).astype(np.uint8)
                if pool is not None:
                    futures.append(pool.submit(save_outputs, p, rgb, lab))
                else:
                    save_outputs(p, rgb, lab)
                n_done += 1
        for f in futures:
            f.result()  # surface encode errors
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    print(f"parsed {n_done} images" +
          (f" ({n_failed} failed decodes skipped)" if n_failed else ""))


def run_caption(images_dir: str, out_dir: str,
                captioner: Optional[Callable] = None,
                batch_size: int = 1, write: bool = True):
    """Caption stage; captioner(image_path) -> (caption, facial_caption).
    The default emits the fixed template of the reference's inference path
    (pipline_StableDiffusion_ConsistentID.py:284).

    batch_size > 1 on a batch-capable captioner (LlavaCaptioner
    .caption_batch) stacks images through one decode per prompt; the last
    short chunk is padded by repeating its last image, so every call has
    one batch shape. write=False captions without writing (a
    tensor-parallel rank other than 0)."""
    update = _update_json if write else (lambda *a: None)
    paths = _image_paths(images_dir)
    batched = batch_size > 1 and hasattr(captioner, "caption_batch")
    if batched:
        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
            results = captioner.caption_batch(padded)[: len(chunk)]
            for p, (caption, detail) in zip(chunk, results):
                update(out_dir, p, {
                    "vqa_llva": caption,
                    "vqa_llva_more_face_detail": detail})
        print(f"captioned {len(paths)} images (batch {batch_size})")
        return
    for p in paths:
        if captioner is not None:
            caption, detail = captioner(p)
        else:
            caption, detail = "a photo of a person.", FACE_CAPTION_TEMPLATE
        update(out_dir, p, {"vqa_llva": caption,
                                  "vqa_llva_more_face_detail": detail})
    print(f"captioned {len(paths)} images")


def run_faceid(images_dir: str, out_dir: str, arcface_path: str,
               batch_size: int = 32, device="cuda"):
    """Batched ArcFace embeddings -> .bin files + JSON fields."""
    import torch

    from ..models.arcface import normalized_embedding
    from ..pipelines.loading import load_face_stack

    _, embedder = load_face_stack(arcface_path=arcface_path, device=device)
    model = embedder.model
    device = next(model.parameters()).device
    in_size = model.input_size

    @torch.no_grad()
    def embed_batch(x: np.ndarray) -> np.ndarray:
        return normalized_embedding(
            model(torch.from_numpy(x).to(device))).cpu().numpy()

    os.makedirs(os.path.join(out_dir, "faceid"), exist_ok=True)
    paths = _image_paths(images_dir)
    n_done = n_failed = 0
    # x/127.5 - 1 == (x/255 - 0.5)/0.5; center-crop-to-square like the
    # reference's pre-aligned FGID assumption
    for chunk, batch, ok in _decoded_batches(
            paths, in_size, in_size, batch_size,
            mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), center_crop=True):
        embeds = embed_batch(batch)[:len(chunk)]
        for i, (p, e) in enumerate(zip(chunk, embeds)):
            if not ok[i]:
                n_failed += 1
                continue
            stem = os.path.splitext(os.path.basename(p))[0]
            bin_path = os.path.join(out_dir, "faceid", f"{stem}.bin")
            e.astype(np.float32).tofile(bin_path)
            _update_json(out_dir, p, {
                "faceid_path": os.path.join("faceid", f"{stem}.bin")})
            n_done += 1
    print(f"embedded {n_done} images" +
          (f" ({n_failed} failed decodes skipped)" if n_failed else ""))


def run_fuse(out_dir: str):
    """Merge per-image JSONs into the training manifest
    (reference data/FGID_fuse_JSON.py:16-31)."""
    json_dir = os.path.join(out_dir, "json")
    merged = {}
    for name in sorted(os.listdir(json_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(json_dir, name)) as f:
            merged[os.path.splitext(name)[0]] = json.load(f)
    with open(os.path.join(out_dir, "JSON_all.json"), "w") as f:
        json.dump(merged, f)
    print(f"fused {len(merged)} entries -> JSON_all.json")


def _caption(args) -> None:
    """The caption stage of the parsed flags (one rank of --tp N: every
    rank decodes, rank 0 writes)."""
    from ..conditioning.captioner import make_captioner

    captioner = make_captioner(args.captioner_cmd, args.captioner_url,
                               args.captioner_llava, quant=args.quant,
                               tp=args.tp, kv_quant=args.kv_quant,
                               device=args.device)
    mesh = getattr(captioner, "mesh", None)
    try:
        run_caption(args.images, args.out, captioner,
                    batch_size=args.batch,
                    write=mesh is None or mesh.is_main)
    finally:
        if hasattr(captioner, "close"):
            captioner.close()


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="stage", required=True)
    for stage in ("mask", "caption", "faceid", "fuse"):
        sp = sub.add_parser(stage)
        if stage != "fuse":
            sp.add_argument("--images", required=True)
            sp.add_argument("--device", default="cuda",
                            help="cuda (default) or cpu; no fallback "
                                 "between them")
        sp.add_argument("--out", required=True)
        if stage == "mask":
            sp.add_argument("--bisenet", required=True)
            sp.add_argument("--batch-size", type=int, default=8)
        if stage == "caption":
            sp.add_argument("--captioner-cmd", default=None,
                            help="external VLM worker command (JSONL "
                                 "stdin/stdout protocol, see conditioning."
                                 "captioner.SubprocessCaptioner)")
            sp.add_argument("--captioner-url", default=None,
                            help="external VLM HTTP endpoint")
            sp.add_argument("--captioner-llava", default=None,
                            help="HF llava-1.5 checkpoint dir (safetensors "
                                 "shards + tokenizer.json) for the in-repo "
                                 "LLaVA captioner (conditioning.captioner."
                                 "LlavaCaptioner)")
            sp.add_argument("--batch", type=int, default=1,
                            help="images per decode for batch-capable "
                                 "captioners (LlavaCaptioner)")
            sp.add_argument("--quant", default="none",
                            choices=("none", "int8"),
                            help="LlavaCaptioner decoder weights: int8 "
                                 "halves the weight bytes read per decoded "
                                 "token")
            sp.add_argument("--tp", type=int, default=1,
                            help="tensor-parallel degree of the "
                                 "LlavaCaptioner decoder: N ranks, one card "
                                 "each (LOCAL_RANK %% cards), started here "
                                 "unless under torchrun; rank 0 writes")
            sp.add_argument("--kv-quant", action="store_true",
                            help="int8 KV cache for the LlavaCaptioner")
        if stage == "faceid":
            sp.add_argument("--arcface", required=True)
            sp.add_argument("--batch-size", type=int, default=32)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.stage == "mask":
        run_mask(args.images, args.out, args.bisenet, args.batch_size,
                 device=args.device)
    elif args.stage == "caption":
        if args.tp > 1 and not args.captioner_llava:
            p.error("--tp splits the in-repo LLaVA: give --captioner-llava")
        if args.tp > 1 and "WORLD_SIZE" not in os.environ:
            import torch

            from ..parallel import launch
            launch(_caption, args.tp, args,
                   device_type=torch.device(args.device).type)
        else:
            _caption(args)
    elif args.stage == "faceid":
        run_faceid(args.images, args.out, args.arcface, args.batch_size,
                   device=args.device)
    elif args.stage == "fuse":
        run_fuse(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
