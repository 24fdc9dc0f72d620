"""CLI: the full FGIS evaluation protocol (15 identities x 45 prompts, plus
optional style templates) through eval.runner.run_sweep (the JAX
package's apps/eval_sweep.py), on the card unless `--device cpu` is given.

Reference protocol: evaluation/EvaluationIMGs_stars_prompts.csv (675 rows)
crossed with evaluation/style_template.py's 16 styles; the reference ships
the CSV but no runner or scoring code:

    # real weights / real CSV (identity images as PNG or .npy)
    python -m consistentid_torch.apps.eval_sweep --base /ckpt/sd15 \
        --csv EvaluationIMGs_stars_prompts.csv --image-root imgs/ \
        --output-dir sweep_out --batch-size 4

    # protocol-scale self-test (synthetic 15x45, tiny random weights, CPU)
    python -m consistentid_torch.apps.eval_sweep --tiny --device cpu \
        --synthesize-protocol --output-dir /tmp/sweep --batch-size 8

Rows are round-robin shardable over processes (--shard-index /
--num-shards), and batched through generate_batch so each batch on the
device carries batch-size rows.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--csv", help="Image_Name,Prompt protocol CSV")
    p.add_argument("--image-root", default="",
                   help="directory with the identity images")
    p.add_argument("--base", help="diffusers SD1.5 dump dir")
    p.add_argument("--consistentid", help="ConsistentID-v1.bin")
    p.add_argument("--image-encoder")
    p.add_argument("--bisenet")
    p.add_argument("--arcface")
    p.add_argument("--scrfd")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--styles", choices=["default", "all"], default="default",
                   help="cross rows with all 16 style templates or run the "
                        "default style only (the 675-row core protocol)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--no-save-images", action="store_true",
                   help="score without writing the generated PNGs")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight bundle (protocol-scale smoke: "
                        "exercises the report plumbing at full row count "
                        "without real weights)")
    p.add_argument("--synthesize-protocol", action="store_true",
                   help="fabricate the 15-identity x 45-prompt protocol "
                        "(synthetic faces + prompt grid) when no --csv")
    p.add_argument("--limit", type=int, default=None,
                   help="truncate the row list (quick checks)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return p


def synthesize_protocol(outdir: str, n_identities: int = 15,
                        n_prompts: int = 45):
    """Fabricate the protocol shape: N synthetic identity portraits (PNG)
    and an Image_Name,Prompt CSV with N x M rows (the reference CSV's
    schema)."""
    import numpy as np

    from ..utils.png import encode_png

    os.makedirs(outdir, exist_ok=True)
    activities = [
        "reading a book", "playing the guitar", "riding a horse",
        "holding a cup of coffee", "wearing a red sweater",
        "in a snowy forest", "at the beach at sunset", "as an astronaut",
        "painting a portrait", "cooking dinner", "laughing",
        "wearing sunglasses", "in a library", "under cherry blossoms",
        "playing chess",
    ]
    details = ["close-up portrait", "upper body shot", "profile view"]
    prompts = [f"a person {a}, {d}" for a in activities for d in details]
    if len(prompts) != n_prompts:
        raise ValueError(f"the prompt grid has {len(prompts)} prompts, "
                         f"not {n_prompts}")
    names = []
    for i in range(n_identities):
        rng = np.random.RandomState(100 + i)
        img = rng.randint(0, 255, (64, 64, 3), np.uint8)
        # blocky synthetic "face" so the parser finds regions
        img[16:48, 16:48] = (200, 170, 150)
        name = f"identity_{i:02d}.png"
        with open(os.path.join(outdir, name), "wb") as f:
            f.write(encode_png(img))
        names.append(name)
    csv_path = os.path.join(outdir, "protocol.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image_Name", "Prompt"])
        for name in names:
            for prompt in prompts:
                w.writerow([name, prompt])
    return csv_path


def _tiny_pipeline(args):
    """The tiny random bundle with the JAX CLI's fixed label map and
    embedder (the first 16 pixel values, scaled)."""
    import numpy as np

    from ..conditioning import SimpleTokenizer
    from ..core.config import PipelineConfig
    from ..pipelines import ConsistentIDPipeline
    from ..testing import tiny_bundle

    labels = np.zeros((64, 64), np.uint8)
    labels[16:48, 16:48] = 1
    labels[20:28, 20:30] = 4
    labels[34:42, 26:40] = 10
    return ConsistentIDPipeline(
        tiny_bundle(device=args.device), SimpleTokenizer(),
        pipeline_config=PipelineConfig(
            height=args.height or 32, width=args.width or 32,
            num_inference_steps=args.steps or 2, start_merge_step=1),
        face_parser=lambda img: labels,
        face_embedder=lambda img: np.asarray(
            np.asarray(img, np.float32).reshape(1, -1)[:, :16]) / 255.0)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from ..core.config import PipelineConfig
    from ..eval.metrics import FaceSimScorer
    from ..eval.runner import load_sweep_csv, run_sweep
    from ..eval.styles import DEFAULT_STYLE, STYLES

    os.makedirs(args.output_dir, exist_ok=True)
    if args.csv is None:
        if not args.synthesize_protocol:
            parser.error("--csv or --synthesize-protocol is needed")
        args.csv = synthesize_protocol(
            os.path.join(args.output_dir, "protocol"))
        args.image_root = os.path.dirname(args.csv)

    styles = list(STYLES) if args.styles == "all" else [DEFAULT_STYLE]
    rows = load_sweep_csv(args.csv, styles=styles)
    if args.limit:
        rows = rows[:args.limit]

    if args.tiny:
        pipe = _tiny_pipeline(args)
    else:
        from ..pipelines.loading import load_sd15_consistentid
        pipe = load_sd15_consistentid(
            args.base, consistentid_path=args.consistentid,
            image_encoder_path=args.image_encoder,
            bisenet_path=args.bisenet, arcface_path=args.arcface,
            scrfd_path=args.scrfd, device=args.device,
            pipeline_config=PipelineConfig(
                height=args.height or 512, width=args.width or 512,
                num_inference_steps=args.steps or 50))

    scorer = (FaceSimScorer(pipe.face_embedder)
              if pipe.face_embedder is not None else None)
    t0 = time.perf_counter()
    result = run_sweep(
        pipe, rows, args.image_root,
        output_dir=None if args.no_save_images else args.output_dir,
        face_sim_scorer=scorer, seed=args.seed,
        shard_index=args.shard_index, num_shards=args.num_shards,
        batch_size=args.batch_size)
    dt = time.perf_counter() - t0
    summary = {
        "rows_total": len(rows), "rows_this_shard": len(result.rows),
        "styles": len(styles), "batch_size": args.batch_size,
        "wall_s": round(dt, 1),
        "rows_per_min": round(60.0 * len(result.rows) / max(dt, 1e-9), 2),
        **result.summary(),
    }
    report_path = os.path.join(
        args.output_dir, f"sweep_summary_shard{args.shard_index}.json")
    with open(report_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
