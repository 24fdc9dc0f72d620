"""FGIS evaluation sweep runner (the JAX package's eval/runner.py).

Drives the reference's benchmark protocol: an identities x prompts CSV
(the schema of evaluation/EvaluationIMGs_stars_prompts.csv:
Image_Name,Prompt) crossed with style templates, scored with FaceSim /
CLIP-T. Rows are round-robin sharded over processes via
`shard_index` / `num_shards`. Reference images are read as PNG or .npy
(`utils.png.read_image`; a JPEG raises), outputs written as PNG.
"""
from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..utils.png import encode_png, read_image
from .styles import DEFAULT_STYLE, apply_style


@dataclass
class SweepRow:
    image_name: str
    prompt: str
    style: str = DEFAULT_STYLE


def load_sweep_csv(path: str, styles: Optional[List[str]] = None
                   ) -> List[SweepRow]:
    rows: List[SweepRow] = []
    with open(path) as f:
        for rec in csv.DictReader(f):
            for style in (styles or [DEFAULT_STYLE]):
                rows.append(SweepRow(rec["Image_Name"], rec["Prompt"], style))
    return rows


@dataclass
class SweepResult:
    rows: List[Dict] = field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        if not self.rows:
            return {}
        keys = [k for k in self.rows[0] if isinstance(self.rows[0][k], float)]
        return {f"mean_{k}": sum(r[k] for r in self.rows) / len(self.rows)
                for k in keys}


def run_sweep(
    pipeline,
    rows: List[SweepRow],
    image_root: str,
    output_dir: Optional[str] = None,
    face_sim_scorer: Optional[Callable] = None,
    clip_t_scorer: Optional[Callable] = None,
    seed: int = 2024,
    shard_index: int = 0,
    num_shards: int = 1,
    batch_size: int = 1,
    **generate_kwargs,
) -> SweepResult:
    """Generate and score every (identity, prompt, style) row of this
    shard. batch_size > 1 stacks distinct rows through
    pipeline.generate_batch (one batch on the device per chunk)."""
    result = SweepResult()
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    my_rows = [(i, r) for i, r in enumerate(rows)
               if i % num_shards == shard_index]

    for start in range(0, len(my_rows), batch_size):
        chunk = my_rows[start:start + batch_size]
        ref_images, prompts, negatives = [], [], []
        for _, row in chunk:
            ref_images.append(
                read_image(os.path.join(image_root, row.image_name)))
            p, n = apply_style(row.style, row.prompt)
            prompts.append(p)
            negatives.append(n)
        t0 = time.perf_counter()
        if len(chunk) == 1:
            imgs = pipeline.generate(prompts[0], ref_images[0],
                                     negative_prompt=negatives[0], seed=seed,
                                     **generate_kwargs)
        else:
            imgs = pipeline.generate_batch(prompts, ref_images,
                                           negative_prompts=negatives,
                                           seed=seed, **generate_kwargs)
        dt = (time.perf_counter() - t0) / len(chunk)
        for (i, row), ref_image, img in zip(chunk, ref_images, imgs):
            rec: Dict = {"image_name": row.image_name, "prompt": row.prompt,
                         "style": row.style, "latency_s": float(dt)}
            if face_sim_scorer is not None:
                rec["face_sim"] = float(face_sim_scorer(ref_image, img))
            if clip_t_scorer is not None:
                rec["clip_t"] = float(clip_t_scorer(row.prompt, img))
            if output_dir:
                name = f"{os.path.splitext(row.image_name)[0]}_{i:05d}.png"
                with open(os.path.join(output_dir, name), "wb") as f:
                    f.write(encode_png(img))
            result.rows.append(rec)
    if output_dir:
        with open(os.path.join(output_dir,
                               f"results_shard{shard_index}.json"), "w") as f:
            json.dump({"rows": result.rows, "summary": result.summary()}, f,
                      indent=2)
    return result
