"""Minimal runnable ConsistentID demo on PyTorch (random weights, tiny
config): the PyTorch twin of examples/minimal_demo.py, on the card unless
`--device cpu` is given.

Shows the port's API surface without any checkpoint: build a tiny bundle,
run the SD1.5 ConsistentID pipeline on a synthetic face with an injected
parsing map and FaceID embedding, write the image as a PNG, and take one
training step. With real checkpoints use
consistentid_torch.pipelines.loading instead (README, "Usage").

    python examples/minimal_demo_torch.py
    python examples/minimal_demo_torch.py --device cpu --steps 2
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--out", default="minimal_out.png")
    args = p.parse_args()

    from consistentid_torch.conditioning import SimpleTokenizer
    from consistentid_torch.core import (PipelineConfig, SchedulerConfig,
                                         TrainConfig)
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.testing import tiny_bundle
    from consistentid_torch.training import (create_train_state,
                                             make_train_step, synthetic_batch)
    from consistentid_torch.utils.png import encode_png

    bundle = tiny_bundle(device=args.device)

    # --- inference ---
    pipe = ConsistentIDPipeline(
        bundle, SimpleTokenizer(),
        pipeline_config=PipelineConfig(
            height=64, width=64, num_inference_steps=args.steps,
            start_merge_step=max(1, args.steps // 2)))
    rng = np.random.RandomState(0)
    face = rng.randint(0, 255, (64, 64, 3), np.uint8)
    labels = np.zeros((64, 64), np.uint8)
    labels[10:40, 10:50] = 1   # Face
    labels[25:30, 28:34] = 10  # Nose
    img = pipe.generate(
        "portrait of a man with a strong face and a sharp nose", face,
        parsing_labels=labels,
        faceid_embeds=rng.randn(1, 16).astype(np.float32), seed=7)
    with open(args.out, "wb") as f:
        f.write(encode_png(img[0]))
    print("generated:", img.shape, img.dtype, "->", args.out)

    # --- one training step ---
    config = TrainConfig(localization_layers=3)
    schedule = NoiseSchedule.create(SchedulerConfig())
    state = create_train_state(bundle, config)
    step = make_train_step(bundle, schedule, config)
    batch = synthetic_batch(batch_size=2, size=32, clip_size=28, id_dim=16)
    generator = torch.Generator(args.device).manual_seed(1)
    state, metrics = step(state, batch, generator=generator)
    metrics = {k: float(v) for k, v in metrics.items()}
    print("train step:", json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
