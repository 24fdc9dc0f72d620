"""CLI: ConsistentID adapter training on one card (reference train.py +
train_bash.sh; the JAX package's apps/train.py), on the card unless
`--device cpu` is given.

    python -m consistentid_torch.apps.train \\
        --base /path/sd15 --image-encoder /path/vit-h.safetensors \\
        --manifest JSON_all.json --data-root /data/fgid \\
        --output-dir runs/consistentid

Resume is automatic from the latest checkpoint in --output-dir
(io/checkpoint.py). Training from a cache written by apps.precompute:
`--encoded --manifest DIR/encoded_manifest.json`. Data parallelism over
several cards (the JAX CLI's mesh and shard_batch, and its multi-host
start) waits for the port's parallel/ package on torch.distributed
(ROADMAP A item 10): this CLI trains on one device. Images and parsing
maps are PNG (or .npy); there is no JPEG decoder.
"""
from __future__ import annotations

import argparse

# the per-dispatch draws: a generator seeded from (seed, step), so a resumed
# run draws what an uninterrupted one would at the same step (the JAX CLI
# folds the step into its key)
_STEP_SEED_STRIDE = 1_000_003


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--base", default=None,
                   help="diffusers SD1.5 dir (required unless --tiny)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight bundle (tests, smoke runs): no "
                        "--base weights, every tower shrunk")
    p.add_argument("--image-encoder", default=None,
                   help="CLIP ViT-H checkpoint")
    p.add_argument("--manifest", required=True,
                   help="FGID JSON_all.json, or with --encoded the "
                        "encoded_manifest.json apps.precompute writes")
    p.add_argument("--encoded", action="store_true",
                   help="train from precomputed frozen-encoder outputs "
                        "(apps.precompute): each step skips the VAE, ViT-H "
                        "and CLIP-text forwards and samples the cached VAE "
                        "posterior")
    p.add_argument("--data-root", default="")
    p.add_argument("--tokenizer", default=None,
                   help="CLIP tokenizer dir (vocab.json + merges.txt); "
                        "default: the word-hash SimpleTokenizer")
    p.add_argument("--output-dir", default="runs/consistentid")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch-per-device", type=int, default=2)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-2)
    p.add_argument("--facial-weight", type=float, default=0.01)
    p.add_argument("--mask-loss-prob", type=float, default=0.5)
    p.add_argument("--localization-layers", type=int, default=5)
    p.add_argument("--lora-rank", type=int, default=128)
    p.add_argument("--num-tokens", type=int, default=4)
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mu-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="AdamW first-moment storage dtype (second moments "
                        "stay fp32)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 2-10 here")
    p.add_argument("--remat", choices=["full", "dots", "none"],
                   default="none",
                   help="UNet rematerialisation under autograd: 'full' "
                        "recomputes each block in the backward, 'dots' "
                        "keeps its linear layers' outputs; less memory for "
                        "more compute")
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                   help="compute dtype (trainable parameters stay fp32 "
                        "masters; bf16 is the reference's "
                        "mixed_precision=bf16)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per call of the step function "
                        "(make_multi_train_step over that many stacked "
                        "batches); batches left over at the end are "
                        "trained one step at a time")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return p


def build_bundle(args, config):
    """The SD1.5 bundle the flags describe, its UNet's IP projections
    warm-started (and its base weights loaded unless --tiny)."""
    import torch

    from ..core import AdapterConfig, sd15_unet_config
    from ..pipelines import SD15Bundle
    from ..training import warm_start_ip_projections

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    kw = dict(dtype=dtype, device=args.device, seed=config.seed)
    if args.tiny:
        from ..testing import tiny_bundle
        bundle = tiny_bundle(**kw)
        warm_start_ip_projections(bundle.unet)
    else:
        if not args.base:
            raise SystemExit("--base is required unless --tiny")
        from ..pipelines.loading import load_models
        bundle = SD15Bundle(
            unet_config=sd15_unet_config(lora_rank=args.lora_rank,
                                         ip_num_tokens=args.num_tokens),
            adapter_config=AdapterConfig(num_id_tokens=args.num_tokens),
            **kw)
        load_models(bundle, args.base, image_encoder_path=args.image_encoder)
    bundle.remat = config.remat_unet
    bundle.remat_policy = config.remat_policy
    return bundle


def main(argv=None):
    """Train; returns {"state", "restored_step", "step_times" (s per call
    of the step function), "steps_per_call" (optimizer steps in each),
    "losses"}."""
    args = build_parser().parse_args(argv)

    import os

    import numpy as np
    import torch

    from ..core import SchedulerConfig, TrainConfig
    from ..io.checkpoint import CheckpointManager
    from ..sampling import NoiseSchedule
    from ..training import (EncodedFGIDDataset, FGIDDataset,
                            consistentid_loss_encoded, create_train_state,
                            make_multi_train_step, make_train_step)
    from ..utils.profiling import MetricsLogger, StepTimer
    from .precompute import make_tokenizer

    config = TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        batch_per_device=args.batch_per_device,
        grad_accum_steps=args.grad_accum_steps,
        facial_weight=args.facial_weight,
        mask_loss_prob=args.mask_loss_prob,
        localization_layers=args.localization_layers,
        resolution=args.resolution, max_steps=args.max_steps,
        save_steps=args.save_steps, seed=args.seed,
        remat_unet=args.remat != "none",
        remat_policy="dots" if args.remat == "dots" else "full",
        mu_dtype=args.mu_dtype)
    bundle = build_bundle(args, config)
    schedule = NoiseSchedule.create(SchedulerConfig())
    state = create_train_state(bundle, config)
    ckpt = CheckpointManager(args.output_dir)
    restored_step = ckpt.latest_step()
    state = ckpt.restore(state)
    spc = max(1, args.steps_per_call)
    loss_fn = consistentid_loss_encoded if args.encoded else None
    single_step = make_train_step(bundle, schedule, config, loss_fn=loss_fn)
    step_fn = (make_multi_train_step(bundle, schedule, config, spc,
                                     loss_fn=loss_fn) if spc > 1
               else single_step)

    if args.encoded:
        dataset = EncodedFGIDDataset(args.manifest, seed=config.seed)
    else:
        dataset = FGIDDataset(
            args.manifest, make_tokenizer(args.tokenizer),
            size=args.resolution, image_root=args.data_root,
            seed=config.seed, clip_size=bundle.vision_config.image_size,
            id_dim=bundle.adapter_config.id_embeddings_dim)
    logger = MetricsLogger(args.output_dir)
    timer = StepTimer()
    device = bundle.device
    batch_size = config.batch_per_device * config.grad_accum_steps

    def generator(step):
        return torch.Generator(device).manual_seed(
            config.seed * _STEP_SEED_STRIDE + step)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run = {"state": state, "restored_step": restored_step,
           "step_times": [], "steps_per_call": [], "losses": []}

    def dispatch(fn, batch, n):
        nonlocal state
        timer.data_loaded()
        state, metrics = fn(state, batch, generator=generator(state.step))
        sync()
        timer.step_done()
        run["step_times"].append(timer.step_times[-1])
        run["steps_per_call"].append(n)
        losses = metrics["loss"].reshape(-1).tolist()
        run["losses"] += losses
        return metrics

    profiler = None
    profile_done = False

    def stop_profile():
        nonlocal profiler, profile_done
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(args.profile_dir, "trace.json"))
        profiler, profile_done = None, True

    step = state.step
    pending = []     # loader batches awaiting one multi-step call
    for batch in dataset.batches(batch_size, epochs=args.epochs):
        if step >= config.max_steps:
            break
        if args.profile_dir and step >= 2 and profiler is None \
                and not profile_done:
            # past the first steps' allocations: steps 2 to 10
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            profiler = profile(activities=acts)
            profiler.__enter__()
        if profiler is not None and step >= 10:
            stop_profile()
        if config.grad_accum_steps > 1:
            batch = {k: v.reshape(config.grad_accum_steps, -1, *v.shape[1:])
                     for k, v in batch.items()}
        if spc > 1:
            pending.append(batch)
            if len(pending) < spc:
                continue
            batch = {k: np.stack([b[k] for b in pending])
                     for k in pending[0]}
            pending = []
        prev = step
        metrics = dispatch(step_fn, batch, spc)
        step = state.step
        if step % 10 < step - prev or step % 10 == 0:
            scalar = {k: float(v.reshape(-1)[-1]) for k, v in metrics.items()}
            logger.log(step, {**scalar, **timer.summary()})
        if step // config.save_steps > prev // config.save_steps:
            ckpt.save(state)
    if profiler is not None:
        stop_profile()

    # batches still pending a multi-step call (the data ran out, or
    # max_steps cut the loop, with fewer than steps-per-call) are trained
    # one step each, so trailing data always trains
    if pending and step < config.max_steps:
        for b in pending:
            if step >= config.max_steps:
                break
            dispatch(single_step, b, 1)
            step = state.step
        logger.log(step, {"loss": run["losses"][-1],
                          "flushed_pending": len(pending)})
    ckpt.save(state)
    logger.close()
    run["state"] = state
    return run


if __name__ == "__main__":
    main()
