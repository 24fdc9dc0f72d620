"""Rank functions of the port's 2-rank CPU tests (tests/test_torch_parallel
.py, tests/test_torch_bisenet_train.py), started by the port's launcher
(consistentid_torch.parallel.launch) over gloo. This module imports neither
JAX nor the JAX package: the ranks import it anew. Each function returns
numpy results (or tensors) for the test process to hold against JAX or
against the single-rank run it also makes here."""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

STEPS = 3


def _face():
    rng = np.random.RandomState(0)
    face = rng.randint(0, 255, (64, 64, 3), np.uint8)
    labels = np.zeros((64, 64), np.uint8)
    labels[10:40, 10:50] = 1
    labels[15:20, 15:25] = 4
    labels[15:20, 35:45] = 5
    labels[25:30, 28:34] = 10
    labels[33:37, 24:38] = 12
    return face, labels, rng.randn(1, 16).astype(np.float32)


def _tp_unet(inputs, mesh):
    """The tiny UNet of `inputs` (JAX's parameters carried across, LoRA
    live), LoRA folded at lora_scale, split over the model group."""
    from consistentid_torch.core.config import UNetConfig
    from consistentid_torch.models import UNet, fold_lora_params
    from consistentid_torch.parallel import tensor_parallel_unet

    cfg = UNetConfig(**inputs["unet_config"])
    folded = fold_lora_params(inputs["unet_state"], inputs["lora_scale"])
    unet = UNet(dataclasses.replace(cfg, lora_rank=0)).eval()
    unet.load_state_dict(folded)
    tp = tensor_parallel_unet(unet, mesh)
    with torch.no_grad():
        out = tp(*(torch.from_numpy(inputs[k]) for k in ("x", "t", "ctx")),
                 ip_scale=inputs["ip_scale"])
    attn = tp.down_0_attn_0.blocks_0.attn2
    return {"out": out.numpy(), "heads": attn.heads,
            "to_q": tuple(attn.to_q.weight.shape),
            "to_k_ip": tuple(attn.to_k_ip.weight.shape),
            "whole_heads": unet.down_0_attn_0.blocks_0.attn2.heads}


def _tp_llama(mesh):
    """The tiny LLaVA decoder, fp32 and int8: single-rank logits and greedy
    tokens, then the same under TP=2; and the captioner over a mesh."""
    from consistentid_torch.conditioning import captioner
    from consistentid_torch.conditioning.llama_tokenizer import LlamaTokenizer
    from consistentid_torch.models.llama import (LlamaForCausalLM,
                                                 greedy_generate,
                                                 quantize_llama_params)
    from consistentid_torch.models.llava import random_llava
    from consistentid_torch.parallel import apply_llama_tensor_parallel
    from consistentid_torch.parallel.tensor_parallel import shared_copy
    from consistentid_torch.testing import (tiny_llava_config,
                                            write_llama_tokenizer)

    cfg = tiny_llava_config()
    model = random_llava(cfg, seed=3).eval()
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        1, 500, (2, 7)).astype(np.int64))
    with torch.device("meta"):
        int8 = LlamaForCausalLM(cfg.text, quant=True)
    int8.load_state_dict(quantize_llama_params(
        cfg.text, model.llama.state_dict()), assign=True)
    out = {}
    for name, llama in (("fp32", model.llama), ("int8", int8.eval())):
        tp = apply_llama_tensor_parallel(shared_copy(llama), mesh)
        with torch.no_grad():
            for tag, m in (("one", llama), ("tp", tp)):
                out[f"{name}_{tag}_logits"] = m(ids)[0].numpy()
                out[f"{name}_{tag}_tokens"] = greedy_generate(
                    m, ids, 6, eos_token_id=511).numpy()
        out[f"{name}_kv_heads"] = tp.kv_heads
    with tempfile.TemporaryDirectory() as d:
        write_llama_tokenizer(d, vocab_size=512)
        tok = LlamaTokenizer.from_pretrained(d)
    face = _face()[0]
    for tag, m in (("one", None), ("tp", mesh)):
        cap = captioner.LlavaCaptioner(model, tok, max_new_tokens=4, mesh=m)
        out[f"caption_{tag}"] = cap.generate(face, captioner.CAPTION_PROMPT)
    return out


def _pipeline(mesh, device="cpu"):
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                            tiny_bundle)

    return ConsistentIDPipeline(
        tiny_bundle(device=device, seed=0), synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(height=64, width=64,
                                       num_inference_steps=STEPS,
                                       start_merge_step=1),
        mesh=mesh)


def _dp_generate(mesh):
    """generate (2 images of one prompt; DDIM and DDPM) and generate_batch
    (4 requests, per-request seeds), single-rank and DP=2; then two
    buckets served in lockstep (rank 0 broadcasts, rank 1 follows)."""
    from consistentid_torch.apps.serve import (LockstepPipeline,
                                               MicroBatcher, follow)

    face, labels, faceid = _face()
    faces = [np.roll(face, 7 * i, axis=1) for i in range(4)]
    prompts = [f"a photo of person {i} with blue eyes" for i in range(4)]
    kw = dict(parsing_labels=labels, faceid_embeds=faceid)
    out = {}
    for tag, m in (("one", None), ("dp", mesh)):
        pipe = _pipeline(m)
        for sched in ("ddim", "ddpm"):
            out[f"gen_{sched}_{tag}"] = pipe.generate(
                "a photo of a man", face, seed=11, num_images_per_prompt=2,
                scheduler=sched, **kw)
        out[f"batch_{tag}"] = pipe.generate_batch(
            prompts, faces, seeds=[1, 2, 3, 4],
            parsing_labels_list=[labels] * 4,
            faceid_embeds_list=[faceid] * 4)
    if mesh.is_main:
        lockstep = LockstepPipeline(pipe, mesh)
        batcher = MicroBatcher(lockstep, max_batch=3, window_ms=1.0)
        try:
            out["buckets"] = batcher.buckets
            out["lockstep"] = lockstep.generate_batch_async(
                prompts[:2], faces[:2], seeds=[1, 2],
                parsing_labels_list=[labels] * 2,
                faceid_embeds_list=[faceid] * 2)()
        finally:
            batcher.stop()
            lockstep.stop()
    else:
        out["followed"] = follow(pipe, mesh)
    return out


def _dp_train(mesh):
    """Two DP=2 train steps (each rank its 2 rows of a global batch of 4,
    its own draws) against the single-rank step with grad accumulation
    over the same two shards and draws."""
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.parallel import shard_batch
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.testing import tiny_bundle
    from consistentid_torch.training import (create_train_state, make_draws,
                                             make_train_step,
                                             synthetic_batch)

    sched = NoiseSchedule.create(SchedulerConfig())
    t_train = sched.config.num_train_timesteps
    batches = [synthetic_batch(4, 32, 28, 16, seed=s) for s in (0, 1)]

    def draws(step, rank):
        g = torch.Generator().manual_seed(1000 * step + rank)
        return make_draws(g, (2, 16, 16, 4), t_train)   # 32 px, VAE x2

    out = {}
    bundle = tiny_bundle(device="cpu", seed=2)
    state = create_train_state(bundle, TrainConfig(grad_accum_steps=2))
    step = make_train_step(bundle, sched, TrainConfig(grad_accum_steps=2))
    for i, batch in enumerate(batches):
        stacked = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}
        state, m = step(state, stacked, [draws(i, 0), draws(i, 1)])
        out[f"loss_one_{i}"] = float(m["loss"])
    out["masters_one"] = {k: v.detach().numpy().copy()
                          for k, v in state.trainable.items()}

    bundle = tiny_bundle(device="cpu", seed=2)
    state = create_train_state(bundle, TrainConfig())
    step = make_train_step(bundle, sched, TrainConfig(), mesh=mesh)
    for i, batch in enumerate(batches):
        state, m = step(state, shard_batch(mesh, batch),
                        draws(i, mesh.data_rank))
        out[f"loss_dp_{i}"] = float(m["loss"])
    out["masters_dp"] = {k: v.detach().numpy().copy()
                         for k, v in state.trainable.items()}
    return out


def parallel_cases(inputs_path: str):
    """Every 2-rank case of tests/test_torch_parallel.py, in one launch."""
    from consistentid_torch.parallel import make_mesh, world_size

    assert world_size() == 2
    inputs = torch.load(inputs_path, weights_only=False)
    out = {"env": rank_environment(),
           "tp_unet": _tp_unet(inputs, make_mesh(model=2)),
           "tp_llama": _tp_llama(make_mesh(model=2))}
    mesh = make_mesh()
    out["mesh"] = (mesh.data, mesh.model, mesh.rank, mesh.backend,
                   str(mesh.device))
    out["dp_generate"] = _dp_generate(mesh)
    out["dp_train"] = _dp_train(mesh)
    return out


def bisenet_sync_step(inputs_path: str):
    """One 2-rank SyncBN BiSeNet step from a carried JAX state, each rank
    its half of the batch: in fp32, and again in fp64 (the exactness check
    of the distributed math)."""
    from consistentid_torch.parallel import make_mesh, shard_rows, world_size
    from consistentid_torch.training.bisenet_train import (
        create_bisenet_train_state, make_bisenet_train_step)

    assert world_size() == 2
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh()
    rows = shard_rows(inputs["images"].shape[0], mesh)
    out = {}
    for dtype in (torch.float32, torch.float64):
        state = create_bisenet_train_state(device="cpu",
                                           state=inputs["state"],
                                           max_iter=100)
        state.model.to(dtype)
        state.optimizer.trace = {k: v.to(dtype)
                                 for k, v in state.optimizer.trace.items()}
        state, m = make_bisenet_train_step(mesh)(
            state, inputs["images"][rows], inputs["labels"][rows])
        tag = "" if dtype == torch.float32 else "_fp64"
        out[f"loss{tag}"] = float(m["loss"])
        out[f"state{tag}"] = {k: v.detach().numpy().copy()
                              for k, v in state.model.state_dict().items()}
        out[f"momentum{tag}"] = {k: v.numpy().copy()
                                 for k, v in state.optimizer.trace.items()}
    return out


def rank_environment():
    """What a launched rank sees (the launcher's own test)."""
    import torch.distributed as dist
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "local": os.environ["LOCAL_RANK"],
            "threads": torch.get_num_threads()}
