#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ (nvcc, sm_90a), one nvcc per source, all
     started together; log each kernel's registers, shared memory and
     spills from the ptxas report, and its wgmma and TMA instructions from
     cuobjdump where the toolkit has it;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at ragged shapes, by the relative L2 error of
     each output (each limit with a control: the plain version with one key
     or query tile dropped must read above it), and time kernel, plain
     version and the library call beside the kernel's bound: K1 at the
     serving shapes, K2 and K3 + K4 (one fused backward) at the training
     shapes. K1, K2 and K3 + K4 are checked on each of their routes (sm90
     for bf16/fp16 at the models' head dims, in fp16 too and at ragged Sq,
     Sk under one tile, head dims 64 and 128 and one batch*head; mma at
     head dim 36; f32), each call asserting the route it launched on; at
     the main shapes the mma.sync kernels they replaced are timed beside
     them; K1 also at the infer CLI's shapes (768x512) and at SDXL's
     head_dim-64 shapes (1024x1024: X1 = (2, 10, 4096, 64) at UNet level 1,
     X2 = (2, 20, 1024, 64) at level 2 and the mid block) and at the
     init-image paths' (512 px, one image: C0 = (2, 8, 4096, 40), C1 =
     (2, 8, 1024, 80));
  3b. dq order: the fused backward at the training shapes gives the same
     dq, dk, dv bits over 50 calls, alone and beside a busy stream, and is
     timed in turns against a build of its source that adds dQ in fp32 in
     arrival order (compiled beside the libraries);
  4. serving: a full-width SD1.5 ConsistentID bundle (bf16, LoRA rank 128,
     4 IP tokens, ViT-H, CLIP-L, full VAE; random weights from a seed) runs
     generate() at batch 4, 50 DDIM steps, 512 px; checks the output and
     that K1 was launched 500 times, all on the sm90 route, and K2-K6 none;
  5. serving path checks: one full-width UNet call through K1 and through
     its plain version; one UNet call under torch.profiler;
  6. training: the same bundle with fp32 trainable masters takes 1 warm-up
     and 5 timed AdamW steps of the adapter objective (batch 2, 512 px,
     synthetic batch); checks finite losses, a nonzero first gradient on
     every trainable leaf, moved trainable and bit-identical frozen
     parameters, and 10 launches each of K2 and K3 + K4, all on the sm90
     route (none of K1, K5, K6, nor of the mma.sync K3/K4) per step; one
     step under torch.profiler;
  7. training path checks: one full-width UNet forward and backward through
     K2 and K3 + K4, each of its 10 calls held against the plain versions
     on its own inputs (K3 + K4 at its own precision) and so are the LoRA
     leaves
     each call feeds, and the trainable gradients against a second pass
     through the plain versions; the tiny fp32 bundle's loss and gradients
     on the card against the CPU;
  8. the tiny fp32 bundle's generate core on the card against the CPU;
  9. K5 and K6 (fused BatchNorm + activation) against their plain versions
     at BiSeNet's stem shapes and at ragged shapes, all four activations,
     by relative L2 (controls: the last cluster's rows not summed, the last
     channels left unnormalized), K5 bit for bit against the plain moments
     summed in its order, over repeated calls and on a second stream; the
     device kernels of one call each of K5, K6 and fused_bn_act
     (torch.profiler: 1, 1, 2); K5, K6 and fused_bn_act timed beside their
     bounds and the library calls (torch.var_mean; F.batch_norm then the
     activation), each on copies of its input in turn, so that it reads
     them from HBM, with the card's own streaming ceilings (a copy of x, a
     sum of x) and its launch floor (a one-element add) in the same run;
 10. perception at full width, fp32: SCRFD-10g at 640, iresnet50 at 112,
     BiSeNet with 19 classes at 512 (random weights from a seed) on the
     face; each hook timed; the card against the CPU (TF32 off);
 11. generate from the photo alone: the serving bundle with the face parser,
     the face embedder and a full-width safety checker (ViT-L/14, 24
     layers) runs the headline request with no injected labels or
     embedding; checks 500 K1 launches on the sm90 route (none of K2-K6)
     and a (4,) flag array;
 12. load: that bundle and the perception models written as a
     reference-layout SD1.5 set (fp16) in a temporary directory, removed at
     the end, then `load_sd15_consistentid` on the card: every tensor the
     written bits after the fp16 cast;
 13. infer: `apps.infer.main` on the set at the JAX defaults (Euler, 50
     steps, 768x512, CFG 5, seed 2024) from a PNG face: a (768, 512, 3)
     PNG, 500 K1 launches on sm90, the float path finite and within one
     grey level of the PNG;
 14. samplers: the five at 8 steps, 512 px: finite, DDPM the same bits
     twice, a batch's request against the request alone (recorded);
 15. serve: `apps.serve.serve` on 127.0.0.1, buckets warmed, 6 concurrent
     requests (512 px, 50 DDIM steps) answered 200 in at least 2 batches,
     500 K1 launches per batch, a malformed body and an oversized image
     refused;
 16. SDXL: a full-width SDXL ConsistentID bundle (sdxl_unet_config with
     LoRA rank 128 and 4 IP tokens, CLIP-L and bigG, ViT-H, the SDXL VAE
     decoding in fp32; bf16, random weights from a seed) runs generate() at
     the SDXL pipeline's defaults (one image, 1024x1024, 50 DDIM steps, CFG
     7.5, merge step 30): a finite (1024, 1024, 3) image, 3500 K1 launches
     (70 per UNet call) all on sm90 and no other kernel; a level-1 and a
     level-2 self-attention of the real UNet through K1 against
     reference_attention; a batch of 2 whose request 0 is the request alone
     within one grey level; one UNet call under torch.profiler;
 17. SDXL infer: the SD1.5 dump deleted, the SDXL bundle written as a
     reference-layout SDXL set (fp16) beside the image encoder and face
     packs already written, `apps.infer.main --sdxl` at 1024x1024, CFG
     7.5 from the PNG face: a (1024, 1024, 3) PNG, 3500 K1 launches on
     sm90, the float path finite and within one grey level of the PNG.
 18. the data-to-train loop through the CLIs (before phase 16, on the
     SD1.5 set of phase 12): a corpus of 8 PNG faces at 512 px with BiSeNet
     parsing maps, FaceID embeddings and captions; `apps.precompute.main`
     encodes it on the card; `apps.train.main --encoded` takes 4 steps with
     --steps-per-call 2 and checkpoints at steps 2 and 4; a second
     `apps.train.main`, given the step-2 checkpoint, resumes to step 4 with
     the first run's masters and AdamW moments bit for bit; a pixel-path
     `apps.train.main` takes 2 steps; 10 K2 and K3 + K4 launches a step;
 19. SDXL training at full width on the bundle of phase 16 (after phase
     17): its level-1 (T1) and level-2 (T2) self-attention under autograd
     through the dispatch against fp32 autograd; then bf16 with fp32
     masters, localization over 3 layers, 1024 px, batch 1: 1 warm-up and
     3 timed steps without remat (remat "full" if that runs out of
     memory), 2 steps with remat "full"; finite losses, every trainable
     leaf moved, no frozen one; K2 and K3 + K4 70 launches a step on sm90
     (K2 104 under remat); one step under torch.profiler;
 20. remat on the SD1.5 training path (after phase 7): one step each with
     none, "full" and "dots" from one snapshot, on the same batch and
     draws; the loss within 1e-5 and the masters within rtol 2e-4, atol
     2e-6 of the step without; peak memory, time and K2 launches (15) of
     each.
 21. the init-image paths on the serving bundle (one image, 512 px, 50
     DDIM steps): img2img at strength 0.8 (400 K1 launches; at strength 1
     generate's bits), 4-channel inpainting at strength 1 (500; the final
     latents outside the mask the clean image latents bit for bit;
     generate_async's bits), a second full-width UNet with 9 input channels
     (500; built, run, freed), ControlNet inpainting with a full-width
     seeded ControlNet (700 each: scale 1 to 0.8 of the steps, guess mode;
     scale 0 within one grey level of plain inpainting; a ControlNet call
     and a UNet call profiled);
 22. DeepCache on the serving bundle (batch 4, 50 DDIM steps, 512 px): the
     split invariant at full width; cache_interval 1, 2, 3 in turns, once
     (500, 375, 335 K1 launches), s/request and drift against interval 1;
     SDXL at interval 3 inside phase 16 (1190 launches: the cached steps
     launch none);
 23. infer variants (after phase 13, on its set): `apps.infer.main
     --init-image --mask-image --strength 1.0` (500 K1 launches) and
     `--cache-interval 3` (335), at the JAX defaults.
 24. int8 (after phase 22, on the serving bundle): int8_static calibrated
     on the seeded face (8 steps, 8 int_mm launches per int8 layer); the
     headline request in bf16, int8 and int8_static in turns, once:
     s/request, stages (fold: the LoRA fold and the weight quantization),
     peak GiB, K1 500 on sm90, torch._int_mm 50 launches per int8 layer,
     the mean uint8 difference from bf16's; one full-width UNet call of
     each int8 mode under torch.profiler; DeepCache at interval 3 with int8
     (K1 335, int_mm 17 full and 33 shallow UNet calls);
 25. the int8 micro-table: Int8Conv / Int8Dense (dynamic and static,
     quantize and dequant included), the int_mm GEMM alone and bf16
     F.conv2d / F.linear at the headline's L0-L3 3x3 convolutions and L0
     to_q and GEGLU shapes, beside the int8 and bf16 bounds; int_mm held
     against the exact integer product, bit for bit;
 26. `apps.infer.main --quant int8_static --save-act-scales` (after phase
     23; it calibrates: K1 580) then `--act-scales` (K1 500): the same PNG
     bytes;
 27. `apps.serve.main --quant int8_static --calib-image` (after phase 15;
     512 px, max batch 2) answering 2 concurrent requests;
 28. SDXL int8_static inside phase 16: calibrated (8 steps), one request
     at 1024x1024 (K1 3500, int_mm 50 per int8 layer).
 29. eval and checkpoint validation (after phase 27, on the set of phase
     12): `apps.validate.main` at full width (512 px, VALIDATE_STEPS = 25
     DDIM steps) with every converter stage (each entry ok: no unconsumed
     key, no zero kernel, nothing non-finite), SD1.5 and inpaint, FaceSim
     and CLIP-T (seeded projection heads), `--sweep 4` and `--mode-sweep
     4`: the seven serving modes each scored, a warm-up and a batch-4
     request each, K1 10 a step of a request (fewer at DeepCache
     intervals 2, 3; the inpaint at strength 0.8 its 80% of the steps) on
     sm90; then `apps.eval_sweep.main --synthesize-protocol --limit 8
     --batch-size 4 --steps 25` (rows/min; K1 250 a batch). Random
     weights: the scores test the plumbing, not quality.
 30. FGID production and the LLaVA-1.5 captioner (after phase 29, on the
     set of phase 12): LLaVA-1.5-7B at full width (ViT-L/14-336 and
     Llama-2-7B, 7.06 B parameters, bf16, seeded random weights built on
     the card) written as an HF llava-hf set of bf16 shards with a
     synthetic 32000-entry tokenizer.json and loaded back through
     `LlavaCaptioner.from_pretrained` (every tensor the written bits);
     the KV cache against an uncached forward in fp32
     (LLAVA_CACHE_REL_L2); `caption_batch` at batch 1 and 4 in bf16, int8
     and int8 + kv_quant, 64 new tokens a row (decode steps replayed from
     one CUDA graph): prefill ms, decode ms/token beside the weight bytes'
     bound, tokens/s, peak GiB, int_mm 225 launches a model call under
     int8; then `apps.fgid.main` mask (batch 8) -> caption
     (--captioner-llava, --batch 4, 512 new tokens) -> faceid -> fuse over
     8 PNG faces at 512 px and `apps.precompute.main` over the fused
     JSON_all.json (images/s a stage, the decode route); the tiny fp32
     LLaVA's ids on the card against the CPU; K1-K6 launched 0 times.
 31. parallel/ on torch.distributed (after phase 30, on its LLaVA set):
     two ranks on the one card over gloo (collectives staged through host
     memory), started by the port's launcher; every rank asserts world
     size 2 and a rank that fails fails the run. The full-width SD1.5
     bundle of phase 4: one UNet call under TP=2 against world size 1
     (2% of the output's largest value, the UNet path check's bound; 4
     heads a rank at level 0), a TP=2 generate (2 images) and a DP=2
     generate_batch (4 requests), PAR_STEPS DDIM steps at 512 px, their
     uint8 difference from world size 1 recorded; LLaVA-1.5-7B from the set
     under TP=2 (16 KV heads a rank): prefill logits against world size 1
     (PAR_LLAVA_LOGITS_REL_L2) and 16 greedy tokens at batch 1, decoded
     eagerly (gloo); 3 DP=2 train
     steps (batch 2 a rank, 512 px) against one rank's grad-accumulation
     step over the same shards and draws (loss 1e-5; masters rtol 2e-4,
     atol 2e-6; deterministic); K1 10 a UNet call and K2, K3 + K4 10 a
     step a rank; then `apps.serve.main --tp 2`: one card, so no mesh and
     single-device serving (asserted), 2 requests.
 32. BiSeNet training (`bisenet_phase`): `bisenet_tools preprocess` over
     16 synthetic part-mask sets, `FaceMaskDataset` (crop 448), 5 steps at
     batch 16 (s/step, peak GiB), 2 ranks x 8 with SyncBN against the
     one-device replay 1 x 16 from the same state, `bisenet_tools evaluate`
     and `makeup` over the trained parser; K1-K6 launched 0 times.
 33. demos (`demos_phase`, after phase 15, on the set of phase 12): the
     gradio demo, `apps.demo.main` with SCRFD, ArcFace and BiSeNet, under a
     stand-in `gradio` module (the card's machine has no gradio; it stands
     for the UI toolkit only): one request through the interface's callback
     at the UI's defaults (50 DDIM steps, merge 30, CFG 5, seed 2024, 512
     px) from the 512 px face, a (512, 512, 3) uint8 image within one grey
     level of `pipe.generate` with the same arguments, K1 500 on sm90; then
     the examples' PyTorch twins through runpy with --device cuda:
     minimal_demo_torch.py and controlnet_demo_torch.py at their tiny fp32
     sizes (K1 12 and 16 on the f32 route), inpaint_demo_torch.py
     --full-size on the set from PNG files (512 px, strength 1, 50 DDIM
     steps, K1 500 on sm90); each PNG's shape checked.
Phase 9 runs after phase 3, phases 21, 22, 24, 25 and then 10 to 17 after
phase 5 (before the bundle is trained). Phase 3 holds K2 and K3 + K4 at SDXL training's T1 =
(1, 10, 4096, 64) and T2 = (1, 20, 1024, 64) too.
Kernel times on the card are `cuda_ms`: CUDA events around calls the host
queued behind a sleep kernel, so the host's time per call is not counted;
the perception networks alone are timed by the same events without the
sleep (on an H100 one iresnet50 call could not be queued behind one).
Each phase's start goes to standard error and its end, with the seconds
since the start of the run and its own, to both streams (`phase`); the
run's JSON carries the seconds of each phase as `phase_s`.
The last three lines are the kernels' JSON ({"kernels": [...]}), the
nvidia-smi reading and {"ok": true, "device": {...}}.
"""
import dataclasses
import gc
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): HBM bytes/s, dense
# bf16/fp16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, and
# special-function (exp2) results/s: 132 SMs x 16/clk x 1.83 GHz.
HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
SFU_PER_S = 3.9e12

# bound of the training UNet path check on the self-attention LoRA leaves
# K3 + K4 feeds (relative L2 of each leaf's gradient through the kernel's
# dq, dk, dv against that through the same-precision plain backward's):
# just above the 1.9e-3 read on an H100, below the controls' 0.06 (PERF.md)
UNET_LEAF_REL_L2 = 5e-3

# bound of the SDXL attention check on the hidden state's gradient: dq, dk
# and dv within the 16-bit kernel limit, carried through the bf16
# projections' backward, which rounds each product once more (bf16's unit
# roundoff 2^-8 relative); the first card reading was 4.37e-3 at T1, the
# dropped-tile controls 0.108 and more
SDXL_DX_REL_L2 = 4e-3 + 2 ** -8

PROMPT = ("portrait photo of a man with a strong face, blue eyes, a sharp "
          "nose and a wide mouth")


def log(*args):
    print(*args, flush=True)


# seconds of each phase of this run, in order (`phase`)
PHASE_S = {}
RUN_START = time.perf_counter()


def phase(name: str, fn, *args, **kw):
    """fn(*args, **kw), its start written to standard error and its end,
    with the seconds since the run began and its own, to both streams (a
    run stopped at its time limit shows where it was); the seconds kept in
    PHASE_S."""
    def stamp(what):
        return f"[{time.perf_counter() - RUN_START:.1f} s] {what}"
    print(stamp(f"start {name}"), file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    seconds = time.perf_counter() - t0
    PHASE_S[name] = PHASE_S.get(name, 0.0) + seconds
    line = stamp(f"{name}: {seconds:.1f} s")
    log(line)
    print(line, file=sys.stderr, flush=True)
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(what: str, rel: float, control, limit: float) -> None:
    """A kernel's relative L2 error against its plain version must be within
    `limit`, and the control (the plain version with one key or query tile
    dropped, read against the same plain version) above it: else the check
    could not see such a fault. control=None: no control is held."""
    if not (math.isfinite(rel) and rel <= limit
            and (control is None or limit < control)):
        raise AssertionError(
            f"{what}: relative L2 error {rel:.4g}, limit {limit:g}, control "
            f"(last key or query tile dropped) {control:.4g}")


def cuda_ms(fn, iters: int, queued: bool = True) -> float:
    """The card's time per call of fn (ms), the host's time hidden: a sleep
    kernel holds the stream while the host queues calls, which then run back
    to back between two CUDA events. (At small shapes a wrapper's host time
    is many times its kernel's.) The sleep is sized from a timed call's host
    time. If the card woke before the host had queued every call (the host
    was slow, or blocked on the stream's queue of about a thousand pending
    kernels), the reading would hold host time: the calls are then queued
    in rounds of half as many, each behind its own sleep, down to one.
    queued=False: no sleep, so the time between the events holds the
    host's waits too (for a network of hundreds of kernels a call, which
    the host may not queue behind a sleep)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not queued:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    per_round = iters
    while True:
        total_ms, done = 0.0, 0
        while done < iters:
            n = min(per_round, iters - done)
            # cycles of the sleep kernel: an H100 SXM clocks at most 1.98 GHz
            torch.cuda._sleep(int((2 * host_ms * n + 10) * 1.98e6))
            start.record()
            for _ in range(n):
                fn()
            end.record()
            woke = start.query()     # the card reached the first call already
            end.synchronize()
            if woke:
                break
            total_ms += start.elapsed_time(end)
            done += n
        if done == iters:
            return total_ms / iters
        if per_round == 1:
            raise AssertionError("the host could not queue one call within "
                                 "its sleep")
        per_round //= 2


def attention_bound(b, h, sq, sk, d, itemsize, tensor_cores, kind="fwd"):
    """Least time (ms) for one flash-attention kernel, what bounds it
    ("bytes" or "operations") and the limiter (bytes, flops or exp).
    Bytes: each input read once, each output written once. FLOPs: 4, 6, 8
    or 10 x b*h*sq*sk*d (fwd: S and PV; dq: S, dP, dQ; dkv: S, dV, dP, dK;
    bwd, K3 + K4 fused: S, dP, dV, dK, dQ). One exp per score in each
    kernel."""
    bh = b * h
    qo = bh * sq * d * itemsize         # one (sq, d) tensor
    kv = bh * sk * d * itemsize         # one (sk, d) tensor
    stat = bh * sq * 4                  # one fp32 (sq,) vector
    nbytes, mult = {
        "k1": (2 * qo + 2 * kv, 4),                     # q, k, v -> o
        "fwd": (2 * qo + 2 * kv + stat, 4),             # -> o, lse
        "dq": (3 * qo + 2 * kv + 2 * stat, 6),          # q, dO, k, v, lse,
        "dkv": (2 * qo + 4 * kv + 2 * stat, 8),         # delta -> dq | dk, dv
        "bwd": (3 * qo + 4 * kv + 2 * stat, 10),        # -> dq, dk, dv
    }[kind]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops = float(mult) * bh * sq * sk * d
    flops_ms = flops / (TENSOR_FLOPS if tensor_cores else FP32_FLOPS) * 1e3
    exp_ms = bh * sq * sk / SFU_PER_S * 1e3
    bound = max(bytes_ms, flops_ms, exp_ms)
    by = "bytes" if bound == bytes_ms else "operations"
    limiter = {bytes_ms: "bytes", flops_ms: "flops", exp_ms: "exp"}[bound]
    return bound, by, limiter


def mma_call(q, k, v, lse: bool = False):
    """A call of K1's (lse=False) or K2's mma.sync kernel on bf16/fp16 q, k,
    v, through its C entry point and not the wrapper, so no launch is
    counted: the earlier design, timed beside the sm90 kernel in one run."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    b, h, sq, d = q.shape
    code = fa._DTYPE_CODES[q.dtype]
    out = torch.empty_like(q)
    stat = torch.empty((b, h, sq), device=q.device) if lse else None
    symbol, extra = (("cid_flash_attention_forward_lse", (stat,)) if lse
                     else ("cid_flash_attention_forward", ()))
    return lambda: fa._launch(symbol, q.device, q, k, v, out, *extra, b * h,
                              sq, k.shape[2], d, 1.0 / math.sqrt(d), code)


def expected_route(dtype, d) -> str:
    """The route a K1/K2 call of this dtype and head dim must take on
    16-byte aligned inputs with the default scale."""
    import torch
    if dtype == torch.float32:
        return "f32"
    return "sm90" if d % 8 == 0 and d <= 128 else "mma"


def counted_call(wrapper, fn, route: str):
    """fn() through `wrapper`; fails unless it launched once, on `route`."""
    import torch
    before = dict(wrapper.launches_by_route)
    result = fn()
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in wrapper.launches_by_route.items()}
    if moved != {r: int(r == route) for r in moved}:
        raise AssertionError(f"{wrapper.__name__}: launches by route {moved},"
                             f" expected one on {route}")
    return result


def kernel_phase():
    import torch
    import torch.nn.functional as F
    from consistentid_torch.ops.flash_attention import (flash_attention_fwd,
                                                        flash_attention_plain)
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            KERNEL_REL_L2_FP32,
                                            drop_last_tile, rel_l2)

    gen = torch.Generator("cuda").manual_seed(0)
    # limits on the relative L2 error: consistentid_torch/testing.py;
    # iters None: held to the limit, not timed
    cases = [
        ("level0", (8, 8, 4096, 40), 4096, torch.bfloat16, 20),
        ("level1", (8, 8, 1024, 80), 1024, torch.bfloat16, 50),
        # the infer CLI's default request (768x512, one image, CFG pair)
        ("infer_level0", (2, 8, 6144, 40), 6144, torch.bfloat16, 20),
        ("infer_level1", (2, 8, 1536, 80), 1536, torch.bfloat16, 50),
        # SDXL at 1024x1024, one image (CFG pair): the self-attention of
        # UNet level 1 (X1) and of level 2 and the mid block (X2)
        ("sdxl_level1", (2, 10, 4096, 64), 4096, torch.bfloat16, 20),
        ("sdxl_level2", (2, 20, 1024, 64), 1024, torch.bfloat16, 50),
        # img2img, inpaint and ControlNet inpaint at 512 px, one image (CFG
        # pair): UNet and ControlNet levels 0 (C0) and 1 (C1)
        ("init_image_level0", (2, 8, 4096, 40), 4096, torch.bfloat16, 20),
        ("init_image_level1", (2, 8, 1024, 80), 1024, torch.bfloat16, 50),
        ("level0_fp16", (8, 8, 4096, 40), 4096, torch.float16, None),
        ("level1_fp16", (8, 8, 1024, 80), 1024, torch.float16, None),
        ("ragged_bf16_d40", (2, 3, 1000, 40), 1037, torch.bfloat16, None),
        ("ragged_fp16_d80", (2, 3, 1000, 80), 1037, torch.float16, None),
        ("short_keys_bf16", (2, 2, 300, 40), 50, torch.bfloat16, None),
        ("ragged_fp16_d64", (2, 4, 777, 64), 900, torch.float16, None),
        ("ragged_bf16_d128", (2, 2, 500, 128), 333, torch.bfloat16, None),
        ("one_head_bf16", (1, 1, 4096, 40), 4096, torch.bfloat16, None),
        ("mma_bf16_d36", (1, 2, 77, 36), 99, torch.bfloat16, None),
        ("ragged_fp32_d40", (2, 3, 1000, 40), 1037, torch.float32, 20),
        ("ragged_fp32_d64", (2, 4, 500, 64), 700, torch.float32, 20),
    ]
    rows = []
    for name, (b, h, sq, d), sk, dtype, iters in cases:
        tol = (KERNEL_REL_L2_FP32 if dtype == torch.float32
               else KERNEL_REL_L2_16BIT)
        route = expected_route(dtype, d)
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
        out = counted_call(flash_attention_fwd,
                           lambda: flash_attention_fwd(q, k, v), route)
        ref = flash_attention_plain(q, k, v)
        cut = drop_last_tile(sk)
        control = rel_l2(flash_attention_plain(q, k[:, :, :cut],
                                               v[:, :, :cut]), ref)
        err = (out.float() - ref.float()).abs().max().item()
        rel = rel_l2(out, ref)
        check(f"K1 {name} o ({route})", rel, control, tol)
        row = dict(case=name, shape=[b, h, sq, d], sk=sk,
                   dtype=str(dtype).replace("torch.", ""), route=route,
                   max_abs_err=err, rel_l2=rel, control_rel_l2=control,
                   tolerance=tol)
        timed = ""
        if iters is not None:
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters)
            mma_ms = (cuda_ms(mma_call(q, k, v), iters) if route == "sm90"
                      else None)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 3)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                             iters)
            bound, by, limiter = attention_bound(
                b, h, sq, sk, d, q.element_size(), dtype != torch.float32,
                "k1")
            row.update(ms=ms, mma_ms=mma_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       bound_limiter=limiter)
            timed = (f", kernel {ms:.4f} ms"
                     + ("" if mma_ms is None else
                        f" (mma.sync kernel {mma_ms:.4f} ms)")
                     + f", plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                     f"bound {bound:.4f} ms ({limiter})")
        rows.append(row)
        log(f"K1 {name} {b}x{h}x{sq}x{d} sk={sk} {row['dtype']} {route}: "
            f"rel_l2 {rel:.3g} (limit {tol:g}; control {control:.3g}), "
            f"max_abs_err {err:.3g}{timed}")
    return rows


def kernel_resources():
    """Each library's kernels, from the ptxas report kept beside it:
    registers per thread, static shared memory, stack and spill bytes, and
    ptxas's remarks on wgmma; where cuobjdump exists, the count of HGMMA
    (wgmma), UTMALDG (TMA load) and LDGSTS (cp.async) instructions in each
    kernel's SASS. Logged, and returned by library."""
    import re
    import shutil
    from consistentid_torch.ops import build

    beside_nvcc = Path(build.find_nvcc()).parent / "cuobjdump"
    cuobjdump = shutil.which("cuobjdump") or (
        str(beside_nvcc) if beside_nvcc.exists() else None)
    cxxfilt = shutil.which("c++filt")

    def sass_dump(item):
        lib, sources = item
        return subprocess.run(
            [cuobjdump, "-sass", str(build.library_path(lib, sources))],
            capture_output=True, text=True, timeout=300).stdout
    dumps = {}
    if cuobjdump:   # one cuobjdump a library, all started together
        with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:
            dumps = dict(zip(build.LIBRARIES, pool.map(
                sass_dump, build.LIBRARIES.items())))
    out = {}
    for lib in build.LIBRARIES:
        text = build.load_report(lib) or ""
        kernels = build.ptxas_report(text)
        names = [k["function"] for k in kernels]
        if cxxfilt and names:
            names = subprocess.run([cxxfilt], input="\n".join(names),
                                   capture_output=True, text=True,
                                   timeout=60).stdout.splitlines()
        sass = {}
        if cuobjdump:
            dump = dumps[lib]
            fn = None
            for line in dump.splitlines():
                found = re.search(r"Function : (\S+)", line)
                if found:
                    fn = found.group(1)
                    sass[fn] = dict.fromkeys(("HGMMA", "UTMALDG", "LDGSTS"), 0)
                elif fn is not None:
                    for op in sass[fn]:
                        sass[fn][op] += op in line
        rows = []
        for k, pretty in zip(kernels, names):
            short = pretty.replace("(anonymous namespace)::", "")
            short = short.split("(")[0] if "(" in short else short
            rows.append(dict(k, kernel=short, sass=sass.get(k["function"])))
            log(f"  {lib}: {short}: {k['registers']} registers, "
                f"{k['shared_bytes']} B static smem, stack {k['stack_bytes']}"
                f" B, spills {k['spill_stores']}/{k['spill_loads']} B"
                + ("" if rows[-1]["sass"] is None else
                   f", SASS {rows[-1]['sass']}"))
        remarks = [line.strip() for line in text.splitlines()
                   if "wgmma" in line.lower()]
        for line in remarks:
            log(f"  {lib}: {line}")
        out[lib] = dict(kernels=rows, wgmma_remarks=remarks)
    return out


def launch_counters():
    """The kernels' wrappers, whose .launches count their launches: K1, K2
    and K3 + K4."""
    from consistentid_torch.ops import flash_attention as fa
    return [fa.flash_attention_fwd, fa.flash_attention_lse,
            fa.flash_attention_bwd]


@contextmanager
def plain_flash():
    """Swap the plain versions in for K2 and K3 + K4 inside the autograd
    Function (on the card), so a run through it launches none of them."""
    from consistentid_torch.ops import flash_attention as fa
    saved = (fa.flash_attention_lse, fa.flash_attention_bwd)

    def bwd(q, k, v, do, lse, delta, scale=None):
        dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                  scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

    fa.flash_attention_lse = fa.flash_attention_lse_plain
    fa.flash_attention_bwd = bwd
    try:
        yield
    finally:
        fa.flash_attention_lse, fa.flash_attention_bwd = saved


def pair_call(q, k, v, do, lse, delta):
    """A call of K3's and K4's mma.sync kernels (dq, then dk and dv) on
    bf16/fp16 inputs, through their C entry points and not the wrapper, so
    no launch is counted: the earlier design, timed beside the fused sm90
    kernel in one run."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    b, h, sq, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    args = (b * h, sq, k.shape[2], d, 1.0 / math.sqrt(d),
            fa._DTYPE_CODES[q.dtype])

    def call():
        fa._launch("cid_flash_attention_backward_dq", q.device, q, k, v, do,
                   lse, delta, dq, *args)
        fa._launch("cid_flash_attention_backward_dkv", q.device, q, k, v, do,
                   lse, delta, dk, dv, *args)
    return call


def check_backward(name, q, k, v, do, lse, delta, tol):
    """K3 + K4 on one input, through its wrapper (one launch, on the route
    `expected_route` gives): dq, dk and dv against the plain backward in
    fp32 (limit `tol`) and, for 16-bit inputs, at the kernel's own precision
    (P and dS rounded to the input type; KERNEL_REL_L2_SAME_PRECISION), each
    with its dropped-tile control: the last key tile for dq, the last query
    tile for dk and dv. Returns the outputs and the readings."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import (KERNEL_REL_L2_SAME_PRECISION,
                                            drop_last_tile, rel_l2)
    route = expected_route(q.dtype, q.shape[3])
    grads = counted_call(fa.flash_attention_bwd,
                         lambda: fa.flash_attention_bwd(q, k, v, do, lse,
                                                        delta), route)
    ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    kc, qc = drop_last_tile(k.shape[2]), drop_last_tile(q.shape[2])
    ctl = (fa.flash_attention_bwd_plain(q, k[:, :, :kc], v[:, :, :kc], do,
                                        lse, delta)[0],
           # all query rows dropped (Sq under one tile): zero dk, dv
           *(fa.flash_attention_bwd_plain(q[:, :, :qc], k, v, do[:, :, :qc],
                                          lse[:, :, :qc], delta[:, :, :qc])[1:]
             if qc else (torch.zeros_like(k, dtype=torch.float32),) * 2))
    same = (fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                         round_to=q.dtype)
            if q.dtype != torch.float32 else (None,) * 3)
    rels, ctls, errs, sames = [], [], [], []
    for oname, got, want, c, s in zip(("dq", "dk", "dv"), grads, ref, ctl,
                                      same):
        if got.dtype != q.dtype or got.shape != want.shape:
            raise AssertionError(f"K3 + K4 {name} {oname}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        rel, control = rel_l2(got, want), rel_l2(c, want)
        check(f"K3 + K4 {name} {oname} ({route})", rel, control, tol)
        rels.append(rel)
        ctls.append(control)
        errs.append((got.float() - want.float()).abs().max().item())
        if s is not None:
            s_ref = s.to(q.dtype)
            s_rel = rel_l2(got, s_ref)
            check(f"K3 + K4 {name} {oname} at the kernel's precision", s_rel,
                  rel_l2(c, s_ref), KERNEL_REL_L2_SAME_PRECISION)
            sames.append(s_rel)
    return grads, dict(route=route, rel_l2=max(rels), control_rel_l2=min(ctls),
                       max_abs_err=max(errs),
                       same_precision_rel_l2=max(sames, default=None))


def train_kernel_phase():
    """K2 and K3 + K4 against their plain versions at the training shapes
    (batch 2: level 0 (2, 8, 4096, 40), level 1 (2, 8, 1024, 80), bf16; SDXL
    at 1024 px, batch 1: T1 (1, 10, 4096, 64), T2 (1, 20, 1024, 64)), at a
    ragged bf16 shape and at two ragged fp32 shapes; times of kernel,
    plain version and SDPA, at the training shapes also of the mma.sync
    kernels they replaced (K2's; K3's and K4's pair); dq's run-to-run
    difference at level 0; then both alone on the routes' edge cases
    (`k2_route_cases`, `bwd_route_cases`)."""
    import torch
    import torch.nn.functional as F
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            KERNEL_REL_L2_FP32,
                                            drop_last_tile, rel_l2)

    gen = torch.Generator("cuda").manual_seed(1)
    # limits on the relative L2 error: consistentid_torch/testing.py; lse:
    # fp32 statistics on both sides, 1e-4 absolute
    cases = [
        ("level0", (2, 8, 4096, 40), 4096, torch.bfloat16, 20),
        ("level1", (2, 8, 1024, 80), 1024, torch.bfloat16, 50),
        # SDXL training at 1024 px, batch 1: level 1, and level 2 with the
        # mid block
        ("sdxl_T1", (1, 10, 4096, 64), 4096, torch.bfloat16, 20),
        ("sdxl_T2", (1, 20, 1024, 64), 1024, torch.bfloat16, 50),
        ("ragged_bf16_d40", (2, 3, 1000, 40), 1037, torch.bfloat16, 10),
        ("ragged_fp32_d40", (2, 3, 1000, 40), 1037, torch.float32, 10),
        ("ragged_fp32_d80", (1, 4, 333, 80), 517, torch.float32, 10),
    ]
    rows = {"K2": [], "K3+K4": []}
    for name, (b, h, sq, d), sk, dtype, iters in cases:
        shape = (b, h, sq, d)
        tc = dtype != torch.float32
        tol = KERNEL_REL_L2_16BIT if tc else KERNEL_REL_L2_FP32
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in (shape, (b, h, sk, d), (b, h, sk, d), shape))
        route = expected_route(dtype, d)
        out, lse = counted_call(fa.flash_attention_lse,
                                lambda: fa.flash_attention_lse(q, k, v), route)
        ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= 1e-4:
            raise AssertionError(f"K2 {name}: lse off by {lse_err}")
        kc = drop_last_tile(sk)
        ctl_out = fa.flash_attention_lse_plain(q, k[:, :, :kc],
                                               v[:, :, :kc])[0]
        k2_rel = rel_l2(out, ref_out)
        k2_ctl = rel_l2(ctl_out, ref_out)
        check(f"K2 {name} o", k2_rel, k2_ctl, tol)
        readings = {"K2": dict(
            route=route, rel_l2=k2_rel, control_rel_l2=k2_ctl,
            max_abs_err=(out.float() - ref_out.float()).abs().max().item(),
            same_precision_rel_l2=None)}
        delta = (do.float() * ref_out.float()).sum(-1)
        grads, readings["K3+K4"] = check_backward(name, q, k, v, do, ref_lse,
                                                  delta, tol)
        main = route == "sm90" and name.startswith("level")
        readings["K2"]["mma_ms"] = (cuda_ms(mma_call(q, k, v, lse=True), iters)
                                    if main else None)
        readings["K3+K4"]["mma_ms"] = (
            cuda_ms(pair_call(q, k, v, do, ref_lse, delta), iters) if main
            else None)
        if name == "level0":
            # dq's key blocks add as fixed-point integers, exact in any
            # order: a second call gives the same bits (dq_order_phase
            # holds 50 calls, with and without a busy second stream)
            again = fa.flash_attention_bwd(q, k, v, do, ref_lse, delta)
            torch.cuda.synchronize()
            readings["K3+K4"].update(
                dq_run_to_run_rel_l2=rel_l2(again[0], grads[0]),
                dk_dv_run_to_run_equal=bool(torch.equal(again[1], grads[1])
                                            and torch.equal(again[2],
                                                            grads[2])))
            if not all(torch.equal(a, g) for a, g in zip(again, grads)):
                raise AssertionError("K3 + K4 level0: a second call gave "
                                     "other bits")
            del again
        del grads

        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        times = {
            "K2": (cuda_ms(lambda: fa.flash_attention_lse(q, k, v), iters),
                   cuda_ms(lambda: fa.flash_attention_lse_plain(q, k, v), 3),
                   cuda_ms(lambda: F.scaled_dot_product_attention(*leaves),
                           iters)),
            "K3+K4": (cuda_ms(lambda: fa.flash_attention_bwd(
                          q, k, v, do, ref_lse, delta), iters),
                      cuda_ms(lambda: fa.flash_attention_bwd_plain(
                          q, k, v, do, ref_lse, delta), 3),
                      # SDPA's backward alone (its dq, dk, dv together)
                      cuda_ms(lambda: torch.autograd.grad(
                          sdpa_out, leaves, do, retain_graph=True), iters)),
        }
        for kname, kind in (("K2", "fwd"), ("K3+K4", "bwd")):
            ms, plain_ms, lib_ms = times[kname]
            bound, by, limiter = attention_bound(
                b, h, sq, sk, d, q.element_size(), tc, kind)
            r = readings[kname]
            row = dict(case=name, shape=[b, h, sq, d], sk=sk,
                       dtype=str(dtype).replace("torch.", ""), **r,
                       tolerance=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       library=("sdpa forward, inputs requiring grad"
                                if kname == "K2" else
                                "sdpa backward alone (dq, dk, dv together)"),
                       bound_ms=bound, bound_by=by, bound_limiter=limiter)
            rows[kname].append(row)
            same_txt = ("" if r["same_precision_rel_l2"] is None else
                        f", at its own precision {r['same_precision_rel_l2']:.3g}")
            mma_txt = ("" if r.get("mma_ms") is None else
                       f" (mma.sync {'kernel' if kname == 'K2' else 'pair'} "
                       f"{r['mma_ms']:.4f} ms)")
            det_txt = ("" if "dq_run_to_run_rel_l2" not in r else
                       f", dq run to run {r['dq_run_to_run_rel_l2']:.3g} "
                       f"(dk, dv equal: {r['dk_dv_run_to_run_equal']})")
            log(f"{kname} {name} {b}x{h}x{sq}x{d} sk={sk} {row['dtype']} "
                f"{r['route']}: rel_l2 {r['rel_l2']:.3g} (limit {tol:g}; "
                f"control {r['control_rel_l2']:.3g}{same_txt}), max_abs_err "
                f"{r['max_abs_err']:.3g}{det_txt}, kernel {ms:.4f} ms"
                f"{mma_txt}, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound:.4f} ms ({limiter})")
        del leaves, sdpa_out
    rows["K2"] += k2_route_cases()
    rows["K3+K4"] += bwd_route_cases()
    return rows


def k2_route_cases():
    """K2 alone, held and not timed, on what the training shapes leave out:
    fp16 at both levels, Sq and Sk ragged at head dims 80, 64 and 128, Sk
    under one key tile, one batch*head, and a head dim (36) that must take
    the mma route. Its o by relative L2 with the dropped-tile control, its
    lse within 1e-4."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            drop_last_tile, rel_l2)

    gen = torch.Generator("cuda").manual_seed(8)
    cases = [
        ("level0_fp16", (2, 8, 4096, 40), 4096, torch.float16),
        ("level1_fp16", (2, 8, 1024, 80), 1024, torch.float16),
        ("ragged_fp16_d80", (2, 3, 1000, 80), 1037, torch.float16),
        ("short_keys_bf16", (2, 2, 300, 40), 50, torch.bfloat16),
        ("ragged_bf16_d64", (2, 4, 777, 64), 900, torch.bfloat16),
        ("ragged_fp16_d128", (2, 2, 500, 128), 333, torch.float16),
        ("one_head_bf16", (1, 1, 4096, 40), 4096, torch.bfloat16),
        ("mma_fp16_d36", (1, 2, 77, 36), 99, torch.float16),
    ]
    rows = []
    for name, (b, h, sq, d), sk, dtype in cases:
        route = expected_route(dtype, d)
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        out, lse = counted_call(fa.flash_attention_lse,
                                lambda: fa.flash_attention_lse(q, k, v), route)
        ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v)
        cut = drop_last_tile(sk)
        control = rel_l2(fa.flash_attention_lse_plain(
            q, k[:, :, :cut], v[:, :, :cut])[0], ref_out)
        rel = rel_l2(out, ref_out)
        check(f"K2 {name} o ({route})", rel, control, KERNEL_REL_L2_16BIT)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= 1e-4:
            raise AssertionError(f"K2 {name}: lse off by {lse_err}")
        err = (out.float() - ref_out.float()).abs().max().item()
        rows.append(dict(case=name, shape=[b, h, sq, d], sk=sk,
                         dtype=str(dtype).replace("torch.", ""), route=route,
                         rel_l2=rel, control_rel_l2=control, lse_err=lse_err,
                         max_abs_err=err, tolerance=KERNEL_REL_L2_16BIT))
        log(f"K2 {name} {b}x{h}x{sq}x{d} sk={sk} {rows[-1]['dtype']} "
            f"{route}: rel_l2 {rel:.3g} (limit {KERNEL_REL_L2_16BIT:g}; "
            f"control {control:.3g}), lse off by {lse_err:.3g}")
    return rows


def bwd_route_cases():
    """K3 + K4 alone, held and not timed, on what the training shapes leave
    out: fp16 at both levels, Sq and Sk ragged at head dims 80, 64 and 128,
    Sq and Sk under one tile, Sq much longer than Sk and the reverse, one
    batch*head, and a head dim (36) that must take the mma route. dq, dk
    and dv by relative L2 against the fp32 and the same-precision plain
    backward, each with its dropped-tile control."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import KERNEL_REL_L2_16BIT

    gen = torch.Generator("cuda").manual_seed(9)
    cases = [
        ("level0_fp16", (2, 8, 4096, 40), 4096, torch.float16),
        ("level1_fp16", (2, 8, 1024, 80), 1024, torch.float16),
        ("ragged_fp16_d80", (2, 3, 1000, 80), 1037, torch.float16),
        ("ragged_bf16_d64", (2, 4, 777, 64), 900, torch.bfloat16),
        ("ragged_fp16_d128", (2, 2, 500, 128), 333, torch.float16),
        ("under_one_tile_bf16", (1, 2, 50, 40), 30, torch.bfloat16),
        ("short_keys_bf16", (2, 2, 300, 40), 50, torch.bfloat16),
        ("short_queries_fp16", (2, 2, 40, 80), 700, torch.float16),
        ("one_head_bf16", (1, 1, 4096, 40), 4096, torch.bfloat16),
        ("mma_fp16_d36", (1, 2, 77, 36), 99, torch.float16),
    ]
    rows = []
    for name, (b, h, sq, d), sk, dtype in cases:
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                                 (b, h, sq, d)))
        out, lse = fa.flash_attention_lse_plain(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        _, r = check_backward(name, q, k, v, do, lse, delta,
                              KERNEL_REL_L2_16BIT)
        rows.append(dict(case=name, shape=[b, h, sq, d], sk=sk,
                         dtype=str(dtype).replace("torch.", ""), **r,
                         tolerance=KERNEL_REL_L2_16BIT))
        log(f"K3+K4 {name} {b}x{h}x{sq}x{d} sk={sk} {rows[-1]['dtype']} "
            f"{r['route']}: rel_l2 {r['rel_l2']:.3g} (limit "
            f"{KERNEL_REL_L2_16BIT:g}; control {r['control_rel_l2']:.3g}), "
            f"at its own precision {r['same_precision_rel_l2']:.3g}")
    return rows


def face_inputs():
    import numpy as np
    face = np.random.RandomState(0).randint(0, 255, (512, 512, 3), np.uint8)
    labels = np.zeros((512, 512), np.uint8)
    labels[100:400, 100:400] = 1
    labels[150:200, 150:250] = 4
    labels[150:200, 270:370] = 5
    labels[250:300, 230:290] = 10
    labels[330:370, 200:320] = 12
    faceid = np.random.RandomState(1).randn(1, 512).astype(np.float32)
    return face, labels, faceid


def main_path():
    import numpy as np
    import torch
    from consistentid_torch.core import (AdapterConfig, PipelineConfig,
                                         sd15_unet_config)
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.pipelines import ConsistentIDPipeline, SD15Bundle
    from consistentid_torch.testing import synthetic_clip_tokenizer
    from consistentid_torch.utils.image import postprocess_to_uint8

    t0 = time.perf_counter()
    bundle = SD15Bundle(sd15_unet_config(lora_rank=128, ip_num_tokens=4),
                        AdapterConfig(), dtype=torch.bfloat16, device="cuda")
    bundle.random_params(torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in bundle.parameters())
    pipe = ConsistentIDPipeline(
        bundle, synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(height=512, width=512,
                                       num_inference_steps=50,
                                       start_merge_step=30))
    torch.cuda.synchronize()
    log(f"bundle: {n_params / 1e9:.3f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    face, labels, faceid = face_inputs()
    kw = dict(parsing_labels=labels, faceid_embeds=faceid,
              num_images_per_prompt=4)

    t0 = time.perf_counter()
    pipe.generate(PROMPT, face, seed=0, num_inference_steps=2, **kw)
    torch.cuda.synchronize()
    log(f"warm-up generate (2 steps): {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPT, face, seed=1, num_inference_steps=50,
                           return_float=True, **kw)
    out = postprocess_to_uint8(images)
    seconds = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    by_route = dict(fa.flash_attention_fwd.launches_by_route)
    others = [w.launches for w in counters[1:]]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if out.shape != (4, 512, 512, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    if not torch.isfinite(images.float()).all():
        raise AssertionError("non-finite decoded images")
    if launches != 500 or by_route["sm90"] != 500 or any(others):
        raise AssertionError(f"K1 launched {launches} times ({by_route}), "
                             "expected 500 (10 per UNet call x 50 steps), "
                             f"all on the sm90 route; K2, K3 + K4, K5, K6 "
                             f"{others}, expected none")
    stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
    log(f"main path: generate batch 4, 50 DDIM steps, 512 px: "
        f"{seconds:.3f} s, {4 / seconds * 60:.2f} images/min, "
        f"stages ms {stages}, peak memory {peak_gib:.2f} GiB, "
        f"K1 launches {launches} {by_route}, image std "
        f"{float(images.float().std()):.4f}")
    return bundle, dict(seconds=seconds, images_per_min=4 / seconds * 60,
                        stage_ms=stages, peak_gib=peak_gib, launches=launches,
                        launches_by_route=by_route, bn_launches=others[2:])


def unet_path_check(bundle):
    """One full-width bf16 UNet call through the dispatch (K1), then the same
    call with the dispatch's kernel replaced by its plain version."""
    import torch
    from consistentid_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(2)
    x = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((8,), 501.0, device="cuda")
    ctx = torch.randn((8, 81, 768), generator=gen, device="cuda")
    unet = bundle.infer_unet(1.0)
    with torch.no_grad():
        before = fa.flash_attention_fwd.launches
        with_kernel = unet(x, t, ctx).float()
        torch.cuda.synchronize()
        per_call = fa.flash_attention_fwd.launches - before
        kernel = fa.flash_attention_fwd
        fa.flash_attention_fwd = fa.flash_attention_plain
        try:
            with_plain = unet(x, t, ctx).float()
        finally:
            fa.flash_attention_fwd = kernel
    diff = (with_kernel - with_plain).abs().max().item()
    scale = with_plain.abs().max().item()
    # bf16 activations: the kernel's and the plain version's attention
    # outputs differ by about one bf16 ulp, which the rest of the UNet
    # carries; bound the difference at 2% of the output's largest value.
    ok = per_call == 10 and math.isfinite(diff) and diff <= 0.02 * scale
    log(f"UNet path check (bf16, batch 8, 64x64 latents): K1 launches per "
        f"call {per_call}, max |kernel - plain| {diff:.4g} vs max |out| "
        f"{scale:.4g} (bound 2%)")
    if not ok:
        raise AssertionError("UNet path check failed")
    return dict(launches_per_unet_call=per_call, max_abs_diff=diff,
                max_abs_out=scale)


def profile_call(fn, top: int = 12):
    """Device time of one call of fn by kernel, from torch.profiler (after
    one call outside it): the wall ms, the device ms, and the `top`
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not device_ms > 0:
        raise AssertionError("the profiler recorded no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [dict(kernel=e.key[:90], calls=e.count,
                 ms=e.self_device_time_total / 1e3,
                 share=e.self_device_time_total / 1e3 / device_ms)
            for e in kernels[:top]]
    return dict(wall_ms=wall_ms, device_ms=device_ms, top=rows)


def log_profile(label: str, prof) -> None:
    log(f"{label}: wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_ms']:.3f} ms "
        f"({prof['device_ms'] / prof['wall_ms']:.1%})")
    for r in prof["top"]:
        log(f"  {r['ms']:9.3f} ms {r['share']:6.1%} x{r['calls']:<4d} "
            f"{r['kernel']}")


def profile_unet(bundle, top: int = 12, inputs=None, label=None):
    """Device time of one full-width UNet call by kernel, from
    torch.profiler (`profile_call`): the total, the share of the call's
    wall time the card was busy, and the `top` kernels. inputs: (x, t,
    context, added_cond); by default SD1.5's batch 8 (CFG at 4 images),
    64x64 latents."""
    import torch

    if inputs is None:
        gen = torch.Generator("cuda").manual_seed(3)
        inputs = (torch.randn((8, 64, 64, 4), generator=gen, device="cuda"),
                  torch.full((8,), 501.0, device="cuda"),
                  torch.randn((8, 81, 768), generator=gen, device="cuda"),
                  None)
        label = "bf16, batch 8, 64x64 latents"
    x, t, ctx, added = inputs
    unet = bundle.infer_unet(1.0)
    prof = profile_call(lambda: unet(x, t, ctx, added_cond=added), top)
    log_profile(f"UNet call profile ({label})", prof)
    return prof


def training_path(bundle):
    """The training main path: the full-width bundle with fp32 trainable
    masters takes 1 warm-up and 5 timed steps (TrainConfig defaults: batch
    2, 512 px, 5 localization layers, lr 1e-4) on a synthetic batch."""
    import torch
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.training import (create_train_state,
                                             make_train_step, synthetic_batch,
                                             warm_start_ip_projections)
    from consistentid_torch.training.train_step import batch_to_tensors

    config = TrainConfig()
    warm_start_ip_projections(bundle.unet)
    state = create_train_state(bundle, config)
    n_train = sum(p.numel() for p in state.trainable.values())
    frozen0 = {n: p.detach().clone() for n, p in state.frozen.items()}
    train0 = {n: p.detach().clone() for n, p in state.trainable.items()}
    step = make_train_step(bundle, NoiseSchedule.create(SchedulerConfig()),
                           config)
    batch = batch_to_tensors(synthetic_batch(
        config.batch_per_device, config.resolution,
        bundle.vision_config.image_size,
        bundle.adapter_config.id_embeddings_dim, seed=0), bundle.device)
    gen = torch.Generator("cuda").manual_seed(0)

    t0 = time.perf_counter()
    state, metrics = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses = [float(metrics["loss"])]
    # AdamW's first moment after one step from zero is (1 - b1) g: every
    # trainable leaf must have had a nonzero, finite gradient (weight decay
    # alone would move a leaf the loss never reached)
    no_grad = [n for n, mu in zip(state.trainable, state.optimizer.mu)
               if not (bool(mu.ne(0).any()) and bool(mu.isfinite().all()))]
    if no_grad:
        raise AssertionError(f"{len(no_grad)} trainable leaves had a zero or "
                             f"non-finite first gradient: {no_grad[:5]}")

    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    torch.cuda.reset_peak_memory_stats()
    n_steps = 5
    step_metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, metrics = step(state, batch, generator=gen)
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [w.launches for w in counters]
    k2_routes = dict(fa.flash_attention_lse.launches_by_route)
    bwd_routes = dict(fa.flash_attention_bwd.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(m["loss"]) for m in step_metrics]
    s_per_step = seconds / n_steps
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches != [0] + [10 * n_steps] * 2 + [0, 0] or \
            k2_routes["sm90"] != 10 * n_steps or \
            bwd_routes != {"sm90": 10 * n_steps, "mma": 0, "f32": 0}:
        raise AssertionError(f"launches K1, K2, K3 + K4, K5, K6 over "
                             f"{n_steps} steps: {launches} (K2 {k2_routes}, "
                             f"K3 + K4 {bwd_routes}), expected 10 per step "
                             "each of K2 and K3 + K4, all on the sm90 route "
                             "(no launch of the mma.sync K3/K4), and none "
                             "of K1, K5, K6")
    still = [n for n, p in state.trainable.items()
             if torch.equal(p, train0[n])]
    changed = [n for n, p in state.frozen.items()
               if not torch.equal(p, frozen0[n])]
    if still or changed:
        raise AssertionError(f"trainable leaves that did not move: "
                             f"{still[:5]}; frozen leaves that did: "
                             f"{changed[:5]}")
    del frozen0, train0
    log(f"training path: batch 2, 512 px, {n_steps} steps after a "
        f"{warm_s:.2f} s warm-up: {s_per_step:.4f} s/step, "
        f"{2 / s_per_step:.3f} examples/s, peak memory {peak_gib:.2f} GiB, "
        f"{n_train / 1e6:.1f} M trainable fp32 params, launches K1, K2, "
        f"K3 + K4, K5, K6 {launches} (K2 {k2_routes}, K3 + K4 "
        f"{bwd_routes}), losses "
        f"{[round(x, 5) for x in losses]}")
    return state, dict(s_per_step=s_per_step, examples_per_s=2 / s_per_step,
                       warmup_s=warm_s, peak_gib=peak_gib, losses=losses,
                       launches=launches, k2_launches_by_route=k2_routes,
                       bwd_launches_by_route=bwd_routes,
                       trainable_params=n_train, steps=n_steps)


def profile_train_step(bundle, state):
    """profile_step on one SD1.5 training step (batch 2, 512 px)."""
    import torch
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.training import make_train_step, synthetic_batch
    from consistentid_torch.training.train_step import batch_to_tensors

    step = make_train_step(bundle, NoiseSchedule.create(SchedulerConfig()),
                           TrainConfig())
    batch = batch_to_tensors(synthetic_batch(
        2, 512, bundle.vision_config.image_size,
        bundle.adapter_config.id_embeddings_dim, seed=1), bundle.device)
    return profile_step(step, state, batch,
                        torch.Generator("cuda").manual_seed(5),
                        "bf16, batch 2, 512 px")


class Recorder:
    """Stands in for a kernel's wrapper and keeps each call's arguments and
    results; the wrapper still launches, and its launch counters (which it
    reaches through its module name) stay the wrapper's own."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.calls = []

    def __call__(self, *args):
        result = self.wrapper(*args)
        self.calls.append((args, result))
        return result

    launches = property(lambda self: self.wrapper.launches,
                        lambda self, n: setattr(self.wrapper, "launches", n))
    launches_by_route = property(
        lambda self: self.wrapper.launches_by_route,
        lambda self, n: setattr(self.wrapper, "launches_by_route", n))


@contextmanager
def recorded_flash():
    """Record every call the autograd Function makes to K2 and K3 + K4, in
    call order: yields {wrapper name: [(arguments, result), ...]}."""
    from consistentid_torch.ops import flash_attention as fa
    names = ("flash_attention_lse", "flash_attention_bwd")
    recorders = {n: Recorder(getattr(fa, n)) for n in names}
    for n, r in recorders.items():
        setattr(fa, n, r)
    try:
        yield {n: r.calls for n, r in recorders.items()}
    finally:
        for n, r in recorders.items():
            setattr(fa, n, r.wrapper)


def check_flash_calls(calls, starts, grads, trainable):
    """The per-call and per-leaf halves of train_unet_path_check: `calls`
    from recorded_flash, `starts` the (K2 calls so far, module name) of each
    attention as it started, `grads` the kernel route's UNet gradients by
    name. Returns the calls' readings and, per held leaf, (kernel vs same
    precision, control, kernel vs fp32 inside attention)."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            KERNEL_REL_L2_SAME_PRECISION,
                                            drop_last_tile, rel_l2)

    # the backward calls, by the forward's lse they were given
    bwd = {args[4].data_ptr(): (args, res) for args, res in
           calls["flash_attention_bwd"]}
    call_rows, held = [], {}
    for i, ((q, k, v, scale), (o, lse)) in enumerate(
            calls["flash_attention_lse"]):
        owner = [n for c, n in starts if c <= i][-1]
        (_, _, _, do, _, delta, _), (dq, dk, dv) = bwd[lse.data_ptr()]
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        kc, qc = drop_last_tile(k.shape[2]), drop_last_tile(q.shape[2])

        ref_o, ref_lse = fa.flash_attention_lse_plain(qd, kd, vd, scale)
        ctl_o = fa.flash_attention_lse_plain(qd, kd[:, :, :kc],
                                             vd[:, :, :kc], scale)[0]
        lse_err = (lse - ref_lse).abs().max().item()
        o_rel, o_ctl = rel_l2(o, ref_o), rel_l2(ctl_o, ref_o)
        # no control held here: at random weights the self-attention's
        # scores are near uniform and its values share one large mean, so
        # dropping a key tile moves o less than bf16 rounds it (the kernel
        # phase holds K2 to that control on random inputs)
        check(f"call {i} ({owner}) K2 o", o_rel, None, KERNEL_REL_L2_16BIT)
        if not lse_err <= 1e-4:
            raise AssertionError(f"call {i} ({owner}) K2 lse off by "
                                 f"{lse_err}")

        def backward(qq, kk, vv, rows=slice(None), round_to=q.dtype):
            return [g.to(q.dtype) for g in fa.flash_attention_bwd_plain(
                qq, kk, vv, do[:, :, rows], lse[:, :, rows],
                delta[:, :, rows], scale, round_to=round_to)]

        same = backward(qd, kd, vd)
        exact = backward(qd, kd, vd, round_to=None)
        ctl = [backward(qd, kd[:, :, :kc], vd[:, :, :kc])[0],
               *backward(qd[:, :, :qc], kd, vd, slice(0, qc))[1:]]
        rels = [rel_l2(a, b) for a, b in zip((dq, dk, dv), same)]
        ctls = [rel_l2(a, b) for a, b in zip(ctl, same)]
        for oname, rel, control in zip(("dq", "dk", "dv"), rels, ctls):
            check(f"call {i} ({owner}) {oname} at the kernels' precision",
                  rel, control, KERNEL_REL_L2_SAME_PRECISION)
        call_rows.append(dict(
            module=owner, shape=list(q.shape), sk=k.shape[2], o_rel_l2=o_rel,
            lse_err=lse_err, rel_l2=dict(zip(("dq", "dk", "dv"), rels)),
            o_control_rel_l2=o_ctl, control_rel_l2=min(ctls),
            exact_rel_l2=[rel_l2(a, b) for a, b in zip((dq, dk, dv), exact)]))

        # the LoRA leaves this call alone feeds, through each dq, dk, dv
        leaf_names = [f"unet.{owner}.{p}_lora.{s}.weight"
                      for p in ("to_q", "to_k", "to_v")
                      for s in ("down", "up")]
        leaves = [trainable[n] for n in leaf_names]

        def leaf_grads(dqkv):
            return torch.autograd.grad((q, k, v), leaves, grad_outputs=dqkv,
                                       retain_graph=True)

        for n, g_same, g_exact, g_ctl in zip(
                leaf_names, leaf_grads(same), leaf_grads(exact),
                leaf_grads(ctl)):
            held[n] = (rel_l2(grads[n], g_same), rel_l2(g_ctl, g_same),
                       rel_l2(grads[n], g_exact))
    return call_rows, held


def train_unet_path_check(bundle, state):
    """One full-width UNet forward and backward (batch 2, bf16, 64x64
    latents) through K2 and K3 + K4, every kernel call kept; then
      - each call's K2 output against its plain version, and its K3 + K4
        outputs against the plain backward at the kernel's precision (P and
        dS rounded to bf16), on the call's own inputs;
      - per leaf, the gradients of the q/k/v LoRA leaves of each
        self-attention that ran the kernels (their only way to the loss is
        that call's dq, dk, dv) against the same leaves' gradients through
        the same-precision backward's dq, dk, dv;
      - all trainable UNet gradients against a second forward and backward
        through the plain versions (fp32 inside attention).
    Each bound has a control that drops one key or query tile."""
    import torch
    from consistentid_torch.models.layers import Attention
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            KERNEL_REL_L2_SAME_PRECISION,
                                            rel_l2)

    gen = torch.Generator("cuda").manual_seed(4)
    x = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    t = torch.tensor([101, 801], device="cuda")
    ctx = torch.randn((2, 81, 768), generator=gen, device="cuda")
    w = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    names = [n for n in state.trainable if n.startswith("unet.")]
    params = [state.trainable[n] for n in names]
    counters = launch_counters()

    def unet_loss():
        out = bundle.call(bundle.unet, x.to(bundle.dtype), t,
                          ctx.to(bundle.dtype))
        return (out.float() * w).sum()

    # (K2 calls made so far, attention module) as each attention starts
    starts = []
    with recorded_flash() as calls:
        hooks = [m.register_forward_pre_hook(
                     lambda mod, args, n=n: starts.append(
                         (len(calls["flash_attention_lse"]), n)))
                 for n, m in bundle.unet.named_modules()
                 if isinstance(m, Attention)]
        try:
            for c in counters:
                c.launches = 0
            loss = unet_loss()
            g_kernel = torch.autograd.grad(loss, params, retain_graph=True)
            torch.cuda.synchronize()
            n_kernel = [c.launches for c in counters]
        finally:
            for hk in hooks:
                hk.remove()
    grads = dict(zip(names, g_kernel))

    call_rows, held = check_flash_calls(calls, starts, grads,
                                        state.trainable)
    del calls, loss, g_kernel
    torch.cuda.synchronize()

    # the same forward and backward through the plain versions
    with plain_flash():
        for c in counters:
            c.launches = 0
        g_plain = [g.float() for g in torch.autograd.grad(unet_loss(),
                                                           params)]
        torch.cuda.synchronize()
        n_plain = [c.launches for c in counters]
    g_kern = [grads[n].float() for n in names]
    total = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in
                           zip(g_kern, g_plain))).item()
    norm = torch.sqrt(sum((b ** 2).sum() for b in g_plain)).item()
    overall = total / norm
    other = {n: rel_l2(a, b) for n, a, b in zip(names, g_kern, g_plain)
             if n not in held}

    worst_held = sorted(held.items(), key=lambda kv: -kv[1][0])
    worst_other = sorted(other.items(), key=lambda kv: -kv[1])
    for n, (rel, control, exact) in worst_held[:3]:
        log(f"  held leaf {n}: |g| {grads[n].norm().item():.4g}, kernel vs "
            f"same precision {rel:.4g} (control {control:.4g}), vs fp32 "
            f"inside attention {exact:.4g}")
    for n, rel in worst_other[:3]:
        log(f"  other leaf {n}: kernel route vs plain route {rel:.4g}")
    # The two routes' forwards differ too (K2 rounds P to bf16, the plain
    # version keeps it in fp32) and the bf16 layers carry that into every
    # input of the backward: the held leaves' gradients (about 1e-8) moved
    # by 30-50% under it, so they are held above, on the kernel route's own
    # inputs. Every other leaf: 5% of its norm; all leaves together: 2%.
    bad = ([n for n, (rel, control, _) in held.items()
            if not rel <= UNET_LEAF_REL_L2 < control]
           + [n for n, rel in other.items() if not rel <= 0.05])
    ok = (n_kernel == [0, 10, 10] and n_plain == [0, 0, 0]
          and len(call_rows) == 10 and len(held) == 60
          and math.isfinite(overall) and overall <= 0.02 and not bad)
    worst_call = max(max(r["rel_l2"].values()) for r in call_rows)
    log(f"training UNet path check (bf16, batch 2, 64x64 latents, "
        f"{len(params)} trainable leaves): launches K1, K2, K3 + K4 "
        f"kernel route "
        f"{n_kernel}, plain route {n_plain}; per call (10): K2 o worst "
        f"{max(r['o_rel_l2'] for r in call_rows):.4g} (limit "
        f"{KERNEL_REL_L2_16BIT:g}), K3 + K4 vs same precision worst "
        f"{worst_call:.4g} (limit {KERNEL_REL_L2_SAME_PRECISION:g}), "
        f"controls from "
        f"{min(r['control_rel_l2'] for r in call_rows):.4g}; held leaves "
        f"({len(held)}) worst {worst_held[0][1][0]:.4g} (limit "
        f"{UNET_LEAF_REL_L2:g}, controls from "
        f"{min(c for _, c, _ in held.values()):.4g}); other leaves worst "
        f"{worst_other[0][1]:.4g} (limit 0.05); overall |g_kernel - "
        f"g_plain| / |g_plain| {overall:.4g} (limit 0.02); over: {bad[:5]}")
    if not ok:
        raise AssertionError("training UNet path check failed")
    return dict(launches=n_kernel, rel_l2=overall, calls=call_rows,
                worst_held_leaf=worst_held[0][1][0],
                held_leaf_control_min=min(c for _, c, _ in held.values()),
                worst_held_leaf_vs_fp32=max(e for _, _, e in held.values()),
                worst_other_leaf=worst_other[0][1])


def tiny_train_check():
    """The tiny fp32 bundle's loss and trainable gradients (64 px, batch 2:
    the level-0 self-attention is 1024 x 1024, 3 Function calls) on the card
    (K2's and K3 + K4's fp32 paths) against the same bundle on the CPU
    (plain versions),
    with TF32 off on the card and the same draws."""
    import torch
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.testing import tf32_off, tiny_bundle
    from consistentid_torch.training import (Draws, consistentid_loss,
                                             create_train_state, make_draws,
                                             synthetic_batch)
    from consistentid_torch.training.train_step import batch_to_tensors

    with tf32_off():
        schedule = NoiseSchedule.create(SchedulerConfig())
        batch = synthetic_batch(2, 64, 28, 16, seed=2)
        draws = make_draws(torch.Generator("cpu").manual_seed(6),
                           (2, 32, 32, 4), 1000)
        cpu_bundle = tiny_bundle(device="cpu", seed=3)
        gpu_bundle = tiny_bundle(device="cuda")
        gpu_bundle.load_state_dict(cpu_bundle.state_dict())
        counters = launch_counters()
        outs = []
        for bundle in (cpu_bundle, gpu_bundle):
            dev = bundle.device
            state = create_train_state(bundle, TrainConfig())
            before = [c.launches for c in counters]
            loss, _ = consistentid_loss(
                bundle, batch_to_tensors(batch, dev),
                Draws(**{k: v.to(dev) for k, v in vars(draws).items()}),
                schedule=schedule, config=TrainConfig())
            grads = torch.autograd.grad(loss, list(state.trainable.values()))
            outs.append((loss.item(), [g.cpu() for g in grads],
                         [c.launches - b for c, b in zip(counters, before)]))
    (cpu_loss, cpu_g, cpu_n), (gpu_loss, gpu_g, gpu_n) = outs
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                for a, b in zip(gpu_g, cpu_g))
    # fp32 on both devices, other summation orders through the VAE, ViT,
    # CLIP, adapters and UNet: the CPU parity tests' bounds, loss 1e-5
    # relative, each gradient leaf 1e-4 of its largest element
    ok = (cpu_n == [0, 0, 0] and gpu_n == [0, 3, 3]
          and loss_rel <= 1e-5 and worst <= 1e-4)
    log(f"tiny fp32 train step, card vs CPU (64 px, batch 2): loss "
        f"{gpu_loss:.7g} vs {cpu_loss:.7g} (relative {loss_rel:.3g}, tol "
        f"1e-5), worst gradient leaf {worst:.3g} of its max (tol 1e-4), "
        f"launches K1, K2, K3 + K4 card {gpu_n} / cpu {cpu_n}")
    if not ok:
        raise AssertionError("tiny training card-vs-CPU check failed")
    return dict(loss_rel=loss_rel, worst_grad_rel=worst, launches=gpu_n)


def tiny_reference_check():
    """The tiny fp32 bundle's encode + 3-step denoise + decode on the card
    (K1's fp32 path at the level-0 cutover) against the same bundle on the
    CPU (plain attention), with TF32 off on the card."""
    import numpy as np
    import torch
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                            tf32_off, tiny_bundle)

    with tf32_off():
        cfg = PipelineConfig(height=64, width=64, num_inference_steps=3,
                             start_merge_step=1)
        rng = np.random.RandomState(0)
        face = rng.randint(0, 255, (64, 64, 3), np.uint8)
        labels = np.zeros((64, 64), np.uint8)
        labels[10:40, 10:50] = 1
        labels[15:20, 15:25] = 4
        labels[25:30, 28:34] = 10
        faceid = rng.randn(1, 16).astype(np.float32)
        latents = torch.from_numpy(
            np.random.default_rng(7).standard_normal((2, 32, 32, 4),
                                                     np.float32))
        cpu_bundle = tiny_bundle(device="cpu", seed=3)
        gpu_bundle = tiny_bundle(device="cuda")
        gpu_bundle.load_state_dict(cpu_bundle.state_dict())
        outs = []
        for bundle in (cpu_bundle, gpu_bundle):
            device = bundle.device
            pipe = ConsistentIDPipeline(bundle, synthetic_clip_tokenizer(),
                                        cfg)
            cond = pipe.device_cond(pipe.prepare_conditioning(
                PROMPT, face, parsing_labels=labels, faceid_embeds=faceid))
            before = fa.flash_attention_fwd.launches
            img = pipe._generate_core(cond, latents.to(device), 5.0, 1, 3,
                                      "ddim", 1.0, 1.0)
            outs.append((img.float().cpu(),
                         fa.flash_attention_fwd.launches - before))
    (cpu_img, cpu_launches), (gpu_img, gpu_launches) = outs
    diff = (cpu_img - gpu_img).abs().max().item()
    # fp32 on both devices, different summation orders through 3 UNet
    # steps and the VAE: the CPU parity tests' 1e-3 on images in [-1, 1]
    ok = cpu_launches == 0 and gpu_launches == 9 and diff <= 1e-3
    log(f"tiny fp32 bundle, card vs CPU (64 px, 3 steps): max |diff| "
        f"{diff:.3g} (tol 1e-3), K1 launches card {gpu_launches} / cpu "
        f"{cpu_launches}")
    if not ok:
        raise AssertionError("tiny card-vs-CPU check failed")
    return dict(max_abs_diff=diff, launches=gpu_launches)


def bn_bound(rows, c, itemsize, kind):
    """Least time (ms) of K5 ("moments"), K6 ("apply") or both in one
    function ("fused") and what bounds it. Bytes: x read once (K5: mean and
    var written; K6: y written, four fp32 (C,) vectors read; fused: y,
    mean and var written, scale and bias read). Operations, fp32 outside
    the tensor cores: K5 an add, a multiply and an add per element (3
    FLOPs), K6 a subtract, two multiplies, an add and the activation (5
    FLOPs counted), fused both."""
    n = rows * c
    nbytes = {"moments": n * itemsize + 2 * c * 4,
              "apply": 2 * n * itemsize + 4 * c * 4,
              "fused": 2 * n * itemsize + 4 * c * 4}[kind]
    flops = {"moments": 3 * n, "apply": 5 * n, "fused": 8 * n}[kind]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def rotation(x, l2_bytes: int, most: int = 64):
    """x and copies of it, enough that together they pass four times the
    L2's bytes (at most `most`): a loop that takes them in turn reads each
    from HBM. At the ragged shapes even `most` copies fit in the L2; there
    the launch, not the bytes, sets the time."""
    n = min(most, -(-4 * l2_bytes // (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(n - 1)]


def bn_device_kernels(fn, calls: int = 3):
    """The names of the device kernels torch.profiler records over `calls`
    calls of fn, after one call outside it and a first profiler session
    that is thrown away (the first session of a process can miss the
    kernels of its first moments)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def bn_kernel_phase():
    """K5 and K6 against their plain versions on the card: mean and var, and
    the output for each activation, by relative L2 with a control each, and
    K5's bits against `moments_in_kernel_order` over three calls and one on
    a second stream; the device kernels a call of K5, K6 and fused_bn_act
    launch (torch.profiler, at P fp32: 1, 1 and 2); then K5, K6 and
    fused_bn_act timed at each shape by `cuda_ms` beside the plain version
    and the library call, on copies of x in turn (`rotation`; K6 with
    leaky_relu, the JAX default), with the card's ceilings in the same
    run: a copy of x into y (K6's bytes), x.sum() (K5's) and a one-element
    add (the launch floor). The (16, 224, 224, 64) fp32 case is BiSeNet
    training's stem BatchNorm at batch 16, 448 px crops; the (1, 256, 256,
    64) cases (P) the parser's stem at 512 px."""
    import torch
    import torch.nn.functional as F
    from consistentid_torch.ops import fused_bn_act as bn
    from consistentid_torch.testing import (KERNEL_BN_APPLY_REL_L2_16BIT,
                                            KERNEL_BN_APPLY_REL_L2_FP32,
                                            KERNEL_BN_MOMENTS_REL_L2,
                                            moments_in_kernel_order,
                                            moments_without_last_cluster,
                                            rel_l2,
                                            unnormalized_last_channels)

    gen = torch.Generator("cuda").manual_seed(7)
    l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size
    cases = [
        ("bisenet_train_stem", (16, 224, 224, 64), torch.float32, 20),
        ("parser_stem_fp32", (1, 256, 256, 64), torch.float32, 100),
        ("parser_stem_bf16", (1, 256, 256, 64), torch.bfloat16, 100),
        ("ragged_c24", (2, 9, 7, 24), torch.float32, 100),
        ("ragged_c19", (1, 33, 17, 19), torch.bfloat16, 100),
    ]
    rows_out = {"K5": [], "K6": [], "fused": []}
    fused_launches = counts = None
    one = torch.ones(1, device="cuda")
    for name, shape, dtype, iters in cases:
        c = shape[-1]
        rows = math.prod(shape) // c
        x = (torch.randn(shape, generator=gen, device="cuda")
             + torch.randn(c, generator=gen, device="cuda")).to(dtype)
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda")
        plan = bn.plan_for(x)
        if fused_launches is None:     # the kernels' launches per call
            before = (bn.batch_moments.launches, bn.apply_bn_act.launches)
            bn.fused_bn_act(x, scale, bias)
            fused_launches = (bn.batch_moments.launches - before[0],
                              bn.apply_bn_act.launches - before[1])
        if name == "parser_stem_fp32":   # device kernels a call, profiled
            st = bn.batch_moments_plain(x)
            per_call = {
                "batch_moments": bn_device_kernels(
                    lambda: bn.batch_moments(x)),
                "apply_bn_act": bn_device_kernels(
                    lambda: bn.apply_bn_act(x, *st, scale, bias)),
                "fused_bn_act": bn_device_kernels(
                    lambda: bn.fused_bn_act(x, scale, bias))}
            counts = {k: len(v) / 3 for k, v in per_call.items()}
            per_call = {k: sorted(set(v)) for k, v in per_call.items()}
            log(f"K5/K6 device kernels a call (torch.profiler over 3 calls,"
                f" {name}): {counts} {per_call}")
            if counts != {"batch_moments": 1, "apply_bn_act": 1,
                          "fused_bn_act": 2}:
                raise AssertionError(f"K5/K6 device kernels a call: {counts}")
        mean, var = bn.batch_moments(x)
        runs = [bn.batch_moments(x) for _ in range(2)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            runs.append(bn.batch_moments(x))
        torch.cuda.synchronize()
        ordered = moments_in_kernel_order(x, plan)
        bits = all(torch.equal(m, ordered[0]) and torch.equal(v, ordered[1])
                   for m, v in [(mean, var), *runs])
        if not bits:
            raise AssertionError(
                f"K5 {name}: the bits differ between calls or from "
                f"moments_in_kernel_order (max |diff| "
                f"{(mean - ordered[0]).abs().max().item():.3g}, "
                f"{(var - ordered[1]).abs().max().item():.3g})")
        ref_mean, ref_var = bn.batch_moments_plain(x)
        ctl_mean, ctl_var = moments_without_last_cluster(x, plan)
        m_rel = max(rel_l2(mean, ref_mean), rel_l2(var, ref_var))
        m_ctl = min(rel_l2(ctl_mean, ref_mean), rel_l2(ctl_var, ref_var))
        check(f"K5 {name} mean, var", m_rel, m_ctl, KERNEL_BN_MOMENTS_REL_L2)
        m_err = max((mean - ref_mean).abs().max().item(),
                    (var - ref_var).abs().max().item())
        tol = (KERNEL_BN_APPLY_REL_L2_FP32 if dtype == torch.float32
               else KERNEL_BN_APPLY_REL_L2_16BIT)
        a_rel, a_ctl, a_err = 0.0, math.inf, 0.0
        for act in bn.ACTIVATIONS:
            y = bn.apply_bn_act(x, ref_mean, ref_var, scale, bias,
                                activation=act)
            torch.cuda.synchronize()
            ref = bn.apply_bn_act_plain(x, ref_mean, ref_var, scale, bias,
                                        activation=act)
            rel = rel_l2(y, ref)
            ctl = rel_l2(unnormalized_last_channels(x, ref), ref)
            check(f"K6 {name} {act}", rel, ctl, tol)
            a_rel, a_ctl = max(a_rel, rel), min(a_ctl, ctl)
            a_err = max(a_err, (y.float() - ref.float()).abs().max().item())
        fy, fm, fv = bn.fused_bn_act(x, scale, bias)
        torch.cuda.synchronize()
        f_ref = bn.apply_bn_act_plain(x, fm, fv, scale, bias)
        f_rel = rel_l2(fy, f_ref)
        f_ctl = rel_l2(unnormalized_last_channels(x, f_ref), f_ref)
        check(f"fused_bn_act {name}", f_rel, f_ctl, tol)
        if not (torch.equal(fm, mean) and torch.equal(fv, var)):
            raise AssertionError(f"fused_bn_act {name}: moments differ "
                                 "from batch_moments'")
        f_err = (fy.float() - f_ref.float()).abs().max().item()

        # timed on copies of x in turn, enough that each call reads its
        # input from HBM, not from the L2 the call before filled
        xs = itertools.cycle(rotation(x, l2_bytes))
        stats = (ref_mean, ref_var, scale, bias)
        y_buf = torch.empty_like(x)

        def fused_plain(xi):
            return bn.apply_bn_act_plain(xi, *bn.batch_moments_plain(xi),
                                         scale, bias)
        times = {
            "K5": (cuda_ms(lambda: bn.batch_moments(next(xs)), iters),
                   cuda_ms(lambda: bn.batch_moments_plain(next(xs)), iters),
                   cuda_ms(lambda: torch.var_mean(next(xs).reshape(-1, c),
                                                  dim=0, correction=0),
                           iters)),
            "K6": (cuda_ms(lambda: bn.apply_bn_act(next(xs), *stats), iters),
                   cuda_ms(lambda: bn.apply_bn_act_plain(next(xs), *stats),
                           iters),
                   # on the channels-last (NCHW) view
                   cuda_ms(lambda: F.leaky_relu(F.batch_norm(
                       next(xs).permute(0, 3, 1, 2), *stats, False, 0.0,
                       1e-5), 0.01), iters)),
            "fused": (cuda_ms(lambda: bn.fused_bn_act(next(xs), scale, bias),
                              iters),
                      cuda_ms(lambda: fused_plain(next(xs)), iters),
                      # train mode: the batch's own moments
                      cuda_ms(lambda: F.leaky_relu(F.batch_norm(
                          next(xs).permute(0, 3, 1, 2), None, None, scale,
                          bias, True, 0.0, 1e-5), 0.01), iters)),
        }
        ceilings = dict(
            copy_ms=cuda_ms(lambda: y_buf.copy_(next(xs)), iters),
            sum_ms=cuda_ms(lambda: next(xs).sum(), iters),
            launch_floor_ms=cuda_ms(lambda: torch.add(one, one), iters))
        readings = {"K5": (m_rel, m_ctl, m_err, KERNEL_BN_MOMENTS_REL_L2,
                           "moments"),
                    "K6": (a_rel, a_ctl, a_err, tol, "apply"),
                    "fused": (f_rel, f_ctl, f_err, tol, "fused")}
        for kname, (ms, plain_ms, lib_ms) in times.items():
            rel, ctl, err, limit, kind = readings[kname]
            bound, by = bn_bound(rows, c, x.element_size(), kind)
            row = dict(case=name, shape=list(shape),
                       dtype=str(dtype).replace("torch.", ""), rel_l2=rel,
                       control_rel_l2=ctl, tolerance=limit, max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound, bound_by=by,
                       bound_share=bound / ms, **ceilings,
                       plan=dataclasses.asdict(plan))
            if kname == "K5":
                row["bits_repeat"] = bits
            rows_out[kname].append(row)
            log(f"{kname} {name} {tuple(shape)} {row['dtype']}: rel_l2 "
                f"{rel:.3g} (limit {limit:g}; control {ctl:.3g}), "
                f"max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{bound:.4f} ms ({by}, {bound / ms:.0%}); copy "
                f"{ceilings['copy_ms']:.4f}, sum {ceilings['sum_ms']:.4f}, "
                f"launch floor {ceilings['launch_floor_ms']:.4f} ms")
        del x, xs, y_buf
    return rows_out, fused_launches, counts


def bn_counters():
    """K5's and K6's wrappers, whose .launches count their launches."""
    from consistentid_torch.ops import fused_bn_act as bn
    return [bn.batch_moments, bn.apply_bn_act]


def host_ms(fn, iters: int) -> float:
    """Host clock per call of fn (which returns host arrays, so each call
    ends synchronised), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def perception_phase():
    """The perception hooks at full width in fp32 (the JAX makers' default):
    SCRFD-10g at 640, iresnet50 at 112 to 512-d, BiSeNet 19 classes at 512,
    random weights from random_perception_state. On the face: detect,
    align, embed, parse; each hook timed on the card (PyTorch's defaults:
    cuDNN convolutions in TF32); then, with TF32 off, the same inputs and
    weights on the card and on the CPU: the SCRFD head maps, the chosen
    slot, the aligned crop, the embedding and the BiSeNet logits by
    relative L2, and the label maps' agreement."""
    import numpy as np
    import torch
    from consistentid_torch.models.arcface import make_face_embedder
    from consistentid_torch.models.bisenet import make_face_parser
    from consistentid_torch.models.detection import (detect_and_align,
                                                     select_face)
    from consistentid_torch.models.safety_checker import make_safety_checker
    from consistentid_torch.models.scrfd import (SCRFD_VARIANTS,
                                                 flatten_level_outputs,
                                                 make_face_detector)
    from consistentid_torch.testing import (PERCEPTION_CHAIN_REL_L2,
                                            PERCEPTION_LABEL_AGREEMENT,
                                            PERCEPTION_REL_L2,
                                            random_perception_state, rel_l2,
                                            tf32_off)
    from consistentid_torch.utils.image import (detector_letterbox,
                                                imagenet_preprocess)

    states = random_perception_state(torch.Generator("cuda").manual_seed(10))
    cfg = SCRFD_VARIANTS["scrfd_10g"]

    def hooks(device, st):
        det = make_face_detector(st["detector"], cfg, input_size=640,
                                 device=device)
        return (det, make_face_embedder(st["embedder"], detector=det,
                                        device=device),
                make_face_parser(st["parser"], size=512, device=device))

    face = face_inputs()[0]
    detector, embedder, parser = hooks("cuda", states)
    times = {"detect_ms": host_ms(lambda: detector(face), 5),
             "embed_ms": host_ms(lambda: embedder(face), 5),
             "parse_ms": host_ms(lambda: parser(face), 5)}
    # the hooks' split: the networks alone on the card (CUDA events), the
    # host preparations and the detector's post-processing (host clock)
    x_det = torch.from_numpy(detector_letterbox(face, 640)[0]).cuda()
    x_emb = torch.zeros((1, 112, 112, 3), device="cuda")
    x_par = torch.from_numpy(imagenet_preprocess(face, 512)).cuda()
    with torch.no_grad():
        levels = flatten_level_outputs(detector.model(x_det))
        times.update(
            scrfd_forward_ms=cuda_ms(lambda: detector.model(x_det), 10,
                                     queued=False),
            iresnet50_forward_ms=cuda_ms(lambda: embedder.model(x_emb), 10,
                                         queued=False),
            bisenet_forward_ms=cuda_ms(lambda: parser.model(x_par), 10,
                                       queued=False),
            letterbox_ms=host_ms(lambda: detector_letterbox(face, 640), 5),
            imagenet_preprocess_ms=host_ms(
                lambda: imagenet_preprocess(face, 512), 5),
            detect_and_align_ms=host_ms(lambda: detect_and_align(
                levels, x_det[0], (640, 640))[0].cpu(), 5))
    labels = parser(face)
    emb = embedder(face)
    if labels.shape != (512, 512) or labels.dtype != np.uint8 or \
            labels.max() >= 19:
        raise AssertionError(f"label map {labels.shape} {labels.dtype} max "
                             f"{labels.max()}")
    norm = float(np.linalg.norm(emb))
    if emb.shape != (1, 512) or not abs(norm - 1.0) <= 1e-4:
        raise AssertionError(f"embedding {emb.shape}, norm {norm}")
    log(f"perception (fp32, TF32 convolutions): detect "
        f"{times['detect_ms']:.2f}"
        f" ms, embed (detect + align + iresnet50) {times['embed_ms']:.2f} ms,"
        f" parse {times['parse_ms']:.2f} ms (networks alone: SCRFD "
        f"{times['scrfd_forward_ms']:.2f}, iresnet50 "
        f"{times['iresnet50_forward_ms']:.2f}, BiSeNet "
        f"{times['bisenet_forward_ms']:.2f} ms; on the host: letterbox "
        f"{times['letterbox_ms']:.2f}, ImageNet preprocess "
        f"{times['imagenet_preprocess_ms']:.2f}, decode + NMS + align "
        f"{times['detect_and_align_ms']:.2f} ms); {len(np.unique(labels))} "
        f"classes in the label map, embedding norm {norm:.6f}")

    x, _ = detector_letterbox(face, 640)
    pix = imagenet_preprocess(face, 512)
    cpu_states = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in states.items()}
    outs = []
    with tf32_off(), torch.no_grad():
        for device, st in (("cuda", states), ("cpu", cpu_states)):
            det, emb_hook, par = hooks(device, st)
            xt = torch.from_numpy(x).to(device)
            raw = det.model(xt)
            best = int(select_face(flatten_level_outputs(raw),
                                   (640, 640))[0])
            aligned, score, box = det(face)
            logits = par.model.forward_nchw(
                torch.from_numpy(pix).to(device).permute(0, 3, 1, 2))[0]
            outs.append(dict(
                raw={f"{s}/{k}": v.cpu() for s, lv in raw.items()
                     for k, v in lv.items()},
                best=best, aligned=torch.from_numpy(aligned),
                embedding=torch.from_numpy(emb_hook(face)),
                iresnet=emb_hook.model, logits=logits.cpu(),
                labels=logits.argmax(1).cpu()))
        # iresnet50 alone, on the same crop (the CPU's) on both devices
        crop = (outs[1]["aligned"] / 127.5 - 1.0)[None]
        for out in outs:
            dev = next(out["iresnet"].parameters()).device
            out["iresnet"] = out["iresnet"](crop.to(dev)).cpu()
    card, cpu = outs
    # each network on the same input: the SCRFD head maps, BiSeNet's
    # logits, iresnet50's embedding
    nets = {"scrfd_" + k: rel_l2(card["raw"][k], cpu["raw"][k])
            for k in card["raw"]}
    nets.update(iresnet50=rel_l2(card["iresnet"], cpu["iresnet"]),
                bisenet_logits=rel_l2(card["logits"], cpu["logits"]))
    # downstream of the keypoints, which move with the head maps
    chain = dict(aligned=rel_l2(card["aligned"], cpu["aligned"]),
                 embedding=rel_l2(card["embedding"], cpu["embedding"]))
    agreement = (card["labels"] == cpu["labels"]).float().mean().item()
    worst = max(nets, key=nets.get)
    log(f"perception card vs CPU (fp32, TF32 off): networks on the same "
        f"input, worst relative L2 {nets[worst]:.3g} ({worst}; limit "
        f"{PERCEPTION_REL_L2:g}), iresnet50 {nets['iresnet50']:.3g}, BiSeNet "
        f"logits {nets['bisenet_logits']:.3g}; from the keypoints on "
        f"(limit {PERCEPTION_CHAIN_REL_L2:g}): aligned crop "
        f"{chain['aligned']:.3g}, embedder hook {chain['embedding']:.3g}; "
        f"label agreement {agreement:.6f} (limit "
        f"{PERCEPTION_LABEL_AGREEMENT}); chosen slot card {card['best']} / "
        f"CPU {cpu['best']}")
    if not (nets[worst] <= PERCEPTION_REL_L2
            and max(chain.values()) <= PERCEPTION_CHAIN_REL_L2
            and agreement >= PERCEPTION_LABEL_AGREEMENT
            and card["best"] == cpu["best"]):
        raise AssertionError("perception card-vs-CPU check failed")
    readings = {**nets, **chain}
    checker = make_safety_checker(states["safety_checker"])
    return (parser, embedder, checker), dict(
        **times, card_vs_cpu_rel_l2=readings, label_agreement=agreement,
        chosen_slot=card["best"], classes=int(len(np.unique(labels))))


def checker_resize_ms(images) -> dict:
    """ms of the bicubic resize of `images` to 224 (the port's: PIL's
    BICUBIC in integer arithmetic, bit for bit): on the card as the safety
    checker runs it (the host-to-card copy included) and on the host as
    CLIP's preprocessing runs it, beside torch's antialiased bicubic on the
    host (one grey level a pass from PIL's). Fails unless the card's
    result is the host's, bit for bit, for it and for the BILINEAR resize
    (ArcFace's 112 px input, BiSeNet's and the detector's)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from consistentid_torch.utils.image import (resize_bicubic_uint8,
                                                resize_bilinear_uint8)

    def card(resize=resize_bicubic_uint8, size=224):
        x = torch.from_numpy(np.ascontiguousarray(images)).cuda()
        return torch.stack([resize(i, size, size) for i in x])

    for resize, size in ((resize_bicubic_uint8, 224),
                         (resize_bilinear_uint8, 112)):
        host = np.stack([resize(i, size, size) for i in images])
        if not np.array_equal(card(resize, size).cpu().numpy(), host):
            raise AssertionError(f"{resize.__name__} on the card differs "
                                 "from the host's")

    def torch_bicubic():
        for image in images:
            x = torch.from_numpy(np.ascontiguousarray(image))
            x = x.permute(2, 0, 1)[None].float()
            for size in ((x.shape[2], 224), (224, 224)):
                x = F.interpolate(x, size=size, mode="bicubic",
                                  align_corners=False,
                                  antialias=True).round().clamp(0, 255)
            x[0].permute(1, 2, 0).to(torch.uint8).numpy()

    return dict(card=host_ms(card, 5),
                host=host_ms(lambda: [resize_bicubic_uint8(i, 224, 224)
                                      for i in images], 5),
                torch_host=host_ms(torch_bicubic, 5))


def photo_generate(bundle, parser, embedder, checker):
    """The headline request from the photo alone: the serving bundle with
    the face parser, the face embedder and the full-width random safety
    checker (ViT-L/14, 24 layers); no injected labels or embedding."""
    import numpy as np
    import torch
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import synthetic_clip_tokenizer

    pipe = ConsistentIDPipeline(
        bundle, synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(height=512, width=512,
                                       num_inference_steps=50,
                                       start_merge_step=30),
        face_parser=parser, face_embedder=embedder, safety_checker=checker)
    face = face_inputs()[0]
    sample = np.random.RandomState(3).randint(0, 255, (4, 512, 512, 3),
                                              np.uint8)
    checker_ms = host_ms(lambda: checker(sample), 5)
    resize_ms = checker_resize_ms(sample)
    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.generate(PROMPT, face, seed=2, num_images_per_prompt=4)
    seconds = time.perf_counter() - t0
    launches = [w.launches for w in counters]
    by_route = dict(fa.flash_attention_fwd.launches_by_route)
    flags = pipe.last_nsfw_flags
    if out.shape != (4, 512, 512, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    if flags is None or np.asarray(flags).shape != (4,):
        raise AssertionError(f"nsfw flags {flags}")
    if launches != [500, 0, 0, 0, 0] or by_route["sm90"] != 500:
        raise AssertionError(f"launches K1, K2, K3 + K4, K5, K6 {launches} "
                             f"(K1 {by_route}), "
                             "expected K1 500, all on the sm90 route, and "
                             "no other")
    stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
    log(f"generate from the photo (batch 4, 50 DDIM steps, 512 px, parser,"
        f" embedder and safety checker): {seconds:.3f} s, "
        f"{4 / seconds * 60:.2f} images/min, stages ms {stages}; safety "
        f"checker alone (4 images) {checker_ms:.2f} ms; their bicubic "
        f"resize to 224 on the card {resize_ms['card']:.2f} ms, on the host "
        f"{resize_ms['host']:.2f} ms (torch's antialiased bicubic on the "
        f"host {resize_ms['torch_host']:.2f} ms); flags "
        f"{np.asarray(flags).tolist()}; launches K1, K2, K3 + K4, K5, K6 "
        f"{launches} (K1 "
        f"{by_route}); output mean {float(out.mean()):.2f}")
    return dict(seconds=seconds, images_per_min=4 / seconds * 60,
                stage_ms=stages, checker_ms=checker_ms,
                checker_resize_ms=resize_ms, launches=launches,
                launches_by_route=by_route,
                nsfw_flags=np.asarray(flags).tolist())


def build_fp32_dq_variant():
    """The fused backward with dQ's partial sums added in fp32 in arrival
    order (its source with kFixedDq = false): the kernel before dQ was made
    deterministic, timed beside it in `dq_order_phase`. Built by nvcc for
    sm_90a under build/kernels/ like the port's libraries; returns its C
    entry point (ctypes)."""
    import ctypes
    from consistentid_torch.ops import build
    from consistentid_torch.ops import flash_attention as fa
    text = (build.CSRC_DIR / "flash_attention_bwd_sm90.cu").read_text()
    flag = "constexpr bool kFixedDq = true;"
    if flag not in text:
        raise AssertionError(f"{flag!r} not in flash_attention_bwd_sm90.cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "flash_attention_bwd_sm90_fp32_dq.cu"
    src.write_text(text.replace(flag, "constexpr bool kFixedDq = false;"))
    out = src.with_suffix(".so")
    cmd = build.nvcc_command(build.find_nvcc(), [src], out)
    cmd.insert(1, f"-I{build.CSRC_DIR}")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the fp32-dQ variant:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).cid_flash_attention_backward_sm90
    fn.argtypes = fa._SIGNATURES["cid_flash_attention_backward_sm90"][1]
    fn.restype = ctypes.c_int
    return fn


def dq_order_phase(variant):
    """The fused backward (K3 + K4) at the training L0 and L1 (bf16): held
    against the plain backward (`check_backward`'s limits); dq, dk and dv
    the same bits over 50 calls, then over 50 more while a second stream
    runs matmuls (so its CTAs run and finish in other orders); timed in
    turns (this kernel, the fp32-dQ variant, the variant, this kernel)
    beside `build_fp32_dq_variant`, which adds dQ in arrival order."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import KERNEL_REL_L2_16BIT, rel_l2

    gen = torch.Generator("cuda").manual_seed(4)
    rows = []
    for name, shape in (("level0", (2, 8, 4096, 40)),
                        ("level1", (2, 8, 1024, 80))):
        b, h, sq, d = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_lse_plain(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        first, readings = check_backward(f"{name} (dq order)", q, k, v, do,
                                         lse, delta, KERNEL_REL_L2_16BIT)

        def call():
            return fa.flash_attention_bwd(q, k, v, do, lse, delta)

        side = torch.cuda.Stream()
        a = torch.randn((4096, 4096), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        equal = {}
        for busy in (False, True):
            same = True
            for _ in range(50):
                if busy:
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        for _ in range(4):
                            a = (a @ a).clamp(-1.0, 1.0)
                got = call()
                same = same and all(torch.equal(g, f)
                                    for g, f in zip(got, first))
            torch.cuda.synchronize()
            equal["with_busy_stream" if busy else "alone"] = same
        if not all(equal.values()):
            raise AssertionError(f"K3 + K4 {name}: dq, dk, dv not the same "
                                 f"bits over 50 calls: {equal}")
        ws = torch.empty(fa.sm90_bwd_workspace_floats(b * h, sq, d),
                         device="cuda")
        vgrads = [torch.empty_like(t) for t in (q, k, v)]

        def variant_call():
            err = variant(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          *(t.data_ptr() for t in vgrads), ws.data_ptr(),
                          b * h, sq, sq, d, 1.0 / math.sqrt(d),
                          fa._DTYPE_CODES[q.dtype],
                          torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"fp32-dQ variant: CUDA error {err}")

        variant_call()
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta)
        variant_rel = max(rel_l2(g, r) for g, r in zip(vgrads, ref))
        check(f"K3 + K4 {name} fp32-dQ variant", variant_rel, None,
              KERNEL_REL_L2_16BIT)
        turns = [cuda_ms(call, 20), cuda_ms(variant_call, 20),
                 cuda_ms(variant_call, 20), cuda_ms(call, 20)]
        ms, variant_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        row = dict(case=name, shape=list(shape), bit_equal_over_50=equal,
                   rel_l2=readings["rel_l2"],
                   same_precision_rel_l2=readings["same_precision_rel_l2"],
                   fp32_dq_rel_l2=variant_rel, ms=ms, fp32_dq_ms=variant_ms,
                   turns_ms=turns)
        rows.append(row)
        log(f"dq order {name} {b}x{h}x{sq}x{d} bf16: dq, dk, dv the same "
            f"bits over 50 calls {equal}; rel_l2 {readings['rel_l2']:.3g}, "
            f"at its own precision {readings['same_precision_rel_l2']:.3g}; "
            f"fixed-point dQ {ms:.4f} ms, fp32 dQ in arrival order "
            f"{variant_ms:.4f} ms (turns {[round(t, 4) for t in turns]})")
        del q, k, v, do, out, lse, delta, first, a, ws, vgrads, ref
    return rows


def write_checkpoint_set(bundle, hooks, outdir):
    """The serving bundle and the perception models, random full-width
    weights, written as a reference-layout SD1.5 set in fp16 (as diffusers
    dumps ship) with the port's exporters."""
    from consistentid_torch.io.export import write_reference_checkpoints
    from consistentid_torch.testing import synthetic_clip_tokenizer
    parser, embedder, checker = hooks
    t0 = time.perf_counter()
    paths, nbytes = write_reference_checkpoints(
        outdir, bundle, parser=parser.model, embedder=embedder.model,
        detector=embedder.detector.model, safety_checker=checker.model,
        vocab=synthetic_clip_tokenizer().encoder)
    seconds = time.perf_counter() - t0
    log(f"checkpoint set: {nbytes} bytes ({nbytes / 2 ** 30:.2f} GiB) fp16 "
        f"in {seconds:.1f} s: {sorted(paths)}")
    return paths, dict(bytes=nbytes, write_s=seconds)


def load_phase(bundle, hooks, paths):
    """`load_sd15_consistentid` (and its `load_face_stack`) on the written
    set, on the card; every loaded tensor against the one written, the
    same bits after the fp16 cast (x.to(fp16).to(its dtype))."""
    import torch
    from consistentid_torch.pipelines.loading import load_sd15_consistentid
    kw = {k: v for k, v in paths.items() if k != "base"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = load_sd15_consistentid(paths["base"], device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    parser, embedder, checker = hooks
    pairs = {"bundle": (pipe.bundle, bundle),
             "parser": (pipe.face_parser.model, parser.model),
             "embedder": (pipe.face_embedder.model, embedder.model),
             "detector": (pipe.face_embedder.detector.model,
                          embedder.detector.model),
             "safety_checker": (pipe.safety_checker.model, checker.model)}
    counts, bad = {}, []
    for name, (got_m, src_m) in pairs.items():
        got, src = got_m.state_dict(), src_m.state_dict()
        if set(got) != set(src):
            raise AssertionError(f"load {name}: tensors {set(got) ^ set(src)}")
        floats = [k for k in src if src[k].is_floating_point()]
        for key in floats:
            want = src[key].to(torch.float16).to(got[key].dtype)
            if not torch.equal(got[key], want.to(got[key].device)):
                bad.append(f"{name}.{key}")
        counts[name] = len(floats)
    if bad:
        raise AssertionError(f"loaded tensors differ from the written ones: "
                             f"{bad[:8]} ({len(bad)} in all)")
    log(f"load: load_sd15_consistentid + load_face_stack on the card in "
        f"{seconds:.2f} s; every tensor the written bits after the fp16 "
        f"cast: {counts}")
    del pipe
    torch.cuda.empty_cache()
    return dict(load_s=seconds, tensors=counts)


def infer_phase(paths, outdir):
    """`apps.infer.main` on the written set at the JAX defaults (Euler, 50
    steps, 768x512, CFG 5, seed 2024), from a PNG face, with SCRFD,
    ArcFace, BiSeNet and the safety checker: the PNG it writes decodes to
    (768, 512, 3) uint8; K1 launched 500 times, all on the sm90 route; the
    same request through `generate(return_float=True)` is finite and, the
    safety checker not flagging it, the PNG's pixels within one grey
    level."""
    import numpy as np
    import torch
    from consistentid_torch.apps import infer
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.utils.image import to_uint8
    from consistentid_torch.utils.png import decode_png, encode_png

    face = face_inputs()[0]
    face_path = str(Path(outdir) / "face.png")
    with open(face_path, "wb") as f:
        f.write(encode_png(face))
    out = str(Path(outdir) / "infer.png")
    argv = ["--base", paths["base"],
            "--consistentid", paths["consistentid_path"],
            "--image-encoder", paths["image_encoder_path"],
            "--bisenet", paths["bisenet_path"],
            "--arcface", paths["arcface_path"],
            "--scrfd", paths["scrfd_path"],
            "--image", face_path, "--prompt", PROMPT, "--out", out]
    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = infer.main(argv)
    seconds = time.perf_counter() - t0
    launches = [w.launches for w in counters]
    by_route = dict(fa.flash_attention_fwd.launches_by_route)
    stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
    flags = np.asarray(pipe.last_nsfw_flags).tolist()
    with open(out, "rb") as f:
        png = decode_png(f.read())
    if png.shape != (768, 512, 3) or png.dtype != np.uint8:
        raise AssertionError(f"infer PNG {png.shape} {png.dtype}")
    if launches != [500, 0, 0, 0, 0] or by_route["sm90"] != 500:
        raise AssertionError(f"infer: launches K1, K2, K3 + K4, K5, K6 "
                             f"{launches} (K1 {by_route}), expected K1 500 "
                             "(10 per UNet call x 50 steps) on sm90 only")
    negative = infer.build_parser().get_default("negative_prompt")
    images = pipe.generate(PROMPT, face, negative_prompt=negative,
                           seed=2024, return_float=True)
    if not torch.isfinite(images.float()).all():
        raise AssertionError("infer: non-finite decoded images")
    diff = None
    if not any(flags):  # a flagged image is written black
        diff = int(np.abs(to_uint8(images)[0].cpu().numpy().astype(int)
                          - png).max())
        if diff > 1:
            raise AssertionError(f"infer: the PNG is off the request's "
                                 f"image by {diff} grey levels")
    log(f"infer CLI (Euler, 50 steps, 768x512, CFG 5, seed 2024, SCRFD + "
        f"ArcFace + BiSeNet + safety checker): {seconds:.3f} s with the "
        f"load, stages ms {stages}, flags {flags}, K1 launches {launches[0]}"
        f" {by_route}; PNG {png.shape}, off the float path's pixels by "
        f"{diff} grey levels")
    return pipe, dict(seconds=seconds, stage_ms=stages, launches=launches[0],
                      launches_by_route=by_route, nsfw_flags=flags,
                      png_vs_float_path_max_diff=diff)


def samplers_phase(pipe):
    """The five samplers at full width through `generate_batch` (batch 1,
    512 px, 8 steps): finite images; DDPM's with one seed the same bits
    twice; Euler's request 0 of a batch of 2 against the request alone
    (the uint8 difference recorded, not held: bf16 products of another
    batch size may tile differently)."""
    import numpy as np
    import torch
    from consistentid_torch.apps.infer import SCHEDULERS

    face = face_inputs()[0]
    face2 = np.ascontiguousarray(face[:, ::-1])
    kw = dict(height=512, width=512, num_inference_steps=8)
    stats = {}
    for name in SCHEDULERS:
        t0 = time.perf_counter()
        img = pipe.generate_batch([PROMPT], [face], seeds=[7],
                                  scheduler=name, return_float=True, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(img.float()).all():
            raise AssertionError(f"sampler {name}: non-finite images")
        stats[name] = dict(s=time.perf_counter() - t0,
                           std=float(img.float().std()))
        if name == "ddpm":
            again = pipe.generate_batch([PROMPT], [face], seeds=[7],
                                        scheduler=name, return_float=True,
                                        **kw)
            if not torch.equal(img, again):
                raise AssertionError("ddpm: one seed, other bits")
    pair = pipe.generate_batch([PROMPT, PROMPT], [face, face2], seeds=[7, 8],
                               scheduler="euler", **kw)
    alone = pipe.generate_batch([PROMPT], [face], seeds=[7],
                                scheduler="euler", **kw)
    diff = int(np.abs(pair[0].astype(int) - alone[0]).max())
    log(f"samplers (batch 1, 512 px, 8 steps): {stats}; ddpm the same bits "
        f"twice; euler request 0 of 2 against alone: max uint8 difference "
        f"{diff}")
    return dict(samplers=stats, euler_batch_vs_alone_max_diff=diff)


def serve_phase(pipe):
    """`apps.serve.serve` on 127.0.0.1 (a free port) over the loaded
    pipeline at 512 px, 50 DDIM steps, max batch 4: buckets 1, 2 and 4
    warmed; 6 concurrent /generate requests (PNG faces, their own seeds)
    each answered 200 with a (512, 512, 3) PNG, in at least 2 batches
    (/healthz); a malformed body 400, an oversized image 400 or 413."""
    import base64
    import json
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    import torch
    from consistentid_torch.apps.serve import serve
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.utils.png import decode_png, encode_png

    serving = ConsistentIDPipeline(
        pipe.bundle, pipe.tokenizer,
        pipeline_config=PipelineConfig(height=512, width=512,
                                       num_inference_steps=50,
                                       start_merge_step=30,
                                       scheduler="ddim"),
        face_parser=pipe.face_parser, face_embedder=pipe.face_embedder,
        safety_checker=pipe.safety_checker)
    server, batcher = serve(serving, port=0, max_batch=4, window_ms=200)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(body: bytes):
        req = urllib.request.Request(url + "/generate", data=body)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                code, payload = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, payload = e.code, json.loads(e.read())
        return code, payload, time.perf_counter() - t0

    def health():
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            return json.loads(r.read())

    try:
        t0 = time.perf_counter()
        batcher.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        face = face_inputs()[0]
        rng = np.random.RandomState(5)
        bodies = [json.dumps({
            "prompt": PROMPT, "seed": 100 + i,
            "image_b64": base64.b64encode(encode_png(np.clip(
                face.astype(int) + rng.randint(-8, 9, face.shape), 0, 255)
                .astype(np.uint8))).decode()}).encode() for i in range(6)]
        before = health()
        counters = launch_counters() + bn_counters()
        fa.reset_launches(*counters)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(6) as pool:
            replies = list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
        after = health()
        launches = [w.launches for w in counters]
        batches = after["batches"] - before["batches"]
        requests = after["requests"] - before["requests"]
        sizes = []
        for code, payload, _ in replies:
            if code != 200:
                raise AssertionError(f"serve: reply {code} {payload}")
            img = decode_png(base64.b64decode(payload["image_b64"]))
            if img.shape != (512, 512, 3):
                raise AssertionError(f"serve: image {img.shape}")
            sizes.append(payload["batch_size"])
        if requests != 6 or batches < 2:
            raise AssertionError(f"serve: {requests} requests in {batches} "
                                 "batches, expected 6 in at least 2")
        if launches[1:] != [0, 0, 0, 0] or launches[0] != 500 * batches:
            raise AssertionError(f"serve: launches K1, K2, K3 + K4, K5, K6 "
                                 f"{launches}, expected K1 500 per batch")
        bad = post(b"{not json")[0]
        huge = post(json.dumps({"prompt": "x", "image_b64": base64.b64encode(
            encode_png(np.zeros((8, 5000, 3), np.uint8))).decode()})
            .encode())[0]
        if bad != 400 or huge not in (400, 413):
            raise AssertionError(f"serve: malformed body {bad}, oversized "
                                 f"image {huge}")
        latency = [r[2] for r in replies]
        log(f"serve (512 px, 50 DDIM steps, max batch 4; buckets warmed in "
            f"{warm_s:.1f} s): 6 concurrent requests in {wall:.2f} s = "
            f"{6 / wall * 60:.2f} requests/min, per request "
            f"{[round(x, 2) for x in latency]} s, {batches} batches "
            f"(sizes {sizes}), K1 {launches[0] // batches} launches per "
            f"batch; malformed body {bad}, oversized image {huge}")
        return dict(warmup_s=warm_s, wall_s=wall,
                    requests_per_min=6 / wall * 60, request_s=latency,
                    batches=batches, batch_sizes=sizes,
                    k1_launches_per_batch=launches[0] // batches,
                    malformed_code=bad, oversized_code=huge)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


# ---------------------------------------------------------------- demos

def stand_in_gradio():
    """A `gradio` module for `apps.demo.main` on a machine without gradio:
    each widget and the Interface record their arguments (the Interface
    itself in `interfaces`) and `launch` returns at once. It stands for
    the UI toolkit only; the pipeline, the card and its kernels are the
    real ones."""
    import types
    gr = types.ModuleType("gradio")
    gr.interfaces = []

    class Widget:
        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs

    for name in ("Image", "Textbox", "Slider", "Number"):
        setattr(gr, name, type(name, (Widget,), {}))

    class Interface(Widget):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.launched = None
            gr.interfaces.append(self)

        def launch(self, **kwargs):
            self.launched = kwargs

    gr.Interface = Interface
    return gr


def run_example(script: str, *argv):
    """examples/<script> through runpy, as `python examples/<script>
    --device cuda <argv>` runs it, its main's return value kept (runpy
    under another name, then its main with that argv)."""
    import runpy
    namespace = runpy.run_path(str(REPO / "examples" / script),
                               run_name="example_twin")
    old = sys.argv
    sys.argv = [script, "--device", "cuda", *argv]
    try:
        return namespace["main"]()
    finally:
        sys.argv = old


def demos_phase(paths, outdir):
    """The gradio demo and the examples' twins on the card. (a)
    `apps.demo.main` on the written set (SCRFD, ArcFace, BiSeNet, the
    safety checker) under a stand-in gradio: one request through the
    interface's callback at the UI's defaults (50 DDIM steps, merge 30,
    CFG 5, seed 2024, 512 px) from the 512 px face: a (512, 512, 3) uint8
    image within one grey level of `pipe.generate` with the same arguments,
    K1 500 on sm90. (b) examples/minimal_demo_torch.py (tiny fp32 bundle,
    64 px, 4 steps: the level-0 self-attention's 1024 tokens cross the
    flash cutover, K1 12 on the f32 route; one train step at 32 px, under
    it) and controlnet_demo_torch.py (K1 16 on f32: 3 UNet and 1 ControlNet
    attention a step), and inpaint_demo_torch.py --full-size on the set
    from PNG files (the face parsed by BiSeNet, embedded by SCRFD and
    ArcFace; 512 px, strength 1, 50 DDIM steps: K1 500 on sm90)."""
    import math
    import numpy as np
    from consistentid_torch.apps import demo
    from consistentid_torch.utils.png import decode_png, encode_png

    face = face_inputs()[0]
    set_flags = ["--consistentid", paths["consistentid_path"],
            "--image-encoder", paths["image_encoder_path"],
            "--bisenet", paths["bisenet_path"],
            "--arcface", paths["arcface_path"],
            "--scrfd", paths["scrfd_path"]]
    gr = stand_in_gradio()
    sys.modules["gradio"] = gr
    try:
        t0 = time.perf_counter()
        pipe = demo.main(["--base", paths["base"], *set_flags])
        load_s = time.perf_counter() - t0
    finally:
        del sys.modules["gradio"]
    iface, = gr.interfaces
    ui = {w.kwargs["label"]: w.kwargs.get("value")
          for w in iface.kwargs["inputs"][1:]}
    request = (ui["negative prompt"], ui["steps"], ui["start merge step"],
               ui["guidance scale"], ui["seed"])
    if request != ("", 50, 30, 5.0, 2024) or iface.launched != {
            "server_port": 7860}:
        raise AssertionError(f"demo: UI defaults {request}, launch "
                             f"{iface.launched}")
    img, request_s, launches, by_route = counted(
        lambda: iface.kwargs["fn"](face, PROMPT, *request))
    expect_k1("demo request", launches, by_route, 500)
    flags = np.asarray(pipe.last_nsfw_flags).tolist()
    if img.shape != (512, 512, 3) or img.dtype != np.uint8:
        raise AssertionError(f"demo: image {img.shape} {img.dtype}")
    want, generate_s, _, _ = counted(lambda: pipe.generate(
        PROMPT, face, negative_prompt="", num_inference_steps=50,
        start_merge_step=30, guidance_scale=5.0, seed=2024)[0])
    diff = int(np.abs(img.astype(int) - want.astype(int)).max())
    if diff > 1:
        raise AssertionError(f"demo: the request's image is off generate's "
                             f"by {diff} grey levels")
    stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
    log(f"demo (apps.demo.main, stand-in gradio; ddim, 50 steps, 512 px, "
        f"CFG 5, merge 30, seed 2024, from the photo): load {load_s:.2f} s; "
        f"request {request_s:.3f} s, generate {generate_s:.3f} s, stages ms "
        f"{stages}, flags {flags}, K1 {launches[0]} {by_route}; off "
        f"generate's image by {diff} grey levels "
        f"({'exact' if diff == 0 else 'not exact'})")
    out = dict(demo=dict(load_s=load_s, request_s=request_s,
                         generate_s=generate_s, stage_ms=stages,
                         launches=launches[0], launches_by_route=by_route,
                         nsfw_flags=flags, max_diff_vs_generate=diff))
    del pipe, iface, gr
    gc.collect()

    twins = {}
    png = str(Path(outdir) / "minimal.png")
    metrics, s, launches, by_route = counted(lambda: run_example(
        "minimal_demo_torch.py", "--out", png))
    twins["minimal"] = dict(seconds=s, launches=launches,
                            launches_by_route=by_route, loss=metrics["loss"])
    if not math.isfinite(metrics["loss"]):
        raise AssertionError(f"minimal twin: loss {metrics['loss']}")
    png = str(Path(outdir) / "controlnet.png")
    _, s, launches, by_route = counted(lambda: run_example(
        "controlnet_demo_torch.py", "--out", png))
    twins["controlnet"] = dict(seconds=s, launches=launches,
                               launches_by_route=by_route)
    files = {}
    for name, arr in zip(("init", "mask"), init_image_inputs(512, 512)):
        files[name] = str(Path(outdir) / f"twin_{name}.png")
        with open(files[name], "wb") as f:
            f.write(encode_png(arr))
    png = str(Path(outdir) / "inpaint.png")
    pipe, s, launches, by_route = counted(lambda: run_example(
        "inpaint_demo_torch.py", "--full-size", "--base", paths["base"],
        *set_flags, "--image", str(Path(outdir) / "face.png"), "--init-image",
        files["init"], "--mask-image", files["mask"], "--strength", "1.0",
        "--out", png))
    twins["inpaint"] = dict(
        seconds=s, launches=launches, launches_by_route=by_route,
        stage_ms={k: round(v, 1) for k, v in pipe.last_stage_ms.items()})
    del pipe
    gc.collect()
    for name, n, route, size in (("minimal", 12, "f32", 64),
                                 ("controlnet", 16, "f32", 64),
                                 ("inpaint", 500, "sm90", 512)):
        r = twins[name]
        with open(str(Path(outdir) / f"{name}.png"), "rb") as f:
            r["png_shape"] = list(decode_png(f.read()).shape)
        if r["png_shape"] != [size, size, 3]:
            raise AssertionError(f"{name} twin: PNG {r['png_shape']}")
        if (r["launches"] != [n, 0, 0, 0, 0]
                or r["launches_by_route"][route] != n):
            raise AssertionError(
                f"{name} twin: launches K1, K2, K3 + K4, K5, K6 "
                f"{r['launches']} (K1 {r['launches_by_route']}), expected "
                f"K1 {n} on {route} only")
        log(f"{name} twin (--device cuda): {r['seconds']:.3f} s with its "
            f"build or load, PNG {r['png_shape']}, K1 {r['launches'][0]} "
            f"{r['launches_by_route']}"
            + (f", loss {r['loss']:.5f}" if "loss" in r else "")
            + (f", stages ms {r['stage_ms']}" if "stage_ms" in r else ""))
    out["twins"] = twins
    return out


SDXL_K1_PER_UNET_CALL = 70   # 10 at level 1 (X1), 60 at level 2 and mid (X2)


def sdxl_vocab():
    """The synthetic byte-level vocab with eos at CLIP's id 49407, where
    the text towers read the pooled state (models/clip.py), so that each
    prompt gets its own pooled embedding."""
    from consistentid_torch.testing import synthetic_clip_tokenizer
    return {**synthetic_clip_tokenizer().encoder, "<|endoftext|>": 49407}


def sdxl_tokenizers():
    """The SDXL vocab as SDXL's two tokenizers: the first pads with eos,
    the second with "!" (id 0), as its dump declares."""
    from consistentid_torch.conditioning import CLIPBPETokenizer
    vocab = sdxl_vocab()
    return (CLIPBPETokenizer(vocab, []),
            CLIPBPETokenizer(vocab, [], pad_token="!"))


def sdxl_pooled_check(pipe, face, **kw):
    """The pooled embeddings of one request on the card, each read at its
    prompt's eos: both branches' positives finite and distinct from the
    shared negative, the one tensor both branches hold. The two positives
    are tower outputs of the same ids (the text-only prompt is the facial
    one without its trigger tokens, which the facial ids drop), as in the
    reference, so they are only reported."""
    import torch
    cond = pipe.device_cond(pipe.prepare_conditioning(PROMPT, face, **kw))
    text, facial = pipe.encode_embeddings_xl(cond)
    if text.pooled_null is not facial.pooled_null:
        raise AssertionError("SDXL: the branches' negative pooled "
                             "embeddings are not the one shared tensor")
    same_ids = bool(torch.equal(cond["clean_ids2"], cond["text_only_ids2"]))
    diffs = {}
    for name, a, b in (("facial vs negative", facial.pooled,
                        facial.pooled_null),
                       ("text vs negative", text.pooled, text.pooled_null),
                       ("facial vs text", facial.pooled, text.pooled)):
        diffs[name] = float((a.float() - b.float()).abs().max())
        if not torch.isfinite(a).all() or (
                diffs[name] == 0.0 and name != "facial vs text"):
            raise AssertionError(f"SDXL pooled embeddings {name}: max abs "
                                 f"difference {diffs[name]} (0 when every "
                                 "prompt is pooled at one position)")
    log("SDXL pooled embeddings, max abs difference: "
        + ", ".join(f"{k} {v:.4g}" for k, v in diffs.items())
        + f"; facial and text-only ids2 the same: {same_ids}")
    return dict(diffs, same_ids=same_ids)


def sdxl_attention_check(unet):
    """One level-1 (X1) and one level-2 (X2) self-attention of the SDXL
    UNet on the card: the block's own projections of a unit-normal hidden
    state through the dispatch (one K1 launch on sm90 each), held against
    reference_attention on the same q, k, v at the 16-bit limit with the
    dropped-tile control."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.ops.attention import (dot_product_attention,
                                                  reference_attention,
                                                  split_heads)
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            drop_last_tile, rel_l2)

    gen = torch.Generator("cuda").manual_seed(11)
    rows = []
    for name, attn, tokens in (
            ("level1", unet.down_1_attn_0.blocks_0.attn1, 4096),
            ("level2", unet.down_2_attn_0.blocks_0.attn1, 1024)):
        dim = attn.to_q.in_features
        x = torch.randn((2, tokens, dim), generator=gen, device="cuda",
                        dtype=attn.to_q.weight.dtype)
        with torch.no_grad():
            q, k, v = (split_heads(getattr(attn, p)(x), attn.heads)
                       for p in ("to_q", "to_k", "to_v"))
            out = counted_call(fa.flash_attention_fwd,
                               lambda: dot_product_attention(q, k, v),
                               "sm90")
            ref = reference_attention(q, k, v)
            cut = drop_last_tile(tokens)
            control = rel_l2(reference_attention(q, k[:, :, :cut],
                                                 v[:, :, :cut]), ref)
        rel = rel_l2(out, ref)
        check(f"SDXL UNet {name} self-attention through K1", rel, control,
              KERNEL_REL_L2_16BIT)
        rows.append(dict(block=name, shape=list(q.shape), rel_l2=rel,
                         control_rel_l2=control))
        log(f"SDXL UNet {name} self-attention {tuple(q.shape)} through the "
            f"dispatch (K1 sm90) vs reference_attention: rel_l2 {rel:.3g} "
            f"(limit {KERNEL_REL_L2_16BIT:g}; control {control:.3g})")
    return rows


def sdxl_path():
    """The SDXL main path: a full-width SDXL ConsistentID bundle (UNet of
    sdxl_unet_config with LoRA rank 128 and 4 IP tokens, CLIP-L and bigG,
    ViT-H, the SDXL VAE decoding in fp32, sdxl_adapter_config; bf16,
    N(0, 0.02) weights from a seeded generator) runs generate() at the
    SDXL pipeline's defaults (1024x1024, 50 DDIM steps, CFG 7.5, merge step
    30), one image; checks the image, 3500 K1 launches all on sm90 and no
    other kernel; the real UNet's level-1 and level-2 attention against
    reference_attention; a batch of 2 with distinct seeds whose request 0
    is the request alone within one grey level; one UNet call under
    torch.profiler."""
    import numpy as np
    import torch
    from consistentid_torch.core import VAEConfig, sdxl_unet_config
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.pipelines import (ConsistentIDXLPipeline,
                                              SDXLBundle, sdxl_adapter_config)
    from consistentid_torch.utils.image import to_uint8

    t0 = time.perf_counter()
    bundle = SDXLBundle(
        sdxl_unet_config(lora_rank=128, ip_num_tokens=4),
        sdxl_adapter_config(num_id_tokens=4),
        vae_config=VAEConfig(scaling_factor=0.13025, force_upcast=True),
        dtype=torch.bfloat16, device="cuda")
    bundle.random_params(torch.Generator("cuda").manual_seed(0))
    on_cpu = [n for n, p in bundle.named_parameters() if not p.is_cuda]
    if on_cpu:
        raise AssertionError(f"SDXL parameters on the CPU: {on_cpu[:5]}")
    n_params = sum(p.numel() for p in bundle.parameters())
    tok, tok2 = sdxl_tokenizers()
    pipe = ConsistentIDXLPipeline(bundle, tok, tokenizer_2=tok2)
    torch.cuda.synchronize()
    parts = {name: sum(p.numel() for p in getattr(bundle, name).parameters())
             / 1e9 for name in ("unet", "text_encoder_2", "image_encoder")}
    log(f"SDXL bundle: {n_params / 1e9:.3f} B params bf16 ("
        + ", ".join(f"{k} {v:.3f} B" for k, v in parts.items())
        + f"), built in {time.perf_counter() - t0:.1f} s; config "
        f"{pipe.config}")
    face, labels, faceid = face_inputs()
    kw = dict(parsing_labels=labels, faceid_embeds=faceid)
    pooled = sdxl_pooled_check(pipe, face, **kw)

    t0 = time.perf_counter()
    pipe.generate(PROMPT, face, seed=0, num_inference_steps=2, **kw)
    torch.cuda.synchronize()
    log(f"SDXL warm-up generate (2 steps): {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPT, face, seed=1, return_float=True, **kw)
    out = to_uint8(images).cpu().numpy()
    seconds = time.perf_counter() - t0
    launches = [w.launches for w in counters]
    by_route = dict(fa.flash_attention_fwd.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = SDXL_K1_PER_UNET_CALL * 50
    if out.shape != (1, 1024, 1024, 3) or out.dtype != np.uint8:
        raise AssertionError(f"SDXL output {out.shape} {out.dtype}")
    if images.device.type != "cuda" or images.dtype != torch.float32:
        raise AssertionError(f"SDXL decode {images.device} {images.dtype}, "
                             "expected fp32 on the card")
    if not torch.isfinite(images).all():
        raise AssertionError("SDXL: non-finite decoded images")
    if launches != [expected, 0, 0, 0, 0] or by_route["sm90"] != expected:
        raise AssertionError(f"SDXL: launches K1, K2, K3 + K4, K5, K6 "
                             f"{launches} (K1 {by_route}), expected K1 "
                             f"{expected} (70 per UNet call x 50 steps) on "
                             "sm90 only")
    stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
    log(f"SDXL generate (1 image, 1024x1024, 50 DDIM steps, CFG 7.5, merge "
        f"step 30): {seconds:.3f} s, stages ms {stages}, denoise "
        f"{stages['denoise'] / 50:.1f} ms/step, peak memory {peak_gib:.2f} "
        f"GiB, K1 launches {launches[0]} (expected {expected}) {by_route}, "
        f"image std {float(images.std()):.4f}")

    unet = bundle.infer_unet(1.0)
    attention = sdxl_attention_check(unet)
    del unet

    face2 = np.ascontiguousarray(face[:, ::-1])
    t0 = time.perf_counter()
    pair = pipe.generate_batch(
        [PROMPT, "a woman in a garden"], [face, face2], seeds=[1, 5],
        parsing_labels_list=[labels, np.ascontiguousarray(labels[:, ::-1])],
        faceid_embeds_list=[faceid, -faceid])
    pair_s = time.perf_counter() - t0
    diff = int(np.abs(pair[0].astype(int) - out[0]).max())
    log(f"SDXL generate_batch (2 requests, seeds 1 and 5): {pair_s:.3f} s; "
        f"request 0 against the request alone: max uint8 difference {diff} "
        f"(allowed 1)")
    if pair.shape != (2, 1024, 1024, 3) or diff > 1:
        raise AssertionError(f"SDXL batch of 2: {pair.shape}, request 0 off "
                             f"the request alone by {diff} grey levels")

    deepcache = sdxl_deepcache(pipe, face, kw, out.astype(int))
    int8_static = sdxl_int8_static(pipe, face, kw, out.astype(int))

    gen = torch.Generator("cuda").manual_seed(4)
    inputs = (torch.randn((2, 128, 128, 4), generator=gen, device="cuda"),
              torch.full((2,), 501.0, device="cuda"),
              torch.randn((2, 81, 2048), generator=gen, device="cuda"),
              {"text_embeds": torch.randn((2, 1280), generator=gen,
                                          device="cuda"),
               "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]],
                                        device="cuda").repeat(2, 1)})
    profile = profile_unet(bundle, inputs=inputs,
                           label="SDXL bf16, batch 2, 128x128 latents")
    return bundle, dict(
        seconds=seconds, stage_ms=stages, denoise_ms_per_step=(
            stages["denoise"] / 50), peak_gib=peak_gib,
        params_b=n_params / 1e9, launches=launches[0],
        expected_launches=expected, launches_by_route=by_route,
        attention_checks=attention, batch2_s=pair_s,
        batch2_vs_alone_max_diff=diff, pooled_max_abs_diff=pooled,
        unet_profile=profile, deepcache=deepcache, int8_static=int8_static)


def sdxl_infer_phase(bundle, sd15_paths, outdir):
    """`apps.infer.main --sdxl` at 1024x1024, CFG 7.5 (Euler, 50 steps,
    seed 2024) from the PNG face the SD1.5 infer phase wrote, with SCRFD,
    ArcFace and BiSeNet: the SD1.5 dump is deleted first, the SDXL bundle
    written as a reference-layout SDXL set in fp16 beside the image
    encoder and face packs already written (reused); a (1024, 1024, 3)
    PNG, 3500 K1 launches on sm90 only, the float path finite and within
    one grey level of the PNG."""
    import numpy as np
    import torch
    from consistentid_torch.apps import infer
    from consistentid_torch.io.export import write_reference_checkpoints
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.utils.image import to_uint8
    from consistentid_torch.utils.png import decode_png

    shutil.rmtree(sd15_paths["base"])
    t0 = time.perf_counter()
    paths, nbytes = write_reference_checkpoints(
        outdir, bundle, vocab=sdxl_vocab(), image_encoder=False)
    write_s = time.perf_counter() - t0
    log(f"SDXL checkpoint set: {nbytes} bytes ({nbytes / 2 ** 30:.2f} GiB) "
        f"fp16 in {write_s:.1f} s: {sorted(paths)}")
    face_path = str(Path(outdir) / "face.png")
    out = str(Path(outdir) / "infer_sdxl.png")
    argv = ["--sdxl", "--base", paths["base"],
            "--consistentid", paths["consistentid_path"],
            "--image-encoder", sd15_paths["image_encoder_path"],
            "--bisenet", sd15_paths["bisenet_path"],
            "--arcface", sd15_paths["arcface_path"],
            "--scrfd", sd15_paths["scrfd_path"],
            "--height", "1024", "--width", "1024", "--guidance-scale", "7.5",
            "--image", face_path, "--prompt", PROMPT, "--out", out]
    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = infer.main(argv)
    seconds = time.perf_counter() - t0
    launches = [w.launches for w in counters]
    by_route = dict(fa.flash_attention_fwd.launches_by_route)
    stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
    load_s = seconds - sum(pipe.last_stage_ms.values()) / 1e3
    expected = SDXL_K1_PER_UNET_CALL * 50
    with open(out, "rb") as f:
        png = decode_png(f.read())
    if png.shape != (1024, 1024, 3) or png.dtype != np.uint8:
        raise AssertionError(f"SDXL infer PNG {png.shape} {png.dtype}")
    if launches != [expected, 0, 0, 0, 0] or by_route["sm90"] != expected:
        raise AssertionError(f"SDXL infer: launches K1, K2, K3 + K4, K5, K6 "
                             f"{launches} (K1 {by_route}), expected K1 "
                             f"{expected} on sm90 only")
    negative = infer.build_parser().get_default("negative_prompt")
    face = decode_png(open(face_path, "rb").read())
    images = pipe.generate(PROMPT, face, negative_prompt=negative,
                           seed=2024, return_float=True)
    if not torch.isfinite(images.float()).all():
        raise AssertionError("SDXL infer: non-finite decoded images")
    diff = int(np.abs(to_uint8(images)[0].cpu().numpy().astype(int)
                      - png).max())
    if diff > 1:
        raise AssertionError(f"SDXL infer: the PNG is off the request's "
                             f"image by {diff} grey levels")
    log(f"SDXL infer CLI (--sdxl, Euler, 50 steps, 1024x1024, CFG 7.5, seed "
        f"2024, SCRFD + ArcFace + BiSeNet): {seconds:.3f} s with the load "
        f"(load and host work about {load_s:.2f} s), stages ms {stages}, K1 "
        f"launches {launches[0]} {by_route}; PNG {png.shape}, off the float "
        f"path's pixels by {diff} grey levels")
    del pipe
    torch.cuda.empty_cache()
    return dict(bytes=nbytes, write_s=write_s, call_s=seconds,
                load_s=load_s, stage_ms=stages, launches=launches[0],
                launches_by_route=by_route, png_vs_float_path_max_diff=diff)


def state_snapshot(state):
    """A copy of a TrainState's state_dict (masters, AdamW moments and
    count, step) to restore it from."""
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v) for k, v in state.state_dict().items()}


def flash_self_attentions(unet, latent_hw: int, capture_layers):
    """K2 calls of one UNet forward under autograd, worked out from the
    UNet: one per transformer layer whose self-attention reaches the flash
    cutover (Sq * Sk >= FLASH_MIN_ELEMS), and how many of them are in blocks
    that rematerialisation recomputes (every block but those whose
    attention probabilities are captured)."""
    from consistentid_torch.models.layers import Transformer2D
    from consistentid_torch.ops.attention import FLASH_MIN_ELEMS
    n = len(unet.config.block_out_channels)
    total = recomputed = 0
    for name, mod in unet.named_children():
        if not isinstance(mod, Transformer2D):
            continue
        if name == "mid_attn":
            level, group = n - 1, "mid"
        elif name.startswith("down_"):
            level = int(name.split("_")[1])
            group = f"down_{level}"
        else:
            i = int(name.split("_")[1])
            level, group = n - 1 - i, f"up_{i}"
        tokens = (latent_hw // 2 ** level) ** 2
        if tokens * tokens < FLASH_MIN_ELEMS:
            continue
        total += mod.depth
        if group not in capture_layers:
            recomputed += mod.depth
    return total, recomputed


def profile_step(step, state, batch, gen, label, top: int = 14):
    """Device time of one training step by kernel (torch.profiler), and the
    share of the step's wall time the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not device_ms > 0:
        raise AssertionError("the profiler recorded no device time")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [dict(kernel=e.key[:90], calls=e.count,
                 ms=e.self_device_time_total / 1e3,
                 share=e.self_device_time_total / 1e3 / device_ms)
            for e in kernels[:top]]
    log(f"train step profile ({label}): wall {wall_ms:.3f} ms under the "
        f"profiler, device busy {device_ms:.3f} ms "
        f"({device_ms / wall_ms:.1%})")
    for r in rows:
        log(f"  {r['ms']:9.3f} ms {r['share']:6.1%} x{r['calls']:<4d} "
            f"{r['kernel']}")
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, top=rows)


def fp32_attention(q, k, v):
    """Differentiable attention in fp32 throughout, the output in q's
    dtype: the plain autograd the kernels' gradients are held against."""
    import torch
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def sdxl_train_attention_check(unet):
    """One level-1 (T1) and one level-2 (T2) self-attention of the SDXL
    UNet under autograd on the card: the block's own projections (LoRA
    included) of a unit-normal hidden state (batch 1, 1024 px) through the
    dispatch, which runs the flash Function (one K2 and one K3 + K4 launch
    on sm90 each), against plain autograd through attention in fp32 (scores,
    softmax and both products; the output cast back): the output and dq,
    dk, dv, and the hidden state's gradient through the projections, by
    relative L2 within the 16-bit limit; dq's control drops the last key
    tile, dk's and dv's the last query tile."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.ops.attention import (dot_product_attention,
                                                  split_heads)
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            drop_last_tile, rel_l2)

    dev = unet.conv_in.weight.device
    gen = torch.Generator(dev).manual_seed(12)
    rows = []
    for name, attn, tokens in (
            ("T1 level1", unet.down_1_attn_0.blocks_0.attn1, 4096),
            ("T2 level2", unet.down_2_attn_0.blocks_0.attn1, 1024)):
        dim = attn.to_q.in_features
        dtype = attn.to_q.weight.dtype
        x = torch.randn((1, tokens, dim), generator=gen, device=dev,
                        dtype=dtype).requires_grad_(True)
        q, k, v = (split_heads(attn._proj(p, x, 1.0), attn.heads)
                   for p in ("to_q", "to_k", "to_v"))
        do = torch.randn(q.shape, generator=gen, device=dev, dtype=dtype)
        qkv = (q, k, v)

        def grads(fn, rows_kept=None):
            out = fn()
            g = torch.autograd.grad(out, qkv, do if rows_kept is None
                                    else do[:, :, :rows_kept],
                                    retain_graph=True)
            dx = torch.autograd.grad(qkv, x, g, retain_graph=True)[0]
            return out, g, dx

        wrappers = (fa.flash_attention_lse, fa.flash_attention_bwd)
        before = [dict(w.launches_by_route) for w in wrappers]
        out, g, dx = grads(lambda: dot_product_attention(q, k, v))
        torch.cuda.synchronize()
        moved = [{r: n - b[r] for r, n in w.launches_by_route.items()}
                 for w, b in zip(wrappers, before)]
        if moved != [{"sm90": 1, "mma": 0, "f32": 0}] * 2:
            raise AssertionError(f"SDXL {name}: K2, K3 + K4 launches by "
                                 f"route {moved}, expected one each on sm90")
        ref_out, ref_g, ref_dx = grads(lambda: fp32_attention(q, k, v))
        kc, qc = drop_last_tile(k.shape[2]), drop_last_tile(q.shape[2])
        _, ctl_kv, _ = grads(lambda: fp32_attention(
            q, k[:, :, :kc], v[:, :, :kc]))
        _, ctl_q, _ = grads(lambda: fp32_attention(q[:, :, :qc], k, v),
                            rows_kept=qc)
        ctl_dx = torch.autograd.grad(qkv, x, (ctl_kv[0], *ctl_q[1:]),
                                     retain_graph=True)[0]
        readings = {}
        for what, got, ref, ctl, limit in (
                ("o", out, ref_out, None, KERNEL_REL_L2_16BIT),
                ("dq", g[0], ref_g[0], ctl_kv[0], KERNEL_REL_L2_16BIT),
                ("dk", g[1], ref_g[1], ctl_q[1], KERNEL_REL_L2_16BIT),
                ("dv", g[2], ref_g[2], ctl_q[2], KERNEL_REL_L2_16BIT),
                ("dx", dx, ref_dx, ctl_dx, SDXL_DX_REL_L2)):
            rel = rel_l2(got, ref)
            control = None if ctl is None else rel_l2(ctl, ref)
            check(f"SDXL UNet {name} self-attention {what} under autograd",
                  rel, control, limit)
            readings[what] = (rel, control)
        rows.append(dict(block=name, shape=list(q.shape),
                         rel_l2={k: r for k, (r, _) in readings.items()},
                         control_rel_l2={k: c for k, (_, c) in
                                         readings.items() if c is not None}))
        log(f"SDXL UNet {name} self-attention {tuple(q.shape)} under "
            f"autograd (K2, K3 + K4 sm90) vs plain autograd: "
            + ", ".join(f"{k} {r:.3g}" + ("" if c is None else
                                          f" (control {c:.3g})")
                        for k, (r, c) in readings.items())
            + f"; limit {KERNEL_REL_L2_16BIT:g}, dx {SDXL_DX_REL_L2:.3g}")
        del x, q, k, v, do, out, g, dx, ref_out, ref_g, ref_dx
    return rows


def sdxl_train_batch(bundle, seed: int = 0, px: int = 1024):
    """A full-width SDXL training batch: synthetic_batch at 1024 px with
    ViT-H's 224 px crops, batch 1, plus the second tower's ids and the time
    ids of a 1024x1024 image (original size, crop corner, target size)."""
    import numpy as np
    from consistentid_torch.training import synthetic_batch
    from consistentid_torch.training.train_step import batch_to_tensors

    batch = synthetic_batch(1, px, bundle.vision_config.image_size,
                            bundle.adapter_config.id_embeddings_dim,
                            seed=seed)
    batch["clean_ids2"] = np.roll(batch["clean_ids"], 5, axis=1)
    batch["time_ids"] = np.array([[px, px, 0, 0, px, px]], np.float32)
    return batch_to_tensors(batch, bundle.device)


def sdxl_training_path(bundle, px: int = 1024):
    """SDXL training at full width: the SDXL bundle (bf16) with fp32
    trainable masters, TrainConfig(localization_layers=3), IP projections
    warm-started, sdxl_consistentid_loss at 1024 px, batch 1. Without remat:
    1 warm-up and 3 timed steps (if that runs out of memory, it says so and
    the timed steps run with remat "full"); then 2 steps with remat "full"
    for its peak memory and time; one step under torch.profiler. Raises
    unless every loss is finite, every trainable leaf had a nonzero first
    gradient and moved, no frozen leaf moved, and K2 and K3 + K4 launched
    the per-step counts worked out from the UNet (70 each; K2 again for
    every self-attention remat recomputes), all on sm90."""
    import torch
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.models import localization_layer_names
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.training import (create_train_state,
                                             make_train_step,
                                             sdxl_consistentid_loss,
                                             warm_start_ip_projections)

    attention = sdxl_train_attention_check(bundle.unet)
    config = TrainConfig(localization_layers=3)
    latent_hw = px // bundle.vae_scale_factor
    per_call, recomputed = flash_self_attentions(
        bundle.unet, latent_hw,
        localization_layer_names(config.localization_layers))
    warm_start_ip_projections(bundle.unet)
    state = create_train_state(bundle, config)
    parts = {}
    for n, p in state.trainable.items():
        top = n.split(".")[0]
        parts[top] = parts.get(top, 0) + p.numel()
    n_train = sum(parts.values())
    n_frozen = sum(p.numel() for p in state.frozen.values())
    log(f"SDXL training state: {n_train / 1e6:.1f} M trainable fp32 ("
        + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in parts.items())
        + f"), {n_frozen / 1e9:.3f} B frozen bf16; K2 calls per UNet "
        f"forward {per_call}, of them in blocks remat recomputes "
        f"{recomputed}")
    train0 = {n: p.detach().clone() for n, p in state.trainable.items()}
    # on the card: 8.2 GB of bf16, where a host copy and its way back
    # took seconds a gigabyte
    frozen0 = {n: p.detach().clone() for n, p in state.frozen.items()}
    step = make_train_step(bundle, NoiseSchedule.create(SchedulerConfig()),
                           config, loss_fn=sdxl_consistentid_loss)
    batch = sdxl_train_batch(bundle, px=px)
    gen = torch.Generator(bundle.device).manual_seed(0)
    counters = launch_counters() + bn_counters()
    losses = []

    def run(mode, n_steps, warm):
        """n_steps timed steps (after `warm` untimed ones) with `mode`;
        None if the card ran out of memory."""
        bundle.remat = mode != "none"
        bundle.remat_policy = "full" if mode == "none" else mode
        nonlocal state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            for _ in range(warm):
                state, m = step(state, batch, generator=gen)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            fa.reset_launches(*counters)
            t0 = time.perf_counter()
            for _ in range(n_steps):
                state, m = step(state, batch, generator=gen)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            log(f"SDXL training with remat {mode!r}: out of memory "
                f"({str(e).splitlines()[0][:160]})")
            return None
        finally:
            bundle.remat = False
        launches = [w.launches for w in counters]
        k2_expected = per_call + (recomputed if mode != "none" else 0)
        routes = (dict(fa.flash_attention_lse.launches_by_route),
                  dict(fa.flash_attention_bwd.launches_by_route))
        if launches != [0, k2_expected * n_steps, per_call * n_steps, 0, 0] \
                or routes[0]["sm90"] != k2_expected * n_steps \
                or routes[1]["sm90"] != per_call * n_steps:
            raise AssertionError(
                f"SDXL training ({mode}): launches K1, K2, K3 + K4, K5, K6 "
                f"over {n_steps} steps {launches} (K2 {routes[0]}, K3 + K4 "
                f"{routes[1]}), expected K2 {k2_expected} and K3 + K4 "
                f"{per_call} per step, all on sm90, none of K1, K5, K6")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        r = dict(mode=mode, steps=n_steps, warmup_s=warm_s,
                 s_per_step=seconds / n_steps,
                 examples_per_s=n_steps / seconds, peak_gib=peak,
                 k2_per_step=k2_expected, bwd_per_step=per_call,
                 launches_by_route=dict(k2=routes[0], bwd=routes[1]))
        log(f"SDXL training ({mode} remat), 1024 px, batch 1: "
            f"{r['s_per_step']:.4f} s/step, {r['examples_per_s']:.3f} "
            f"examples/s over {n_steps} steps ({warm} warm-up in "
            f"{warm_s:.2f} s), peak memory {peak:.2f} GiB, launches per "
            f"step K2 {k2_expected}, K3 + K4 {per_call} (sm90)")
        return r

    runs = {"none": run("none", 3, 1)}
    if runs["none"] is None:
        runs["full"] = run("full", 3, 1)
        main_mode = "full"
    else:
        runs["full"] = run("full", 2, 0)
        main_mode = "none"
    if runs["full"] is None:
        raise AssertionError("SDXL training ran out of memory with remat "
                             "'full' too")
    if not state.step:
        raise AssertionError("SDXL training took no step")
    no_grad = [n for n, mu in zip(state.trainable, state.optimizer.mu)
               if not (bool(mu.ne(0).any()) and bool(mu.isfinite().all()))]
    if not all(math.isfinite(x) for x in losses) or no_grad:
        raise AssertionError(f"SDXL training: losses {losses}; leaves "
                             f"without a finite nonzero gradient "
                             f"{no_grad[:5]}")
    still = [n for n, p in state.trainable.items()
             if torch.equal(p, train0[n])]
    changed = [n for n, p in state.frozen.items()
               if not torch.equal(p, frozen0[n])]
    if still or changed:
        raise AssertionError(f"SDXL training: trainable leaves that did not "
                             f"move {still[:5]}; frozen leaves that did "
                             f"{changed[:5]}")
    del train0, frozen0
    bundle.remat = main_mode != "none"
    bundle.remat_policy = "full"
    prof = profile_step(step, state, batch, gen,
                        f"SDXL, {main_mode} remat, bf16, batch 1, 1024 px")
    bundle.remat = False
    log(f"SDXL training: {state.step} steps, losses "
        f"{[round(x, 5) for x in losses]}; every trainable leaf moved, "
        f"no frozen leaf did")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, main_mode=main_mode,
                none_out_of_memory=runs["none"] is None, losses=losses,
                trainable_params=parts, frozen_params=n_frozen,
                k2_calls_per_unet_forward=per_call,
                recomputed_per_unet_forward=recomputed, profile=prof,
                attention_checks=attention)


def sd15_remat_phase(bundle, state, px: int = 512):
    """Remat on the SD1.5 training path at full width (batch 2, 512 px):
    from one snapshot of the trained state, on one batch and the same
    draws, with deterministic algorithms (testing.deterministic), a step
    without remat, one with "full" and one with "dots": the loss within
    relative 1e-5 and the updated masters within the JAX package's remat
    test's limits (rtol 2e-4, atol 2e-6) of the step without; each
    mode's peak memory, its time (a second step) and its K2 launches (15:
    10 self-attentions and 5 recomputed). The state is put
    back as it was."""
    import torch
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.models import localization_layer_names
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.training import (make_draws, make_train_step,
                                             synthetic_batch)
    from consistentid_torch.testing import deterministic
    from consistentid_torch.training.train_step import batch_to_tensors

    config = TrainConfig()
    lat = px // bundle.vae_scale_factor
    per_call, recomputed = flash_self_attentions(
        bundle.unet, lat, localization_layer_names(config.localization_layers))
    snap = state_snapshot(state)
    step = make_train_step(bundle, NoiseSchedule.create(SchedulerConfig()),
                           config)
    batch = batch_to_tensors(synthetic_batch(
        2, px, bundle.vision_config.image_size,
        bundle.adapter_config.id_embeddings_dim, seed=7), bundle.device)
    draws = make_draws(torch.Generator(bundle.device).manual_seed(8),
                       (2, lat, lat, 4), 1000, bundle.dtype)
    counters = launch_counters()
    rows, ref = {}, None
    for mode in ("none", "full", "dots"):
        state.load_state_dict(snap)
        bundle.remat, bundle.remat_policy = mode != "none", \
            ("full" if mode == "none" else mode)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches(*counters)
        try:
            with deterministic():
                _, m = step(state, batch, draws)
            torch.cuda.synchronize()
            launches = [c.launches for c in counters]
            loss = float(m["loss"])
            masters = {n: p.detach().clone() for n, p in
                       state.trainable.items()}
            t0 = time.perf_counter()
            step(state, batch, draws)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            bundle.remat = False
        k2 = per_call + (recomputed if mode != "none" else 0)
        if launches != [0, k2, per_call]:
            raise AssertionError(f"SD1.5 remat {mode}: launches K1, K2, "
                                 f"K3 + K4 {launches}, expected "
                                 f"[0, {k2}, {per_call}]")
        row = dict(loss=loss, s_per_step=seconds, k2_launches=k2,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if ref is None:
            ref = (loss, masters)
        else:
            loss_rel = abs(loss - ref[0]) / abs(ref[0])
            worst = 0.0
            for n, w in ref[1].items():
                excess = ((masters[n] - w).abs()
                          - (2e-6 + 2e-4 * w.abs())).max().item()
                worst = max(worst, excess)
            row.update(loss_rel=loss_rel, masters_over_limit=worst)
            if not (loss_rel <= 1e-5 and worst <= 0.0):
                raise AssertionError(
                    f"SD1.5 remat {mode}: loss {loss} vs {ref[0]} "
                    f"(relative {loss_rel:.3g}), masters over "
                    f"atol 2e-6 + rtol 2e-4 by {worst:.3g}")
        del masters
        rows[mode] = row
        log(f"SD1.5 training with remat {mode!r} (batch 2, 512 px): loss "
            f"{loss:.7g}"
            + ("" if mode == "none" else
               f" (relative {row['loss_rel']:.3g}, limit 1e-5; masters "
               "within rtol 2e-4, atol 2e-6)")
            + f", {seconds:.4f} s/step, peak {row['peak_gib']:.2f} GiB, K2 "
            f"launches {k2}, K3 + K4 {per_call}")
    state.load_state_dict(snap)
    del snap, ref
    torch.cuda.empty_cache()
    return rows


FACIAL_LABELS = ((1, (60, 452, 90, 422)),     # Face
                 (14, (452, 520, 170, 342)),   # Neck, to the bottom edge
                 (4, (170, 205, 150, 230)),    # Left_Eye
                 (5, (170, 205, 282, 362)),    # Right_Eye
                 (7, (190, 300, 60, 90)),      # Left_Ear
                 (10, (230, 300, 226, 286)),   # Nose
                 (12, (330, 352, 196, 316)),   # Upper_Lip
                 (13, (352, 376, 196, 316)))   # Lower_Lip


def write_corpus(root, n: int = 8):
    """An FGID corpus of n PNG faces at 512 px (noise over a seeded colour
    field), each with a grey parsing map of BiSeNet's labels in blobs that
    move from face to face (the neck reaching the bottom edge, as in a
    portrait: a background that enclosed the person would fill to the whole
    image and leave no WithoutBackground mask), a FaceID embedding (.bin,
    512 fp32) and two captions with facial words; returns the manifest's
    path."""
    import numpy as np
    from consistentid_torch.utils.png import encode_png

    rng = np.random.RandomState(21)
    items = []
    for i in range(n):
        base = rng.randint(40, 200, (1, 1, 3))
        img = np.clip(base + rng.randint(-40, 40, (512, 512, 3)), 0,
                      255).astype(np.uint8)
        labels = np.zeros((512, 512), np.uint8)
        for value, (y0, y1, x0, x1) in FACIAL_LABELS:
            dy, dx = rng.randint(-8, 9, 2)
            labels[y0 + dy:y1 + dy, x0 + dx:x1 + dx] = value
        Path(root, f"face{i}.png").write_bytes(encode_png(img))
        Path(root, f"parsing{i}.png").write_bytes(encode_png(labels))
        rng.randn(512).astype(np.float32).tofile(Path(root, f"id{i}.bin"))
        items.append({
            "image_path": f"face{i}.png",
            "parsing_mask_path": f"parsing{i}.png",
            "faceid_path": f"id{i}.bin",
            "vqa_llva": f"a portrait photo of person {i} outdoors.",
            "vqa_llva_more_face_detail":
                "The person has bright eyes, a straight nose, small ears "
                "and full lips."})
    path = Path(root, "JSON_all.json")
    path.write_text(json.dumps(items))
    return str(path)


def train_cli_phase(paths, outdir, k2_per_step: int = 10):
    """The data-to-train loop through the CLIs at full width, on the
    written SD1.5 set: a corpus of 8 PNG faces at 512 px; `apps.precompute`
    encodes it on the card; `apps.train --encoded` takes 4 steps with
    --steps-per-call 2 (batch 2) and checkpoints at steps 2 and 4; a second
    `apps.train` in another directory, given the step-2 checkpoint, resumes
    to step 4, and its restored masters and AdamW moments must be the first
    run's at step 2, bit for bit; a pixel-path `apps.train` (FGIDDataset on
    the corpus) takes 2 steps. Every run 10 K2 and 10 K3 + K4 launches per
    step on sm90."""
    import torch
    from consistentid_torch.apps import precompute as precompute_cli
    from consistentid_torch.apps import train as train_cli
    from consistentid_torch.io import checkpoint as ckpt_mod
    from consistentid_torch.ops import flash_attention as fa

    root = Path(outdir, "corpus")
    root.mkdir()
    manifest = write_corpus(root)
    common = ["--base", paths["base"],
              "--image-encoder", paths["image_encoder_path"],
              "--tokenizer", str(Path(paths["base"], "tokenizer"))]
    enc = str(Path(outdir, "encoded"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if precompute_cli.main(common + ["--manifest", manifest, "--data-root",
                                     str(root), "--out", enc,
                                     "--batch-size", "4"]) != 0:
        raise AssertionError("apps.precompute failed")
    precompute_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    saved, restored = {}, {}
    real_save, real_restore = (ckpt_mod.CheckpointManager.save,
                               ckpt_mod.CheckpointManager.restore)

    def save(self, state):
        saved[state.step] = state_snapshot(state)
        return real_save(self, state)

    def restore(self, state, step=None):
        out = real_restore(self, state, step)
        restored.update(state_snapshot(out))
        return out

    counters = launch_counters()

    def train(argv):
        fa.reset_launches(*counters)
        t0 = time.perf_counter()
        run = train_cli.main(common + ["--epochs", "10"] + argv)
        seconds = time.perf_counter() - t0
        steps = sum(run["steps_per_call"])
        launches = [c.launches for c in counters]
        n = k2_per_step * steps
        if launches != [0, n, n] or \
                fa.flash_attention_bwd.launches_by_route["sm90"] != n:
            raise AssertionError(f"apps.train {argv}: launches K1, K2, "
                                 f"K3 + K4 {launches} over {steps} steps")
        # a masked MSE of random predictions is 0 only under an empty mask
        if not all(math.isfinite(x) and x != 0.0 for x in run["losses"]):
            raise AssertionError(f"apps.train: losses {run['losses']}")
        # the last call of the step function, after the first one's
        # allocations
        s_per_step = run["step_times"][-1] / run["steps_per_call"][-1]
        out = dict(seconds=seconds, steps=steps, s_per_step=s_per_step,
                   step_times=run["step_times"], losses=run["losses"],
                   final_step=run["state"].step,
                   restored_step=run["restored_step"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
        return out

    run_a, run_b = Path(outdir, "run_a"), Path(outdir, "run_b")
    ckpt_mod.CheckpointManager.save = save
    ckpt_mod.CheckpointManager.restore = restore
    try:
        encoded = train(["--encoded", "--manifest",
                         str(Path(enc, "encoded_manifest.json")),
                         "--output-dir", str(run_a), "--max-steps", "4",
                         "--save-steps", "2", "--steps-per-call", "2"])
        steps_a = sorted(int(p.name) for p in run_a.iterdir()
                         if p.name.isdigit())
        if encoded["final_step"] != 4 or steps_a != [2, 4] or 2 not in saved:
            raise AssertionError(f"apps.train --encoded: final step "
                                 f"{encoded['final_step']}, checkpoints "
                                 f"{steps_a}")
        run_b.mkdir()
        shutil.copytree(run_a / "2", run_b / "2")
        resumed = train(["--encoded", "--manifest",
                         str(Path(enc, "encoded_manifest.json")),
                         "--output-dir", str(run_b), "--max-steps", "4",
                         "--save-steps", "2"])
    finally:
        ckpt_mod.CheckpointManager.save = real_save
        ckpt_mod.CheckpointManager.restore = real_restore
    want = saved[2]
    bad = [n for key in ("trainable", "mu", "nu")
           for n, t in want[key].items()
           if not torch.equal(restored[key][n], t)]
    if resumed["restored_step"] != 2 or resumed["final_step"] != 4 or bad \
            or restored["count"] != want["count"]:
        raise AssertionError(f"resume: restored step "
                             f"{resumed['restored_step']}, final "
                             f"{resumed['final_step']}, tensors that differ "
                             f"from the first run's step 2: {bad[:5]}")
    n_tensors = sum(len(want[k]) for k in ("trainable", "mu", "nu"))
    del saved, restored, want
    shutil.rmtree(run_a)
    shutil.rmtree(run_b)
    pixel = train(["--manifest", manifest, "--data-root", str(root),
                   "--output-dir", str(Path(outdir, "run_pixel")),
                   "--max-steps", "2"])
    shutil.rmtree(Path(outdir, "run_pixel"))
    log(f"CLI loop (SD1.5 set, 8 faces at 512 px, batch 2, bf16): "
        f"precompute {precompute_s:.2f} s; train --encoded 4 steps in "
        f"{encoded['seconds']:.2f} s with the load "
        f"({encoded['s_per_step']:.4f} s/step in its last call of 2 steps); resumed from step 2 to 4 in "
        f"{resumed['seconds']:.2f} s ({resumed['s_per_step']:.4f} s in its "
        f"second step), its restored masters and AdamW moments "
        f"({n_tensors} tensors) the first run's at step 2 bit for bit; pixel "
        f"path 2 steps in {pixel['seconds']:.2f} s ({pixel['s_per_step']:.4f}"
        f" s in its second step); losses encoded "
        f"{[round(x, 5) for x in encoded['losses']]}, resumed "
        f"{[round(x, 5) for x in resumed['losses']]}, pixel "
        f"{[round(x, 5) for x in pixel['losses']]}")
    # one step a call after one warm step on both paths: the resumed run's
    # second step and the pixel run's
    return dict(precompute_s=precompute_s, encoded=encoded, resumed=resumed,
                pixel=pixel, resume_bit_equal_tensors=n_tensors,
                encoded_vs_pixel_s_per_step=(resumed["s_per_step"],
                                             pixel["s_per_step"]))


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before it:
    (result, seconds, launches [K1, K2, K3 + K4, K5, K6], K1's by route)."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, [w.launches for w in counters],
            dict(fa.flash_attention_fwd.launches_by_route))


def expect_k1(what: str, launches, by_route, n: int) -> None:
    """K1 launched n times, all on the sm90 route, and no other kernel."""
    if launches != [n, 0, 0, 0, 0] or by_route["sm90"] != n:
        raise AssertionError(f"{what}: launches K1, K2, K3 + K4, K5, K6 "
                             f"{launches} (K1 {by_route}), expected K1 {n} "
                             "on sm90 only")


def init_image_inputs(height: int = 512, width: int = 512):
    """A seeded random init image and a centre mask (white regenerates)."""
    import numpy as np
    init = np.random.RandomState(5).randint(0, 255, (height, width, 3),
                                            np.uint8)
    mask = np.zeros((height, width), np.uint8)
    mask[height // 4:3 * height // 4, width // 4:3 * width // 4] = 255
    return init, mask


def init_image_phase(bundle):
    """img2img, 4- and 9-channel inpainting and ControlNet inpainting on the
    serving bundle (one image, 512 px, 50 DDIM steps, CFG), each warmed up
    at 2 steps first:
      - img2img at strength 0.8: a finite (1, 512, 512, 3) image, K1 400
        times (40 kept steps x 10) on sm90; at strength 1 the uint8 bits
        of text to image from the same seed;
      - 4-channel inpaint at strength 1: 500 K1 launches; the final latents
        outside the latent mask the clean image latents bit for bit (the
        last blend target is 1.0 x0 + 0.0 noise); generate_async the same
        bits as generate;
      - a second full-width UNet with sample_channels 9 (N(0, 0.02) from a
        seed), swapped into the bundle, run and freed: 500 K1 launches, a
        finite image;
      - ControlNet inpaint with a full-width ControlNet (control pyramid
        16, 32, 96, 256; N(0, 0.02) weights from a seed, the output
        convolutions included): controlnet_scale 1 with
        control_guidance_end 0.8, then guess mode, 700 K1 launches each (10
        UNet + 4 ControlNet a step); controlnet_scale 0 within one grey
        level of plain inpainting; one ControlNet call and one UNet call
        (with its residuals) under torch.profiler."""
    import dataclasses
    import numpy as np
    import torch
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.models import UNet, make_controlnet
    from consistentid_torch.pipelines import (
        ConsistentIDControlNetInpaintPipeline, ConsistentIDImg2ImgPipeline,
        ConsistentIDInpaintPipeline, ConsistentIDPipeline, preprocess_mask)
    from consistentid_torch.testing import synthetic_clip_tokenizer
    from consistentid_torch.utils.image import to_uint8

    cfg = PipelineConfig(height=512, width=512, num_inference_steps=50,
                         start_merge_step=30)
    tok = synthetic_clip_tokenizer()
    t2i, img2img, inpaint = (cls(bundle, tok, pipeline_config=cfg) for cls in (
        ConsistentIDPipeline, ConsistentIDImg2ImgPipeline,
        ConsistentIDInpaintPipeline))
    face, labels, faceid = face_inputs()
    init, mask = init_image_inputs()
    kw = dict(parsing_labels=labels, faceid_embeds=faceid)
    out = {}

    def finite_image(what, images):
        if images.shape != (1, 512, 512, 3) or not torch.isfinite(
                images.float()).all():
            raise AssertionError(f"{what}: output {tuple(images.shape)}, "
                                 "expected a finite (1, 512, 512, 3) image")

    # img2img
    img2img.generate(PROMPT, face, init, strength=0.8, seed=0,
                     num_inference_steps=2, **kw)
    images, s, launches, by_route = counted(lambda: img2img.generate(
        PROMPT, face, init, strength=0.8, seed=1, return_float=True, **kw))
    finite_image("img2img", images)
    expect_k1("img2img (strength 0.8, 40 of 50 steps)", launches, by_route,
              400)
    stages = dict(img2img.last_stage_ms)
    full = img2img.generate(PROMPT, face, init, strength=1.0, seed=2, **kw)
    t2i_u8 = t2i.generate(PROMPT, face, seed=2, **kw)
    same = bool(np.array_equal(full, t2i_u8))
    log(f"img2img (strength 0.8, 50 DDIM steps, 512 px): {s:.3f} s, stages "
        f"ms { {k: round(v, 1) for k, v in stages.items()} }, K1 launches "
        f"{launches[0]} {by_route}; strength 1 against generate from the "
        f"same seed: bits equal {same}")
    if not same:
        raise AssertionError("img2img at strength 1 is not generate's bits")
    out["img2img"] = dict(seconds=s, launches=launches[0],
                          launches_by_route=by_route, stage_ms=stages,
                          strength1_equals_generate=same)

    # 4-channel inpainting: the blend's exact unmasked latents, async bits
    inpaint.generate(PROMPT, face, init, mask, seed=0,
                     num_inference_steps=2, **kw)
    seen = {}
    encode, decode = inpaint._encode_init, inpaint._decode

    def spy_encode(*args):
        result = encode(*args)
        seen["image"] = result[0]
        return result

    def spy_decode(final):
        seen["final"] = final
        return decode(final)

    inpaint._encode_init, inpaint._decode = spy_encode, spy_decode
    try:
        images, s, launches, by_route = counted(lambda: inpaint.generate(
            PROMPT, face, init, mask, strength=1.0, seed=3,
            return_float=True, **kw))
    finally:
        del inpaint._encode_init, inpaint._decode
    finite_image("inpaint", images)
    expect_k1("inpaint (strength 1, 50 steps)", launches, by_route, 500)
    keep = (torch.from_numpy(preprocess_mask(mask, 512, 512, 64, 64)[1])
            .cuda().expand_as(seen["final"]) == 0)
    unmasked_equal = bool(torch.equal(seen["final"][keep],
                                      seen["image"].float()[keep]))
    inpaint_u8 = to_uint8(images).cpu().numpy()
    stages = dict(inpaint.last_stage_ms)
    async_u8 = inpaint.generate_async(PROMPT, face, init, mask, strength=1.0,
                                      seed=3, **kw)()
    async_equal = bool(np.array_equal(async_u8, inpaint_u8))
    log(f"inpaint, 4-channel (strength 1, 50 DDIM steps, 512 px, centre "
        f"mask): {s:.3f} s, stages ms "
        f"{ {k: round(v, 1) for k, v in stages.items()} }, K1 launches "
        f"{launches[0]} {by_route}; final latents outside the mask the image "
        f"latents bit for bit: {unmasked_equal} ({int(keep.sum())} values); "
        f"generate_async bits equal: {async_equal}")
    if not (unmasked_equal and async_equal):
        raise AssertionError("inpaint: unmasked latents or async bits differ")
    out["inpaint"] = dict(seconds=s, launches=launches[0],
                          launches_by_route=by_route, stage_ms=stages,
                          unmasked_latents_bit_equal=unmasked_equal,
                          unmasked_values=int(keep.sum()),
                          async_bits_equal=async_equal)

    # 9-channel inpainting: a second UNet, swapped in, run and freed
    cfg9 = dataclasses.replace(bundle.unet_config, sample_channels=9)
    with torch.device("meta"):
        unet9 = UNet(cfg9)
    unet9.to_empty(device="cuda")
    unet9.to(bundle.dtype)
    unet9.requires_grad_(False)
    gen = torch.Generator("cuda").manual_seed(9)
    with torch.no_grad():
        for p in unet9.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    saved = bundle.unet, bundle.unet_config
    bundle.unet, bundle.unet_config = unet9, cfg9
    try:
        pipe9 = ConsistentIDInpaintPipeline(bundle, tok, pipeline_config=cfg)
        pipe9.generate(PROMPT, face, init, mask, seed=0,
                       num_inference_steps=2, **kw)
        images, s, launches, by_route = counted(lambda: pipe9.generate(
            PROMPT, face, init, mask, strength=1.0, seed=3,
            return_float=True, **kw))
        stages = dict(pipe9.last_stage_ms)
    finally:
        bundle.unet, bundle.unet_config = saved
        del unet9, pipe9
        gc.collect()
        torch.cuda.empty_cache()
    finite_image("inpaint, 9-channel", images)
    expect_k1("inpaint, 9-channel", launches, by_route, 500)
    log(f"inpaint, 9-channel UNet (strength 1, 50 DDIM steps): {s:.3f} s, "
        f"stages ms { {k: round(v, 1) for k, v in stages.items()} }, K1 "
        f"launches {launches[0]} {by_route}")
    out["inpaint9"] = dict(seconds=s, launches=launches[0],
                           launches_by_route=by_route, stage_ms=stages)

    # ControlNet inpainting
    t0 = time.perf_counter()
    net = make_controlnet(bundle.unet_config, in_channels=4,
                          dtype=bundle.dtype, device="cuda")
    net.random_params(torch.Generator("cuda").manual_seed(11))
    n_params = sum(p.numel() for p in net.parameters())
    log(f"ControlNet: {n_params / 1e6:.1f} M params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    cn = ConsistentIDControlNetInpaintPipeline(
        bundle, tok, pipeline_config=cfg, controlnet=net,
        controlnet_scale=1.0, control_guidance_end=0.8)
    cn_kw = dict(kw, control_image=init, strength=1.0, seed=3)
    cn.generate(PROMPT, face, init, mask, **dict(cn_kw,
                                                 num_inference_steps=2))
    runs = {}
    for mode in ("scale_1_end_0.8", "guess_mode"):
        cn.guess_mode = mode == "guess_mode"
        images, s, launches, by_route = counted(lambda: cn.generate(
            PROMPT, face, init, mask, return_float=True, **cn_kw))
        finite_image(f"ControlNet inpaint ({mode})", images)
        expect_k1(f"ControlNet inpaint ({mode})", launches, by_route, 700)
        u8 = to_uint8(images).cpu().numpy()
        runs[mode] = dict(seconds=s, launches=launches[0],
                          launches_by_route=by_route,
                          stage_ms=dict(cn.last_stage_ms),
                          mean_abs_diff_vs_plain_inpaint=float(np.abs(
                              u8.astype(int) - inpaint_u8).mean()))
        log(f"ControlNet inpaint ({mode}, 50 DDIM steps): {s:.3f} s, stages "
            f"ms { {k: round(v, 1) for k, v in cn.last_stage_ms.items()} }, "
            f"K1 launches {launches[0]} {by_route}, mean |image - plain "
            f"inpaint| {runs[mode]['mean_abs_diff_vs_plain_inpaint']:.3f} "
            "grey levels")
    cn.guess_mode, cn.controlnet_scale = False, 0.0
    zero = cn.generate(PROMPT, face, init, mask, **cn_kw)
    zero_diff = int(np.abs(zero.astype(int) - inpaint_u8).max())
    log(f"ControlNet inpaint at controlnet_scale 0 against plain inpaint: "
        f"max difference {zero_diff} grey levels (allowed 1)")
    if zero_diff > 1:
        raise AssertionError("ControlNet at scale 0 is off plain inpaint by "
                             f"{zero_diff} grey levels")

    gen = torch.Generator("cuda").manual_seed(12)
    x = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((2,), 501.0, device="cuda")
    ctx = torch.randn((2, 81, 768), generator=gen, device="cuda")
    control = torch.rand((2, 512, 512, 3), generator=gen, device="cuda")
    unet = bundle.infer_unet(1.0)
    with torch.no_grad():
        down, mid = net(x, t, ctx, control)
    prof_cn = profile_call(lambda: net(x, t, ctx, control))
    prof_unet = profile_call(lambda: unet(
        x, t, ctx, down_block_residuals=down, mid_residual=mid))
    log_profile("ControlNet call (bf16, CFG batch 2, 64x64 latents)", prof_cn)
    log_profile("UNet call with its residuals (the same step)", prof_unet)
    share = prof_cn["device_ms"] / (prof_cn["device_ms"]
                                    + prof_unet["device_ms"])
    log(f"ControlNet share of a step's device time: {share:.1%}")
    out["controlnet_inpaint"] = dict(
        params_m=n_params / 1e6, runs=runs, scale0_max_diff=zero_diff,
        profile=dict(controlnet=prof_cn, unet=prof_unet,
                     controlnet_device_share=share))
    del cn, net, unet, down, mid
    gc.collect()
    torch.cuda.empty_cache()
    return out


DEEPCACHE_K1 = {1: 500, 2: 375, 3: 335}   # batch 4, 50 steps: full x 10
#                                          + cached x 5 (level 0 only)


def deepcache_phase(bundle, rounds: int = 2):
    """DeepCache on the serving bundle at the headline request (batch 4, 50
    DDIM steps, 512 px): the split invariant at full width (the shallow
    path fed the full path's own deep feature reproduces the full output
    within the 16-bit kernel limit); then cache_interval 1, 2 and 3 in
    turns, `rounds` times: s/request, K1 launches per request (500, 375,
    335, all sm90), the mean grey-level drift against interval 1
    (recorded, not bounded)."""
    import numpy as np
    import torch
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            synthetic_clip_tokenizer, rel_l2)
    from consistentid_torch.utils.image import to_uint8

    gen = torch.Generator("cuda").manual_seed(13)
    x = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((8,), 501.0, device="cuda")
    ctx = torch.randn((8, 81, 768), generator=gen, device="cuda")
    unet = bundle.infer_unet(1.0)
    with torch.no_grad():
        full, deep = unet(x, t, ctx, return_deep=True)
        shallow, _, launches, _ = counted(lambda: unet(x, t, ctx,
                                                       deep_feature=deep))
    split_rel = rel_l2(shallow, full)
    log(f"DeepCache split at full width (batch 8, 64x64 latents): shallow "
        f"path on the full path's deep feature {tuple(deep.shape)}: "
        f"relative L2 {split_rel:.3g} (limit {KERNEL_REL_L2_16BIT:g}), K1 "
        f"launches of the shallow call {launches[0]}")
    if not split_rel <= KERNEL_REL_L2_16BIT or launches[0] != 5:
        raise AssertionError("DeepCache split invariant failed")
    del unet, full, deep, shallow

    pipe = ConsistentIDPipeline(
        bundle, synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(height=512, width=512,
                                       num_inference_steps=50,
                                       start_merge_step=30))
    face, labels, faceid = face_inputs()
    kw = dict(parsing_labels=labels, faceid_embeds=faceid,
              num_images_per_prompt=4)
    for ci in (2, 3):
        pipe.generate(PROMPT, face, seed=0, num_inference_steps=4,
                      cache_interval=ci, **kw)
    seconds = {ci: [] for ci in DEEPCACHE_K1}
    images, by_route = {}, {}
    for _ in range(rounds):
        for ci, n in DEEPCACHE_K1.items():
            imgs, s, launches, routes = counted(lambda: pipe.generate(
                PROMPT, face, seed=1, cache_interval=ci, return_float=True,
                **kw))
            expect_k1(f"DeepCache interval {ci}", launches, routes, n)
            if not torch.isfinite(imgs.float()).all():
                raise AssertionError(f"DeepCache interval {ci}: non-finite")
            seconds[ci].append(s)
            images[ci] = to_uint8(imgs).cpu().numpy().astype(int)
            by_route[ci] = routes
    drift = {ci: float(np.abs(images[ci] - images[1]).mean())
             for ci in (2, 3)}
    mean_s = {ci: sum(v) / len(v) for ci, v in seconds.items()}
    for ci in DEEPCACHE_K1:
        log(f"DeepCache interval {ci} (batch 4, 50 DDIM steps, 512 px): "
            f"s/request {seconds[ci]} (mean {mean_s[ci]:.3f}, "
            f"{mean_s[ci] / mean_s[1]:.3f}x interval 1), K1 launches "
            f"{DEEPCACHE_K1[ci]} {by_route[ci]}"
            + (f", mean drift against interval 1 {drift[ci]:.3f} grey "
               "levels" if ci > 1 else ""))
    return dict(split_rel_l2=split_rel, seconds=seconds, mean_s=mean_s,
                launches=dict(DEEPCACHE_K1), launches_by_route=by_route,
                mean_drift_vs_interval1=drift)


def sdxl_deepcache(pipe, face, kw, reference):
    """SDXL at 1024x1024, 50 DDIM steps, cache_interval 3: 1190 K1 launches
    (17 full UNet calls x 70; level 0 has no attention, so the cached steps
    launch none), finite; its seconds and mean drift against `reference`,
    the uncached request's uint8 image."""
    import numpy as np
    import torch
    from consistentid_torch.utils.image import to_uint8

    pipe.generate(PROMPT, face, seed=0, num_inference_steps=4,
                  cache_interval=3, **kw)
    images, s, launches, by_route = counted(lambda: pipe.generate(
        PROMPT, face, seed=1, cache_interval=3, return_float=True, **kw))
    if not torch.isfinite(images).all():
        raise AssertionError("SDXL DeepCache: non-finite decoded images")
    n = SDXL_K1_PER_UNET_CALL * 17
    expect_k1("SDXL DeepCache interval 3", launches, by_route, n)
    drift = float(np.abs(to_uint8(images).cpu().numpy().astype(int)
                         - reference).mean())
    log(f"SDXL DeepCache interval 3 (1 image, 1024x1024, 50 DDIM steps): "
        f"{s:.3f} s, K1 launches {launches[0]} {by_route}, mean drift "
        f"against interval 1 {drift:.3f} grey levels")
    return dict(seconds=s, launches=launches[0], launches_by_route=by_route,
                mean_drift_vs_interval1=drift)


def infer_args(paths, outdir, *extra):
    """`apps.infer` arguments over the written set and the PNG face the
    infer phase wrote, then `extra`."""
    return ["--base", paths["base"],
            "--consistentid", paths["consistentid_path"],
            "--image-encoder", paths["image_encoder_path"],
            "--bisenet", paths["bisenet_path"],
            "--arcface", paths["arcface_path"],
            "--scrfd", paths["scrfd_path"],
            "--image", str(Path(outdir) / "face.png"), "--prompt", PROMPT,
            *extra]


def infer_variants_phase(paths, outdir):
    """`apps.infer.main` on the written set at the JAX defaults (Euler, 50
    steps, 768x512, CFG 5, seed 2024) with `--init-image --mask-image
    --strength 1.0` (a 768x512 PNG and a grey centre-mask PNG): a (768,
    512, 3) PNG and 500 K1 launches; and with `--cache-interval 3`: 335 K1
    launches (17 full calls x 10 + 33 cached x 5); each with its load."""
    import numpy as np
    from consistentid_torch.apps import infer
    from consistentid_torch.utils.png import decode_png, encode_png

    init, mask = init_image_inputs(768, 512)
    files = {}
    for name, arr in (("init", init), ("mask", mask)):
        files[name] = str(Path(outdir) / f"{name}.png")
        with open(files[name], "wb") as f:
            f.write(encode_png(arr))
    out = {}
    for name, flags, n in (
            ("inpaint", ["--init-image", files["init"], "--mask-image",
                         files["mask"], "--strength", "1.0"], 500),
            ("deepcache", ["--cache-interval", "3"], 335)):
        png_path = str(Path(outdir) / f"infer_{name}.png")
        pipe, s, launches, by_route = counted(lambda: infer.main(
            infer_args(paths, outdir, *flags, "--out", png_path)))
        expect_k1(f"infer {name}", launches, by_route, n)
        with open(png_path, "rb") as f:
            png = decode_png(f.read())
        if png.shape != (768, 512, 3) or png.dtype != np.uint8:
            raise AssertionError(f"infer {name} PNG {png.shape}")
        stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
        log(f"infer CLI {' '.join(f for f in flags if f.startswith('--'))} "
            f"(Euler, 50 steps, 768x512): {s:.3f} s with the load, stages ms "
            f"{stages}, K1 launches {launches[0]} {by_route}; PNG "
            f"{png.shape}")
        out[name] = dict(seconds=s, stage_ms=stages, launches=launches[0],
                         launches_by_route=by_route)
        del pipe
        gc.collect()
    return out


# ---------------------------------------------------------------- int8

INT8_MODES = ("bf16", "int8", "int8_static")


def int8_layer_counts(bundle):
    """(int8 layers a full UNet call runs, those of a DeepCache shallow
    call: the level-0 down blocks and the last up block), counted on the
    int8 UNet the bundle builds, made on the meta device."""
    import dataclasses

    import torch

    from consistentid_torch.models import UNet
    from consistentid_torch.models.layers import Int8Conv, Int8Dense
    with torch.device("meta"):
        unet = UNet(dataclasses.replace(bundle.unet_config, lora_rank=0),
                    quant=True)
    names = [n for n, m in unet.named_modules()
             if isinstance(m, (Int8Conv, Int8Dense))]
    last_up = f"up_{len(bundle.unet_config.block_out_channels) - 1}_"
    shallow = [n for n in names
               if n.startswith(("down_0_resnet", "down_0_attn",
                                f"{last_up}resnet", f"{last_up}attn"))]
    return len(names), len(shallow)


def int8_counted(fn):
    """`counted(fn)` and the int_mm launches of the same run:
    (result, seconds, launches [K1, K2, K3 + K4, K5, K6], K1's by route,
    int_mm launches)."""
    from consistentid_torch.ops import quant
    quant.int_mm.launches = 0
    out, s, launches, by_route = counted(fn)
    return out, s, launches, by_route, quant.int_mm.launches


def int8_headline_phase(bundle, smi: str, rounds: int = 2):
    """The headline request (batch 4, 50 DDIM steps, 512 px) on the
    serving bundle in bf16, int8 (dynamic activation scales) and
    int8_static (calibrated on the seeded face, 8 steps, timed), in turns,
    `rounds` times: s/request, the stage split (fold: the LoRA fold and,
    under int8, the weight quantization), peak GiB, K1 launches (500, all
    sm90) and int_mm launches (50 per int8 layer, none in bf16), finite
    images and their mean absolute uint8 difference from bf16's. Then
    DeepCache at interval 3 with int8: 335 K1 launches, int_mm 17 full
    calls and 33 shallow ones."""
    import numpy as np
    import torch
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import synthetic_clip_tokenizer
    from consistentid_torch.utils.image import to_uint8

    pipe = ConsistentIDPipeline(
        bundle, synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(height=512, width=512,
                                       num_inference_steps=50,
                                       start_merge_step=30))
    face, labels, faceid = face_inputs()
    n_layers, n_shallow = int8_layer_counts(bundle)
    (static, calib_s, launches, by_route,
     calib_mm) = int8_counted(lambda: pipe.calibrate_int8(
         PROMPT, face, parsing_labels=labels, faceid_embeds=faceid))
    log(f"int8_static calibration (8 steps, batch 3 contexts, 512 px): "
        f"{calib_s:.3f} s, {len(static.bundle.act_scales)} top-level "
        f"modules, int_mm launches {calib_mm} (8 x {n_layers}), K1 "
        f"{launches[0]}")
    if calib_mm != 8 * n_layers:
        raise AssertionError(f"calibration: {calib_mm} int_mm launches, "
                             f"expected {8 * n_layers}")
    pipes = {"bf16": pipe, "int8": pipe.with_quant("int8"),
             "int8_static": static}
    kw = dict(parsing_labels=labels, faceid_embeds=faceid,
              num_images_per_prompt=4)
    for p in pipes.values():
        p.generate(PROMPT, face, seed=0, num_inference_steps=2, **kw)
    runs = {m: dict(seconds=[], stage_ms=[], peak_gib=[]) for m in pipes}
    images = {}
    for _ in range(rounds):
        for mode, p in pipes.items():
            torch.cuda.reset_peak_memory_stats()
            imgs, s, launches, by_route, mm = int8_counted(
                lambda: p.generate(PROMPT, face, seed=1, return_float=True,
                                   **kw))
            expect_k1(f"headline {mode}", launches, by_route, 500)
            want_mm = 0 if mode == "bf16" else 50 * n_layers
            if mm != want_mm:
                raise AssertionError(f"headline {mode}: {mm} int_mm "
                                     f"launches, expected {want_mm}")
            if not torch.isfinite(imgs.float()).all():
                raise AssertionError(f"headline {mode}: non-finite images")
            r = runs[mode]
            r["seconds"].append(s)
            r["stage_ms"].append({k: round(v, 1) for k, v in
                                  p.last_stage_ms.items()})
            r["peak_gib"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
            r.update(k1_launches=launches[0], k1_by_route=by_route,
                     int_mm_launches=mm,
                     int_mm_per_unet_call=mm // 50)
            images[mode] = to_uint8(imgs).cpu().numpy().astype(int)
    for mode, r in runs.items():
        r["mean_s"] = sum(r["seconds"]) / len(r["seconds"])
        r["mean_abs_diff_vs_bf16"] = float(
            np.abs(images[mode] - images["bf16"]).mean())
        log(f"headline {mode} (batch 4, 50 DDIM steps, 512 px; {smi}): "
            f"s/request {[round(x, 3) for x in r['seconds']]} (mean "
            f"{r['mean_s']:.3f}, {r['mean_s'] / runs['bf16']['mean_s']:.3f}"
            f"x bf16), stages ms {r['stage_ms'][-1]}, peak "
            f"{max(r['peak_gib']):.2f} GiB, K1 {r['k1_launches']} "
            f"{r['k1_by_route']}, int_mm {r['int_mm_launches']} "
            f"({r['int_mm_per_unet_call']} per UNet call), mean |image - "
            f"bf16's| {r['mean_abs_diff_vs_bf16']:.3f} grey levels")

    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((8,), 501.0, device="cuda")
    ctx = torch.randn((8, 81, 768), generator=gen, device="cuda")
    profiles = {}
    for mode in ("int8", "int8_static"):
        unet = pipes[mode].bundle.infer_unet(1.0)
        profiles[mode] = profile_call(lambda: unet(x, t, ctx), top=12)
        log_profile(f"UNet call profile ({mode}, batch 8, 64x64 latents)",
                    profiles[mode])
    del unet

    dyn = pipes["int8"]
    dyn.generate(PROMPT, face, seed=0, num_inference_steps=4,
                 cache_interval=3, **kw)
    imgs, s, launches, by_route, mm = int8_counted(lambda: dyn.generate(
        PROMPT, face, seed=1, cache_interval=3, return_float=True, **kw))
    expect_k1("DeepCache int8 interval 3", launches, by_route, 335)
    want_mm = 17 * n_layers + 33 * n_shallow
    if mm != want_mm or not torch.isfinite(imgs.float()).all():
        raise AssertionError(f"DeepCache int8: {mm} int_mm launches "
                             f"(expected {want_mm}) or non-finite images")
    drift = float(np.abs(to_uint8(imgs).cpu().numpy().astype(int)
                         - images["int8"]).mean())
    log(f"DeepCache interval 3 with int8 (batch 4, 50 DDIM steps, 512 px): "
        f"{s:.3f} s, K1 {launches[0]} {by_route}, int_mm {mm} (17 x "
        f"{n_layers} + 33 x {n_shallow}), mean drift against int8 at "
        f"interval 1 {drift:.3f} grey levels")
    return dict(
        device=smi, int8_layers=n_layers, shallow_int8_layers=n_shallow,
        calibration_s=calib_s, runs=runs, unet_profiles=profiles,
        deepcache_int8=dict(seconds=s, k1_launches=launches[0],
                            int_mm_launches=mm, mean_drift_vs_interval1=drift))


def sdxl_int8_static(pipe, face, kw, reference):
    """SDXL at 1024x1024, 50 DDIM steps, int8_static: calibrated on the
    seeded face (8 steps, timed), one request: 3500 K1 launches, int_mm 50
    per int8 layer, finite; seconds, stages, peak GiB and the mean uint8
    difference from the bf16 request (`reference`)."""
    import numpy as np
    import torch
    from consistentid_torch.utils.image import to_uint8

    n_layers, _ = int8_layer_counts(pipe.bundle)
    t0 = time.perf_counter()
    static = pipe.calibrate_int8(PROMPT, face, **kw)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    static.generate(PROMPT, face, seed=0, num_inference_steps=2, **kw)
    torch.cuda.reset_peak_memory_stats()
    images, s, launches, by_route, mm = int8_counted(lambda: static.generate(
        PROMPT, face, seed=1, return_float=True, **kw))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_k1("SDXL int8_static", launches, by_route,
              SDXL_K1_PER_UNET_CALL * 50)
    if mm != 50 * n_layers or not torch.isfinite(images).all():
        raise AssertionError(f"SDXL int8_static: {mm} int_mm launches "
                             f"(expected {50 * n_layers}) or non-finite")
    stages = {k: round(v, 1) for k, v in static.last_stage_ms.items()}
    diff = float(np.abs(to_uint8(images).cpu().numpy().astype(int)
                        - reference).mean())
    log(f"SDXL int8_static (1 image, 1024x1024, 50 DDIM steps; calibrated "
        f"in {calib_s:.3f} s): {s:.3f} s, stages ms {stages}, peak "
        f"{peak:.2f} GiB, K1 {launches[0]} {by_route}, int_mm {mm} "
        f"({n_layers} per UNet call), mean |image - bf16's| {diff:.3f}")
    return dict(calibration_s=calib_s, seconds=s, stage_ms=stages,
                peak_gib=peak, k1_launches=launches[0], int_mm_launches=mm,
                int8_layers=n_layers, mean_abs_diff_vs_bf16=diff)


def infer_int8_phase(paths, outdir):
    """`apps.infer.main --quant int8_static --save-act-scales S` at the JAX
    defaults (Euler, 50 steps, 768x512): it calibrates on the request
    (8 steps, 80 K1 launches of its own) and writes S; a second call with
    `--act-scales S` loads them instead: the same PNG bytes, K1 500."""
    from consistentid_torch.apps import infer
    from consistentid_torch.io.quant_scales import load_act_scales

    scales = str(Path(outdir) / "act_scales.npz")
    out = {}
    pngs = []
    for name, flags, k1 in (("calibrate", ["--save-act-scales", scales], 580),
                            ("load", ["--act-scales", scales], 500)):
        png = str(Path(outdir) / f"infer_int8_{name}.png")
        pipe, s, launches, by_route, mm = int8_counted(lambda: infer.main(
            infer_args(paths, outdir, "--quant", "int8_static", "--out",
                       png, *flags)))
        expect_k1(f"infer int8_static {name}", launches, by_route, k1)
        if pipe.bundle.quant != "int8_static" or not mm:
            raise AssertionError(f"infer int8_static {name}: quant "
                                 f"{pipe.bundle.quant}, int_mm {mm}")
        with open(png, "rb") as f:
            pngs.append(f.read())
        stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
        log(f"infer --quant int8_static {' '.join(flags[:1])} (Euler, 50 "
            f"steps, 768x512): {s:.3f} s with the load, stages ms {stages}, "
            f"K1 {launches[0]}, int_mm {mm}")
        out[name] = dict(seconds=s, stage_ms=stages, k1_launches=launches[0],
                         int_mm_launches=mm)
        del pipe
        gc.collect()
    if pngs[0] != pngs[1]:
        raise AssertionError("infer int8_static: --act-scales gave other PNG "
                             "bytes than the calibrating call")
    out["scales_in_file"] = len(load_act_scales(scales))
    log(f"infer int8_static: the second call's PNG is the first's, byte for "
        f"byte ({len(pngs[0])} bytes)")
    return out


def serve_int8_phase(paths, outdir):
    """`apps.serve.main --quant int8_static --calib-image face.png` (512
    px, 50 DDIM steps, the server's default sampler; max batch 2) on
    127.0.0.1: it calibrates, warms
    buckets 1 and 2 and answers 2 concurrent requests 200 with (512, 512,
    3) PNGs; 500 K1 launches and 50 int_mm launches per int8 layer per
    batch. The server is shut down at the end."""
    import base64
    import json
    import threading
    import urllib.request
    import numpy as np
    from consistentid_torch.apps import serve as serve_app
    from consistentid_torch.utils.png import decode_png, encode_png

    held = {}
    real_serve = serve_app.serve

    def keep(*a, **kw):
        held["server"], held["batcher"] = real_serve(*a, **kw)
        held["pipe"] = a[0]
        return held["server"], held["batcher"]

    argv = infer_args(paths, outdir, "--quant", "int8_static",
                      "--calib-image", str(Path(outdir) / "face.png"),
                      "--height", "512", "--width", "512", "--max-batch",
                      "2", "--port", "0")
    serve_app.serve = keep
    thread = threading.Thread(target=serve_app.main, args=(argv,),
                              daemon=True)
    t0 = time.perf_counter()
    try:
        thread.start()
        while "server" not in held:      # loading and calibrating
            if not thread.is_alive():
                raise AssertionError("serve int8_static: the server exited")
            if time.perf_counter() - t0 > 600:
                raise AssertionError("serve int8_static: no server within "
                                     "600 s")
            time.sleep(0.5)
        url = f"http://127.0.0.1:{held['server'].server_address[1]}"
        # answered once the warm-up is done and serve_forever runs
        with urllib.request.urlopen(url + "/healthz", timeout=600) as r:
            if r.status != 200:
                raise AssertionError(f"serve int8_static: /healthz {r.status}")
        ready_s = time.perf_counter() - t0
        n_layers, _ = int8_layer_counts(held["pipe"].bundle)
        face = face_inputs()[0]
        bodies = [json.dumps({"prompt": PROMPT, "seed": 7 + i,
                              "image_b64": base64.b64encode(encode_png(
                                  face)).decode()}).encode()
                  for i in range(2)]

        def post(body):
            req = urllib.request.Request(url + "/generate", data=body)
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())

        def both():
            with ThreadPoolExecutor(2) as pool:
                return list(pool.map(post, bodies))

        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            before = json.loads(r.read())
        replies, s, launches, by_route, mm = int8_counted(both)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            after = json.loads(r.read())
        batches = after["batches"] - before["batches"]
        for code, payload in replies:
            img = decode_png(base64.b64decode(payload["image_b64"]))
            if code != 200 or img.shape != (512, 512, 3):
                raise AssertionError(f"serve int8_static: {code} {img.shape}")
        if (held["pipe"].bundle.quant != "int8_static"
                or launches[0] != 500 * batches
                or mm != 50 * n_layers * batches):
            raise AssertionError(
                f"serve int8_static: quant {held['pipe'].bundle.quant}, K1 "
                f"{launches[0]}, int_mm {mm} in {batches} batches")
        log(f"serve --quant int8_static --calib-image (512 px, 50 DDIM "
            f"steps, max batch 2): up (load, calibration, warm-up) in "
            f"{ready_s:.1f} s; 2 concurrent requests in {s:.3f} s, "
            f"{batches} batch(es), K1 {launches[0]}, int_mm {mm}")
        return dict(ready_s=ready_s, wall_s=s, batches=batches,
                    k1_launches=launches[0], int_mm_launches=mm)
    finally:
        serve_app.serve = real_serve
        if "server" in held:
            held["server"].shutdown()
        thread.join(timeout=120)
        if thread.is_alive():
            raise AssertionError("serve int8_static: the server thread did "
                                 "not stop")


def k1_per_request(steps: int, interval: int = 1) -> int:
    """K1 launches of one text-to-image request of `steps` steps at 512 px:
    10 per full UNet call, 5 per DeepCache-cached one (level 0 only), the
    full calls at every `interval`-th step from the first."""
    full = -(-steps // interval)
    return 10 * full + 5 * (steps - full)


# K1 launches of `calibrate_int8(num_calib_steps=4)`: one UNet call a step
CALIBRATION_K1 = 10 * 4
# steps of every request of the validate CLI's run (--steps): past its
# merge step (30), so each request runs the merged identity embeddings
VALIDATE_STEPS = 25


def validate_phase(paths, outdir):
    """The eval and checkpoint-validation CLIs on the written full-size set
    (fp16): `apps.validate.main` at full width (512 px, VALIDATE_STEPS
    DDIM steps, merge step 30) with every converter stage (an ONNX copy of the ArcFace
    pack written for the ONNX reader, the safety checker), the pipeline
    stage (SD1.5 and inpaint, one image each), FaceSim and CLIP-T (seeded
    random (1024, 768) and (1024, 1280) projection heads), `--sweep 4` and
    `--mode-sweep 4` (seven modes, a short warm-up and one batch of 4
    each); then `apps.eval_sweep.main --synthesize-protocol --limit 8
    --batch-size 4`. Fails unless every converter entry is ok, the report
    is ok, every mode has img_per_min, face_sim and clip_t, K1 ran on sm90
    exactly its count over the run (k1_per_request: 10 a step of a
    text-to-image request, fewer at DeepCache intervals 2 and 3, the
    inpaint at strength 0.8 its 80% of the steps, 10 a calibration step;
    the eval sweep at the same steps) and no other kernel ran. Random weights: the scores test
    the plumbing, not quality."""
    import numpy as np
    import torch
    from consistentid_torch.apps import eval_sweep, validate
    from consistentid_torch.io.onnx_reader import write_onnx_initializers
    from consistentid_torch.io.safetensors_reader import (read_checkpoint,
                                                          write_safetensors)
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.utils.png import encode_png

    root = Path(outdir) / "validate"
    root.mkdir()
    onnx = str(root / "arcface.onnx")
    write_onnx_initializers(onnx, read_checkpoint(paths["arcface_path"]))
    rng = np.random.RandomState(4)
    proj = str(root / "clip_projections.safetensors")
    write_safetensors(proj, {
        "text_projection.weight": (rng.randn(1024, 768) * 0.02).astype(
            np.float32),
        "visual_projection.weight": (rng.randn(1024, 1280) * 0.02).astype(
            np.float32)})
    face = str(root / "face.png")
    with open(face, "wb") as f:
        f.write(encode_png(face_inputs()[0]))
    report_path = str(root / "report.json")
    argv = ["--base", paths["base"],
            "--consistentid", paths["consistentid_path"],
            "--image-encoder", paths["image_encoder_path"],
            "--bisenet", paths["bisenet_path"],
            "--arcface", paths["arcface_path"], "--arcface-onnx", onnx,
            "--scrfd", paths["scrfd_path"],
            "--safety-checker", str(Path(paths["base"]) / "safety_checker"),
            "--clip-projections", proj, "--face", face, "--sweep", "4",
            "--mode-sweep", "4", "--steps", str(VALIDATE_STEPS),
            "--out", report_path]
    counters = launch_counters() + bn_counters()
    k1 = fa.flash_attention_fwd

    fa.reset_launches(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = validate.main(argv)
    seconds = time.perf_counter() - t0
    launches = [w.launches for w in counters]
    with open(report_path) as f:
        report = json.load(f)
    files = report["files"]
    bad = [k for k, e in files.items() if not e["ok"]]
    if rc != 0 or not report["ok"] or bad or len(files) != 10:
        raise AssertionError(f"validate: rc {rc}, ok {report['ok']}, "
                             f"entries {sorted(files)}, failing {bad}: "
                             f"{json.dumps(report)[:2000]}")
    modes = report["metrics"]["mode_sweep"]
    want_modes = [m for m, _, _ in validate.SERVING_MODES]
    if list(modes) != want_modes or any(
            not {"img_per_min", "face_sim", "clip_t"} <= set(r)
            for r in modes.values()):
        raise AssertionError(f"validate: mode sweep {modes}")
    # sd15, inpaint, the 4-row sweep, the calibration, then each mode's
    # warm-up and measured batch
    steps = VALIDATE_STEPS
    want_k1 = (k1_per_request(steps) + 10 * int(steps * 0.8)
               + k1_per_request(steps) + CALIBRATION_K1 + sum(
                   k1_per_request(validate.WARMUP_STEPS, interval)
                   + k1_per_request(steps, interval)
                   for _, _, interval in validate.SERVING_MODES))
    if (launches != [want_k1, 0, 0, 0, 0]
            or k1.launches_by_route["sm90"] != want_k1):
        raise AssertionError(
            f"validate: launches K1-K6 {launches} (K1 by route "
            f"{k1.launches_by_route}), K1 expected {want_k1} on sm90")
    for mode, _, interval in validate.SERVING_MODES:
        rec = modes[mode]
        log(f"validate mode {mode:>18} (batch 4, 512 px, {steps} DDIM steps,"
            f" one sample): {4 * 60 / rec['img_per_min']:.4f} s/request, "
            f"img/min {rec['img_per_min']}, face_sim {rec['face_sim']}, "
            f"clip_t {rec['clip_t']}, K1 {k1_per_request(steps, interval)} a"
            " request")
    metrics = report["metrics"]
    stage_s = report["seconds"]
    log(f"validate CLI on the 4.18 GiB fp16 set: {seconds:.1f} s in all "
        f"(converters {stage_s['converters']:.2f} s, every entry ok; "
        f"pipeline stages {stage_s['pipelines']:.2f} s); sd15 "
        f"{report['pipelines']['sd15']['shape']}, inpaint "
        f"{report['pipelines']['inpaint']['shape']}; face_sim "
        f"{metrics['face_sim']:.4f}, clip_t {metrics['clip_t']:.4f}; sweep "
        f"{metrics['sweep']}; K1 {launches[0]} on sm90 (expected {want_k1})"
        " (random weights: the scores test the plumbing, not quality)")

    out = root / "sweep"
    fa.reset_launches(*counters)
    rc = eval_sweep.main(["--base", paths["base"],
                          "--consistentid", paths["consistentid_path"],
                          "--image-encoder", paths["image_encoder_path"],
                          "--bisenet", paths["bisenet_path"],
                          "--arcface", paths["arcface_path"],
                          "--scrfd", paths["scrfd_path"],
                          "--output-dir", str(out),
                          "--synthesize-protocol", "--limit", "8",
                          "--batch-size", "4", "--steps",
                          str(VALIDATE_STEPS)])
    sweep_launches = [w.launches for w in counters]
    with open(out / "sweep_summary_shard0.json") as f:
        summary = json.load(f)
    want_k1 = 2 * k1_per_request(VALIDATE_STEPS)
    if (rc != 0 or summary["rows_this_shard"] != 8
            or sweep_launches != [want_k1, 0, 0, 0, 0]
            or k1.launches_by_route["sm90"] != want_k1
            or "mean_face_sim" not in summary):
        raise AssertionError(f"eval_sweep: rc {rc}, {summary}, launches "
                             f"{sweep_launches} (K1 by route "
                             f"{k1.launches_by_route})")
    log(f"eval_sweep CLI (--synthesize-protocol --limit 8 --batch-size 4, "
        f"512 px, 50 DDIM steps): {summary['rows_per_min']} rows/min over "
        f"{summary['wall_s']} s, mean latency {summary['mean_latency_s']:.3f}"
        f" s a row, K1 {want_k1} in 2 batches on sm90; {summary}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(seconds=seconds, stage_s=stage_s, modes=modes,
                face_sim=metrics["face_sim"], clip_t=metrics["clip_t"],
                sweep=metrics["sweep"], launches=launches,
                eval_sweep=summary, eval_sweep_launches=sweep_launches[0])


# headline (SD1.5, batch 4 with CFG: 8 rows, 512 px) shapes of the micro-
# table: NCHW convolution inputs with their kernel, token inputs with their
# output width
INT8_MICRO_SHAPES = (
    ("L0 conv3x3", (8, 320, 64, 64), 320, 3),
    ("L1 conv3x3", (8, 640, 32, 32), 640, 3),
    ("L2 conv3x3", (8, 1280, 16, 16), 1280, 3),
    ("L3 conv3x3", (8, 1280, 8, 8), 1280, 3),
    ("L0 to_q", (8, 4096, 320), 320, None),
    ("L0 GEGLU proj", (8, 4096, 320), 2560, None),
    ("L0 GEGLU out", (8, 4096, 1280), 320, None),
)
INT8_TENSOR_OPS = 1979e12     # H100 SXM dense int8 tensor-core peak


def int8_micro_table(smi: str):
    """One int8 layer (Int8Conv / Int8Dense: quantize, im2col, int_mm,
    dequant) dynamic and static, the int_mm GEMM alone, and the bf16
    F.conv2d / F.linear on the same input, at the headline's shapes, each
    timed by `cuda_ms` beside its bound (the larger of the bytes moved,
    input read once and output written once, over 3.35 TB/s and 2MNK over
    1979 int8 TOP/s or 989 bf16 TFLOP/s). int_mm is held against the
    exact integer product on the same im2col matrix, bit for bit; the
    int8 outputs against bf16's by relative L2 (quantization error,
    recorded)."""
    import torch
    import torch.nn.functional as F
    from consistentid_torch.models.layers import Int8Conv, Int8Dense
    from consistentid_torch.ops import quant
    from consistentid_torch.testing import rel_l2

    gen = torch.Generator("cuda").manual_seed(21)
    rows = []
    for label, shape, cout, k in INT8_MICRO_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        cin = shape[1] if k else shape[-1]
        wshape = (cout, cin, k, k) if k else (cout, cin)
        w = (0.02 * torch.randn(wshape, generator=gen, device="cuda")).to(
            torch.bfloat16)
        b = (0.02 * torch.randn(cout, generator=gen, device="cuda")).to(
            torch.bfloat16)
        kq, ks = (quant.quantize_conv_kernel(w) if k
                  else quant.quantize_dense_kernel(w))
        layers = {}
        for static in (False, True):
            layer = (Int8Conv(cin, cout, k, 1, k // 2, static=static) if k
                     else Int8Dense(cin, cout, static=static))
            state = {"kernel_q": kq, "kernel_scale": ks, "bias": b}
            if static:
                state["act_scale"] = x.float().abs().amax() / 127
            layer.load_state_dict(state, assign=True)
            layers["static" if static else "dynamic"] = layer
        if k:
            xq, _ = quant.quantize_symmetric(x, (1, 2, 3), keepdim=True)
            cols = quant.im2col_int8(xq, (k, k), 1, k // 2)[0]
            wmat = quant.conv_weight_matrix(kq)

            def bf16():
                return F.conv2d(x, w, b, padding=k // 2)
            m = cols.shape[0]
            out_numel = shape[0] * cout * shape[2] * shape[3]
        else:
            xq, _ = quant.quantize_symmetric(x, (2,), keepdim=True)
            cols = xq.reshape(-1, cin)
            wmat = kq.t()

            def bf16():
                return F.linear(x, w, b)
            m = cols.shape[0]
            out_numel = m * cout
        kdim = cols.shape[1]
        with torch.no_grad():
            exact = torch.equal(quant.int_mm(cols, wmat),
                                quant.int_mm_plain(cols, wmat))
            if not exact:
                raise AssertionError(f"{label}: int_mm differs from the "
                                     "exact integer product")
            ref = bf16().float()
            errs = {name: rel_l2(layer(x).float(), ref)
                    for name, layer in layers.items()}
            ms = {"bf16": cuda_ms(bf16, 20),
                  "int_mm": cuda_ms(lambda: quant.int_mm(cols, wmat), 20)}
            for name, layer in layers.items():
                ms[name] = cuda_ms(lambda: layer(x), 20)
        ops = 2.0 * m * kdim * cout
        io = x.numel() * 2 + out_numel * 2
        bound_bf16 = max((io + w.numel() * 2) / HBM_BYTES_PER_S,
                         ops / TENSOR_FLOPS) * 1e3
        bound_int8 = max((io + w.numel()) / HBM_BYTES_PER_S,
                         ops / INT8_TENSOR_OPS) * 1e3
        row = dict(shape=label, m=m, k=kdim, n=cout, ms=ms,
                   bound_int8_ms=bound_int8, bound_bf16_ms=bound_bf16,
                   rel_l2_vs_bf16=errs, int_mm_exact=exact)
        rows.append(row)
        log(f"int8 micro {label} (M {m}, K {kdim}, N {cout}; {smi}): bf16 "
            f"{ms['bf16']:.4f} ms (bound {bound_bf16:.4f}), int8 dynamic "
            f"{ms['dynamic']:.4f}, static {ms['static']:.4f}, int_mm alone "
            f"{ms['int_mm']:.4f} (bound {bound_int8:.4f}); rel L2 against "
            f"bf16 dynamic {errs['dynamic']:.4f}, static {errs['static']:.4f};"
            f" int_mm exact {exact}")
        if max(errs.values()) > 0.05:
            raise AssertionError(f"{label}: int8 layer off bf16 by {errs}")
    return rows


# ---------------------------------------------------------------- FGID

# phase 30's decode length for the timed captions (the FGID CLI decodes
# the JAX default, 512)
LLAVA_NEW_TOKENS = 64
# bound of the KV-cache check at 7B: the logits of the last prompt position
# and of 8 cached decode steps against one uncached forward over the same
# tokens, both in fp32 with TF32 off, where only the order of the sums
# differs (cuBLAS sums a one-row product in another order than a 700-row
# one) through 32 layers. In bf16 the same check read 1.6e-2 against a
# control of 7.9e-2 (PERF.md): too close to tell a cache fault apart. The
# control, the same logits one position off, must read far above it
LLAVA_CACHE_REL_L2 = 1e-4


def llava_decode_bytes(llama) -> int:
    """The weight bytes one decode step reads: every decoder tensor but
    the embedding table (one gathered row per sequence)."""
    return sum(t.numel() * t.element_size()
               for n, t in llama.state_dict().items()
               if not n.startswith("embed_tokens."))


def seeded_faces(n: int, size: int = 512, seed: int = 30):
    """n uint8 faces (noise over a seeded colour field)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [np.clip(rng.randint(40, 200, (1, 1, 3))
                    + rng.randint(-40, 40, (size, size, 3)), 0,
                    255).astype(np.uint8) for _ in range(n)]


def timed_caption(cap, faces):
    """cap.caption_batch(faces) (both FGID prompts) on the card: seconds,
    prefill ms (mean of the two prompts), decode ms a step (the replayed
    CUDA graph), decoded tokens a row, int_mm launches a decoded token,
    peak GiB (greedy_generate.events)."""
    import torch
    from consistentid_torch.models.llama import greedy_generate
    from consistentid_torch.ops import quant
    greedy_generate.events = []
    torch.cuda.reset_peak_memory_stats()
    before = quant.int_mm.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        captions = cap.caption_batch(faces)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        events = greedy_generate.events
    finally:
        greedy_generate.events = None
    if len(captions) != len(faces) or not all(
            isinstance(c, str) and isinstance(d, str) for c, d in captions):
        raise AssertionError(f"captions {captions!r}")
    prefill = [e["prefill"][0].elapsed_time(e["prefill"][1]) for e in events]
    decode = sum(e["decode"][0].elapsed_time(e["decode"][1]) for e in events)
    steps = sum(e["steps"] for e in events)
    calls = len(events) + steps           # prefills and decode steps
    return dict(seconds=seconds, prefill_ms=sum(prefill) / len(prefill),
                decode_ms_per_token=decode / steps,
                tokens_per_row=calls // len(events),
                decode_tokens_per_s=len(faces) * steps / decode * 1e3,
                tokens_per_s=len(faces) * calls / seconds,
                int_mm_per_call=(quant.int_mm.launches - before) / calls,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                caption=captions[0][0][:60])


def llava_cache_check(cap, face):
    """Prefill + 8 cached decode steps (batch 1, the caption prompt, each
    step over the whole cache as greedy_generate runs it) against one
    uncached forward over the same tokens, on the card in fp32 (an fp32
    copy of the bf16 decoder, TF32 off, so that only the order of the
    sums differs): the logits of the last prompt position and of each
    step by relative L2 (LLAVA_CACHE_REL_L2), the control the same logits
    one position off."""
    import torch
    from consistentid_torch.models.llama import LlamaForCausalLM, init_cache
    from consistentid_torch.testing import rel_l2, tf32_off
    bf16 = cap.model.llama
    with torch.device("meta"):
        llama = LlamaForCausalLM(bf16.config)
    llama.load_state_dict({k: v.float() for k, v in
                           bf16.state_dict().items()}, assign=True)
    pre, post = cap._encode_parts(cap.caption_prompt)
    with torch.no_grad(), tf32_off():
        feats = cap.model.mm(torch.from_numpy(cap._pixels(face)).cuda())

        def embed(ids):
            return llama.embed_tokens(torch.as_tensor(ids).cuda()[None])
        prompt = torch.cat([embed(pre), feats.float(), embed(post)], dim=1)
        n = prompt.shape[1]
        cache = init_cache(llama.config, 1, n + 8, dtype=torch.float32,
                           device="cuda")
        logits, cache = llama(None, cache=cache, attn_len=n,
                              inputs_embeds=prompt)
        rows, toks = [logits[:, -1]], []
        for i in range(8):
            toks.append(rows[-1].argmax(-1))
            logits, cache = llama(toks[-1][:, None], cache=cache,
                                  cache_index=n + i, attn_len=n + 8)
            rows.append(logits[:, -1])
        cached = torch.stack(rows, dim=1)
        full, _ = llama(None, inputs_embeds=torch.cat(
            [prompt, llama.embed_tokens(torch.stack(toks, dim=1))], dim=1))
        want = full[:, n - 1:]
    rel = rel_l2(cached, want)
    control = rel_l2(cached[:, 1:], want[:, :-1])
    del llama, cache, full
    torch.cuda.empty_cache()
    if not (rel <= LLAVA_CACHE_REL_L2 < control):
        raise AssertionError(f"LLaVA KV cache: logits relative L2 {rel:.4g}"
                             f" (limit {LLAVA_CACHE_REL_L2}), control one "
                             f"position off {control:.4g}")
    log(f"LLaVA KV cache (fp32 copy, TF32 off, {n} prompt tokens + 8 "
        f"steps): logits relative L2 {rel:.3g} against one uncached "
        f"forward (limit {LLAVA_CACHE_REL_L2}); control one position off "
        f"{control:.3g}")
    return dict(prompt_tokens=n, rel_l2=rel, control_rel_l2=control)


def write_llava_set(model, set_dir, shard_bytes: int = 2 << 30):
    """The model as an HF llava-hf set (modern keys) of bf16 safetensors
    shards with an index, each tensor copied to the host on its own, and
    the synthetic 32000-entry tokenizer: (bytes, seconds)."""
    from consistentid_torch.io.export_backbones import llava_to_hf
    from consistentid_torch.io.safetensors_reader import \
        write_safetensors_torch
    from consistentid_torch.testing import write_llama_tokenizer
    t0 = time.perf_counter()
    hf = llava_to_hf(model.state_dict(), model.config)
    shards, size = [[]], 0
    for key in sorted(hf):
        nbytes = hf[key].numel() * hf[key].element_size()
        if shards[-1] and size + nbytes > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(key)
        size += nbytes
    weight_map, total = {}, 0
    for i, keys in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors_torch(str(Path(set_dir, name)),
                                         {k: hf[k] for k in keys})
        weight_map.update(dict.fromkeys(keys, name))
    Path(set_dir, "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    write_llama_tokenizer(str(set_dir))
    return total, time.perf_counter() - t0


def llava_phase(set_dir, smi: str):
    """LLaVA-1.5-7B at full width (LlavaConfig(): ViT-L/14-336, 24
    layers; Llama-2-7B, 32 layers), bf16, random weights from a seeded
    generator built on the card, written as an HF llava-hf set and loaded
    back through `LlavaCaptioner.from_pretrained` (every tensor the
    written bits); the KV-cache check; then `caption_batch` at batch 1
    and 4 in bf16, int8 and int8 + kv_quant, LLAVA_NEW_TOKENS a row:
    prefill ms, decode ms/token beside its bound (the decoder's weight
    bytes a step over 3.35 TB/s), tokens/s, peak GiB, int_mm launches a
    model call (7 a layer + lm_head under int8)."""
    import torch
    from consistentid_torch.conditioning.captioner import LlavaCaptioner
    from consistentid_torch.core.config import LlavaConfig
    from consistentid_torch.models.llava import random_llava

    cfg = LlavaConfig()
    t0 = time.perf_counter()
    model = random_llava(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    build_s = time.perf_counter() - t0
    nbytes, write_s = write_llava_set(model, set_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf16 = LlavaCaptioner.from_pretrained(str(set_dir), device="cuda",
                                          max_new_tokens=LLAVA_NEW_TOKENS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    src, got = model.state_dict(), bf16.model.state_dict()
    bad = [k for k in src if not torch.equal(src[k], got[k])]
    if set(src) != set(got) or bad:
        raise AssertionError(f"LLaVA set: loaded tensors differ {bad[:5]}")
    del model, src, got
    torch.cuda.empty_cache()
    log(f"LLaVA-1.5-7B: {n_params / 1e9:.3f} B params bf16 built on the "
        f"card in {build_s:.1f} s; the llava-hf set {nbytes} bytes "
        f"({nbytes / 2 ** 30:.2f} GiB, bf16 shards) written in "
        f"{write_s:.1f} s, loaded by from_pretrained in {load_s:.2f} s, "
        f"every tensor the written bits")
    int8 = LlavaCaptioner(bf16.model, bf16.tokenizer, quant="int8",
                          max_new_tokens=LLAVA_NEW_TOKENS)
    int8_kv = LlavaCaptioner(int8.model, bf16.tokenizer, quant="int8",
                             kv_quant=True, max_new_tokens=LLAVA_NEW_TOKENS)
    faces = seeded_faces(4)
    cache = llava_cache_check(bf16, faces[0])
    modes = {"bf16": bf16, "int8": int8, "int8_kv": int8_kv}
    runs = {}
    for mode, cap in modes.items():
        bound_ms = llava_decode_bytes(cap.model.llama) / HBM_BYTES_PER_S * 1e3
        LlavaCaptioner(cap.model, cap.tokenizer, max_new_tokens=4,
                       kv_quant=cap.kv_quant).caption_batch(faces[:1])
        for b in (1, 4):
            r = timed_caption(cap, faces[:b])
            r["decode_bound_ms"] = bound_ms
            want_mm = (7 * cfg.text.num_layers + 1) if mode != "bf16" else 0
            if r["int_mm_per_call"] != want_mm:
                raise AssertionError(f"LLaVA {mode}: int_mm launches a call "
                                     f"{r['int_mm_per_call']}, expected "
                                     f"{want_mm}")
            runs[f"{mode}_b{b}"] = r
            log(f"LLaVA {mode} batch {b}, {r['tokens_per_row']} tokens a "
                f"row, both prompts: {r['seconds']:.3f} s, prefill "
                f"{r['prefill_ms']:.2f} ms, decode "
                f"{r['decode_ms_per_token']:.3f} ms/token (bound "
                f"{bound_ms:.3f} ms: weight bytes over 3.35 TB/s), "
                f"{r['decode_tokens_per_s']:.1f} decode tokens/s, "
                f"{r['tokens_per_s']:.1f} tokens/s end to end, peak "
                f"{r['peak_gib']:.2f} GiB, int_mm {r['int_mm_per_call']:g} a"
                f" call; caption {r['caption']!r} ({smi})")
    del modes, bf16, int8, int8_kv, cap
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params_b=n_params / 1e9, set_bytes=nbytes, write_s=write_s,
                load_s=load_s, build_s=build_s, cache_check=cache, runs=runs)


def fgid_cli_phase(paths, outdir, set_dir):
    """`apps.fgid.main` end to end on the card over 8 PNG faces at 512 px:
    mask (BiSeNet of the phase-12 set, batch 8), caption with the LLaVA
    set (--batch 4, the JAX default of 512 new tokens), faceid (the
    phase-12 ArcFace pack), fuse; then `apps.precompute.main` over the
    fused JSON_all.json. Images/s a stage (caption with its load), the
    decode route (native or numpy, with the compiler's last error line
    if the native loader did not build)."""
    import numpy as np
    import torch
    from consistentid_torch.apps import fgid
    from consistentid_torch.apps import precompute as precompute_cli
    from consistentid_torch.io import native_loader
    from consistentid_torch.utils.png import decode_png, encode_png

    root = Path(outdir, "fgid")
    images, out = root / "images", root / "out"
    images.mkdir(parents=True)
    faces = seeded_faces(8, seed=31)
    for i, face in enumerate(faces):
        (images / f"face{i}.png").write_bytes(encode_png(face))
    stages = {
        "mask": ["mask", "--bisenet", paths["bisenet_path"],
                 "--batch-size", "8"],
        "caption": ["caption", "--captioner-llava", str(set_dir),
                    "--batch", "4"],
        "faceid": ["faceid", "--arcface", paths["arcface_path"]],
        "fuse": ["fuse"]}
    seconds = {}
    for stage, argv in stages.items():
        io = ["--out", str(out)] + ([] if stage == "fuse"
                                    else ["--images", str(images)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fgid.main(argv[:1] + io + argv[1:]) != 0:
            raise AssertionError(f"apps.fgid {stage} failed")
        torch.cuda.synchronize()
        seconds[stage] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    manifest = json.loads((out / "JSON_all.json").read_text())
    keys = {"image_path", "parsing_mask_path", "faceid_path", "vqa_llva",
            "vqa_llva_more_face_detail"}
    if sorted(manifest) != [f"face{i}" for i in range(8)] or any(
            set(e) != keys for e in manifest.values()):
        raise AssertionError(f"JSON_all.json: {manifest}")
    for entry in manifest.values():
        labels = decode_png((out / entry["parsing_mask_path"]).read_bytes())
        emb = np.fromfile(out / entry["faceid_path"], np.float32)
        if labels.shape != (512, 512, 1) or labels.max() >= 19 or \
                emb.shape != (512,) or abs(np.linalg.norm(emb) - 1) > 1e-3:
            raise AssertionError(f"fgid outputs {entry}: labels "
                                 f"{labels.shape}, embedding {emb.shape}")
    enc = root / "encoded"
    t0 = time.perf_counter()
    if precompute_cli.main([
            "--base", paths["base"],
            "--image-encoder", paths["image_encoder_path"],
            "--tokenizer", str(Path(paths["base"], "tokenizer")),
            "--manifest", str(out / "JSON_all.json"), "--data-root",
            str(out), "--out", str(enc), "--batch-size", "4"]) != 0:
        raise AssertionError("apps.precompute on the fused manifest failed")
    seconds["precompute"] = time.perf_counter() - t0
    n_encoded = len(json.loads((enc / "encoded_manifest.json")
                               .read_text())["samples"])
    if n_encoded != 8:
        raise AssertionError(f"precompute encoded {n_encoded} of 8 entries")
    route = native_loader.route()
    per_s = {k: 8 / v for k, v in seconds.items()}
    log(f"apps.fgid on the card, 8 faces at 512 px: seconds "
        f"{ {k: round(v, 2) for k, v in seconds.items()} }, images/s "
        f"{ {k: round(v, 2) for k, v in per_s.items()} } (caption with its "
        f"load, 512 new tokens a row at batch 4); decode route {route}; "
        f"precompute encoded {n_encoded} entries of the fused manifest")
    shutil.rmtree(root)
    return dict(seconds=seconds, images_per_s=per_s, route=route,
                build_error=native_loader.BUILD_ERROR, encoded=n_encoded)


def tiny_llava_check():
    """The tiny fp32 LLaVA's caption ids (batch 2, both FGID prompts, 16
    tokens) on the card against the CPU, TF32 off: equal."""
    import copy

    import numpy as np
    import torch
    from consistentid_torch.conditioning.captioner import (CAPTION_PROMPT,
                                                           DETAIL_PROMPT,
                                                           LlavaCaptioner)
    from consistentid_torch.conditioning.llama_tokenizer import \
        LlamaTokenizer
    from consistentid_torch.models.llava import random_llava
    from consistentid_torch.testing import (synthetic_llama_tokenizer_json,
                                            tf32_off, tiny_llava_config)
    cpu = random_llava(tiny_llava_config(), seed=0).eval()
    card = copy.deepcopy(cpu).cuda()
    tok = LlamaTokenizer(synthetic_llama_tokenizer_json(512))
    faces = [f[:40 + 8 * i, :36] for i, f in
             enumerate(seeded_faces(2, size=64, seed=32))]
    with tf32_off():
        ids = {dev: [LlavaCaptioner(m, tok, max_new_tokens=16)
                     .generate_ids(faces, p)
                     for p in (CAPTION_PROMPT, DETAIL_PROMPT)]
               for dev, m in (("cpu", cpu), ("cuda", card))}
    same = all(np.array_equal(a, b) for a, b in zip(ids["cpu"],
                                                    ids["cuda"]))
    if not same:
        raise AssertionError(f"tiny LLaVA ids card {ids['cuda']} != CPU "
                             f"{ids['cpu']}")
    log(f"tiny LLaVA fp32 (TF32 off): caption ids on the card equal the "
        f"CPU's, 2 images x 2 prompts x 16 tokens")
    return dict(equal=same)


def fgid_phase(paths, outdir, smi: str, set_dir: Path):
    """Phase 30: LLaVA-1.5-7B on the card (`llava_phase`), written to
    `set_dir` (left for phase 31), `apps.fgid` end to end with
    `apps.precompute` over its manifest (`fgid_cli_phase`), the tiny LLaVA
    card against CPU; K1-K6 launched 0 times over it."""
    import torch
    from consistentid_torch.ops import flash_attention as fa
    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    set_dir.mkdir()
    t0 = time.perf_counter()
    llava = llava_phase(set_dir, smi)
    cli = fgid_cli_phase(paths, outdir, set_dir)
    tiny = tiny_llava_check()
    launches = [w.launches for w in counters]
    if any(launches):
        raise AssertionError(f"phase 30: K1, K2, K3 + K4, K5, K6 launched "
                             f"{launches}, expected none")
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"phase 30 (LLaVA-1.5-7B, apps.fgid, precompute): {seconds:.1f} s,"
        f" K1-K6 launches {launches}")
    return dict(llava=llava, cli=cli, tiny=tiny, launches=launches,
                seconds=seconds)


# ----------------------------------------------- phases 31 and 32: 2 ranks

PAR_STEPS = 3       # denoising steps of the parallel phase's requests
PAR_NEW_TOKENS = 16
PAR_TRAIN_STEPS = 3
# the TP=2 UNet call against world size 1: the UNet path check's bound
# (bf16: the row-parallel partial products round to bf16 before their sum)
PAR_UNET_REL_MAX = 0.02
# LLaVA-1.5-7B's TP=2 prefill logits against world size 1, relative L2:
# bf16 partial products of o_proj and down_proj, rounded before their sum,
# through 32 layers (first reading on an H100: 2.21e-2, argmax agreement
# 97.4%, 16 of 16 greedy tokens equal)
PAR_LLAVA_LOGITS_REL_L2 = 4e-2


def _rank_clock(counters):
    """A timer over one call made by every rank at once: barrier, launch
    counts to 0, the call, a sync; (result, seconds, launches)."""
    import torch
    import torch.distributed as dist
    from consistentid_torch.ops import flash_attention as fa

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        fa.reset_launches(*counters)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, [c.launches for c in counters]
    return timed


def _one_rank(fn, main: bool):
    """fn() on rank 0 alone, timed on the otherwise idle card (world size
    1's reference); the other rank waits at the next barrier."""
    import torch
    if not main:
        return None, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _sd15_bundle():
    import torch
    from consistentid_torch.core import AdapterConfig, sd15_unet_config
    from consistentid_torch.pipelines import SD15Bundle
    bundle = SD15Bundle(sd15_unet_config(lora_rank=128, ip_num_tokens=4),
                        AdapterConfig(), dtype=torch.bfloat16, device="cuda")
    bundle.random_params(torch.Generator("cuda").manual_seed(0))
    return bundle


def _u8_diff(got, want) -> dict:
    import numpy as np
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"max": int(d.max()), "mean": float(d.mean()),
            "share_over_1": float((d > 1).mean())}


def parallel_rank(set_dir: str) -> dict:
    """One of two ranks on the card (phase 31): the full-width SD1.5 bundle
    of phase 4 (seed 0) under TP=2 (a UNet call, generate) and DP=2
    (generate_batch of 4), LLaVA-1.5-7B of phase 30's set under TP=2, and
    3 DP=2 train steps; rank 0 also runs every world-size-1 reference and
    holds the results to it."""
    import numpy as np
    import torch
    from consistentid_torch.conditioning.captioner import (LlavaCaptioner,
                                                           load_llava)
    from consistentid_torch.conditioning.llama_tokenizer import \
        LlamaTokenizer
    from consistentid_torch.core import (PipelineConfig, SchedulerConfig,
                                         TrainConfig)
    from consistentid_torch.models.llama import greedy_generate
    from consistentid_torch.parallel import (make_mesh, shard_batch,
                                             tensor_parallel_unet, world_size)
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.testing import (deterministic, rel_l2,
                                            synthetic_clip_tokenizer)
    from consistentid_torch.training import (create_train_state, make_draws,
                                             make_train_step, synthetic_batch,
                                             warm_start_ip_projections)

    if world_size() != 2:
        raise AssertionError(f"parallel: world size {world_size()}, not 2")
    tp_mesh, dp_mesh = make_mesh(model=2), make_mesh()
    main = dp_mesh.is_main
    counters = launch_counters() + bn_counters()
    timed = _rank_clock(counters)
    t_rank = time.perf_counter()

    def note(what):
        if main:
            log(f"  rank 0 [{time.perf_counter() - t_rank:.1f} s]: {what}")
    out = {"rank": dp_mesh.rank, "backend": dp_mesh.backend,
           "device": str(dp_mesh.device)}

    # -- SD1.5 serving: TP=2 UNet call and generate, DP=2 generate_batch
    bundle = _sd15_bundle()
    tok = synthetic_clip_tokenizer()
    cfg = PipelineConfig(height=512, width=512,
                         num_inference_steps=PAR_STEPS, start_merge_step=6)
    one, tp, dp = (ConsistentIDPipeline(bundle, tok, pipeline_config=cfg,
                                        mesh=m)
                   for m in (None, tp_mesh, dp_mesh))
    gen = torch.Generator("cuda").manual_seed(2)
    x = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((8,), 501.0, device="cuda")
    ctx = torch.randn((8, 81, 768), generator=gen, device="cuda")
    with torch.no_grad():
        unet = bundle.infer_unet(1.0)
        ref, _ = _one_rank(lambda: unet(x, t, ctx).float(), main)
        split = tensor_parallel_unet(unet, tp_mesh)
        got, s, launches = timed(lambda: split(x, t, ctx).float())
    heads = split.down_0_attn_0.blocks_0.attn1.heads
    out["unet_call"] = {"k1_launches": launches[0], "s": s,
                        "heads_per_rank_level0": heads}
    if main:
        diff = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        out["unet_call"].update(max_abs_diff=diff, max_abs_ref=scale,
                                rel_l2=rel_l2(got, ref))
        if not (diff <= PAR_UNET_REL_MAX * scale and launches[0] == 10
                and heads == 4):
            raise AssertionError(f"parallel: TP=2 UNet call {out['unet_call']}")
    del unet, split
    note(f"TP=2 UNet call {out['unet_call']}")
    face, labels, faceid = face_inputs()
    kw = dict(parsing_labels=labels, faceid_embeds=faceid,
              num_images_per_prompt=2)
    ref, s1 = _one_rank(lambda: one.generate(PROMPT, face, seed=3, **kw),
                        main)
    got, s, launches = timed(lambda: tp.generate(PROMPT, face, seed=3, **kw))
    out["tp_generate"] = {"images": 2, "s_per_request": s,
                          "one_rank_s": s1, "launches": launches[:3]}
    if main:
        out["tp_generate"]["u8_diff"] = _u8_diff(got, ref)
    if got.shape != (2, 512, 512, 3) or launches[0] != 10 * PAR_STEPS:
        raise AssertionError(f"parallel: TP generate {got.shape} "
                             f"{launches}")
    note(f"TP=2 generate {out['tp_generate']}")
    faces = [np.roll(face, 37 * i, axis=1) for i in range(4)]
    bkw = dict(parsing_labels_list=[labels] * 4,
               faceid_embeds_list=[faceid] * 4, seeds=[11, 12, 13, 14])
    ref, s1 = _one_rank(
        lambda: one.generate_batch([PROMPT] * 4, faces, **bkw), main)
    got, s, launches = timed(
        lambda: dp.generate_batch([PROMPT] * 4, faces, **bkw))
    out["dp_generate_batch"] = {"requests": 4, "s": s,
                                "s_per_request": s / 4,
                                "one_rank_s_per_request":
                                    None if s1 is None else s1 / 4,
                                "launches": launches[:3]}
    if main:
        out["dp_generate_batch"]["u8_diff"] = _u8_diff(got, ref)
    if got.shape != (4, 512, 512, 3) or launches[0] != 10 * PAR_STEPS:
        raise AssertionError(f"parallel: DP generate_batch {got.shape} "
                             f"{launches}")
    note(f"DP=2 generate_batch {out['dp_generate_batch']}")
    del one, tp, dp, bundle
    torch.cuda.empty_cache()

    # -- LLaVA-1.5-7B: TP=2 prefill logits and 16 greedy tokens
    full = load_llava(set_dir, device="cuda")
    llama_tok = LlamaTokenizer.from_pretrained(set_dir)
    ids = torch.tensor([llama_tok.encode(
        "USER: Please describe the people in the image. ASSISTANT:")],
        device="cuda")
    eos = int(llama_tok.eos_token_id)

    def prefill(llama):
        with torch.no_grad():
            return llama(ids)[0].float()

    def decode(llama):
        return greedy_generate(llama, ids, PAR_NEW_TOKENS, eos)

    ref, _ = _one_rank(lambda: prefill(full.llama), main)
    ref_tok, s1 = _one_rank(lambda: decode(full.llama), main)
    cap = LlavaCaptioner(full, llama_tok, mesh=tp_mesh,
                         max_new_tokens=PAR_NEW_TOKENS)
    del full
    torch.cuda.empty_cache()
    llama = cap.model.llama
    got, _, _ = timed(lambda: prefill(llama))
    toks, s, launches = timed(lambda: decode(llama))
    out["llava"] = {"prefill_tokens": ids.shape[1], "eager": llama.eager_decode,
                    "kv_heads_per_rank": llama.kv_heads,
                    "decode_ms_per_token": s / PAR_NEW_TOKENS * 1e3,
                    "one_rank_decode_ms_per_token":
                        None if s1 is None else s1 / PAR_NEW_TOKENS * 1e3,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "launches": launches}
    if main:
        same = (toks == ref_tok).reshape(-1).tolist()
        out["llava"].update(
            logits_rel_l2=rel_l2(got, ref),
            argmax_agreement=float((got.argmax(-1) == ref.argmax(-1))
                                   .float().mean()),
            tokens_equal_prefix=(same + [False]).index(False))
        if out["llava"]["logits_rel_l2"] > PAR_LLAVA_LOGITS_REL_L2:
            raise AssertionError(f"parallel: LLaVA TP logits {out['llava']}")
    if any(launches) or llama.kv_heads != 16:
        raise AssertionError(f"parallel: LLaVA TP {out['llava']}")
    note(f"LLaVA TP=2 {out['llava']}")
    del cap, llama
    torch.cuda.empty_cache()

    # -- 3 DP=2 train steps (batch 2 a rank, 512 px) against one rank's
    # grad-accumulation step over the same two shards and draws
    sched = NoiseSchedule.create(SchedulerConfig())
    t_train = sched.config.num_train_timesteps
    batches = [synthetic_batch(4, 512, 224, 512, seed=s)
               for s in range(PAR_TRAIN_STEPS)]

    def draws(i, r):
        g = torch.Generator("cuda").manual_seed(100 * i + r)
        return make_draws(g, (2, 64, 64, 4), t_train, torch.bfloat16)

    def fresh(config):
        b = _sd15_bundle()
        warm_start_ip_projections(b.unet)
        return b, create_train_state(b, config)

    accum = TrainConfig(grad_accum_steps=2)
    ref = ref_losses = times = None
    if main:
        b, state = fresh(accum)
        step = make_train_step(b, sched, accum)
        ref_losses, times = [], []
        with deterministic():
            for i, batch in enumerate(batches):
                stacked = {k: v.reshape(2, 2, *v.shape[1:])
                           for k, v in batch.items()}
                (_, m), s1 = _one_rank(lambda: step(
                    state, stacked, [draws(i, 0), draws(i, 1)]), True)
                ref_losses.append(float(m["loss"]))
                times.append(s1)
        ref = {k: v.detach().clone() for k, v in state.trainable.items()}
        del b, state, step
        torch.cuda.empty_cache()
    b, state = fresh(TrainConfig())
    step = make_train_step(b, sched, TrainConfig(), mesh=dp_mesh)
    dp_losses, dp_times, dp_launches = [], [], []
    with deterministic():
        for i, batch in enumerate(batches):
            (_, m), s, launches = timed(lambda: step(
                state, shard_batch(dp_mesh, batch), draws(i, dp_mesh.rank)))
            dp_losses.append(float(m["loss"]))
            dp_times.append(s)
            dp_launches.append(launches[:3])
    out["dp_train"] = {"s_per_step": dp_times, "losses": dp_losses,
                       "launches_per_step": dp_launches}
    note(f"DP=2 train {out['dp_train']}")
    if main:
        out["dp_train"].update(one_rank_accum_s_per_step=times,
                               one_rank_losses=ref_losses)
        loss_ok = all(abs(a - r) <= 1e-5 * abs(r)
                      for a, r in zip(dp_losses, ref_losses))
        bad = [k for k, v in state.trainable.items() if not torch.allclose(
            v.detach(), ref[k], rtol=2e-4, atol=2e-6)]
        worst = max(((v.detach() - ref[k]).abs().max().item(), k)
                    for k, v in state.trainable.items())
        out["dp_train"].update(masters_off=len(bad), worst_master=worst)
        if bad or not loss_ok:
            raise AssertionError(f"parallel: DP train losses {dp_losses} vs "
                                 f"{ref_losses}; masters {len(bad)} leaves "
                                 f"off the one-rank step: {worst}")
    if any(l != [0, 10, 10] for l in dp_launches):
        raise AssertionError(f"parallel: DP train launches {dp_launches}")
    return out


def serve_tp_phase(paths, outdir) -> dict:
    """`apps.serve.main --tp 2` on the one card (512 px, PAR_STEPS DDIM
    steps, max batch 2, no warm-up): one visible card means no mesh, as the
    JAX server on one chip, so it serves single-device (asserted: the
    batcher's pipeline has no mesh and no lockstep) and answers 2
    concurrent requests 200 with (512, 512, 3) PNGs."""
    import base64
    import json
    import threading
    import urllib.request
    import torch
    from consistentid_torch.apps import serve as serve_app
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.utils.png import decode_png, encode_png

    held = {}
    real_serve = serve_app.serve

    def keep(*a, **kw):
        held["server"], held["batcher"] = real_serve(*a, **kw)
        held["pipe"] = a[0]
        return held["server"], held["batcher"]

    argv = infer_args(paths, outdir, "--tp", "2", "--height", "512",
                      "--width", "512", "--steps", str(PAR_STEPS),
                      "--max-batch", "2", "--port", "0", "--no-warmup")
    serve_app.serve = keep
    thread = threading.Thread(target=serve_app.main, args=(argv,),
                              daemon=True)
    t0 = time.perf_counter()
    try:
        thread.start()
        while "server" not in held:
            if not thread.is_alive():
                raise AssertionError("serve --tp 2: the server exited")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("serve --tp 2: no server in 300 s")
            time.sleep(0.5)
        pipe = held["pipe"]
        ranks = serve_app.mesh_ranks(1, 2, torch.cuda.device_count())
        if (isinstance(pipe, serve_app.LockstepPipeline)
                or getattr(pipe, "mesh", None) is not None or ranks != 1):
            raise AssertionError(f"serve --tp 2 on one card: {ranks} ranks, "
                                 f"pipeline {type(pipe).__name__}")
        url = f"http://127.0.0.1:{held['server'].server_address[1]}"
        face = face_inputs()[0]
        bodies = [json.dumps({"prompt": PROMPT, "seed": 5 + i,
                              "image_b64": base64.b64encode(encode_png(
                                  face)).decode()}).encode()
                  for i in range(2)]

        def post(body):
            req = urllib.request.Request(url + "/generate", data=body)
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())

        fa.reset_launches()
        t1 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            replies = list(pool.map(post, bodies))
        s = time.perf_counter() - t1
        for code, payload in replies:
            img = decode_png(base64.b64decode(payload["image_b64"]))
            if code != 200 or img.shape != (512, 512, 3):
                raise AssertionError(f"serve --tp 2: {code} {img.shape}")
        k1 = fa.flash_attention_fwd.launches
        log(f"serve --tp 2 on 1 card: single-device (no mesh), 2 requests "
            f"in {s:.3f} s, K1 {k1}")
        return dict(ranks=ranks, wall_s=s, k1_launches=k1,
                    s_per_request=s / 2)
    finally:
        serve_app.serve = real_serve
        if "server" in held:
            held["server"].shutdown()
        thread.join(timeout=120)
        if thread.is_alive():
            raise AssertionError("serve --tp 2: the server thread did not "
                                 "stop")


def parallel_phase(paths, outdir, set_dir) -> dict:
    """Phase 31: two ranks on the one card over gloo, started by the port's
    launcher (`parallel_rank`), then `serve --tp 2` (`serve_tp_phase`)."""
    import torch
    from consistentid_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch(parallel_rank, 2, str(set_dir), device_type="cuda")
    ranks_s = time.perf_counter() - t0
    served = serve_tp_phase(paths, outdir)
    torch.cuda.empty_cache()
    r0 = ranks[0]
    log(f"phase 31 (2 ranks, {r0['backend']}, one card): ranks "
        f"{ranks_s:.1f} s; TP=2 UNet call {r0['unet_call']}; TP=2 generate "
        f"{r0['tp_generate']}; DP=2 generate_batch "
        f"{r0['dp_generate_batch']}; LLaVA TP=2 {r0['llava']}; DP=2 train "
        f"{r0['dp_train']}; rank 1 launches: UNet "
        f"{ranks[1]['unet_call']['k1_launches']}, generate "
        f"{ranks[1]['tp_generate']['launches']}, generate_batch "
        f"{ranks[1]['dp_generate_batch']['launches']}, train "
        f"{ranks[1]['dp_train']['launches_per_step']}")
    return dict(ranks=ranks, ranks_s=ranks_s, serve=served)


def _bisenet_start(path):
    import torch
    from consistentid_torch.training.bisenet_train import \
        create_bisenet_train_state
    return create_bisenet_train_state(
        device="cuda", state=torch.load(path, weights_only=False))


def bisenet_rank(path: str) -> dict:
    """One of two ranks (phase 32): one SyncBN step on its 8 images from
    the saved state (TF32 off)."""
    import torch
    from consistentid_torch.parallel import make_mesh, shard_rows, world_size
    from consistentid_torch.testing import tf32_off
    from consistentid_torch.training.bisenet_train import \
        make_bisenet_train_step

    if world_size() != 2:
        raise AssertionError(f"BiSeNet: world size {world_size()}, not 2")
    mesh = make_mesh()
    data = torch.load(path, weights_only=False)
    state = _bisenet_start(path)
    rows = shard_rows(data["images"].shape[0], mesh)
    with tf32_off():
        state, m = make_bisenet_train_step(mesh)(
            state, data["images"][rows], data["labels"][rows])
    return {"loss": float(m["loss"]), "backend": mesh.backend,
            "state": {k: v.cpu() for k, v in
                      state.model.state_dict().items()}}


def _write_bisenet_data(root: Path, n: int = 16):
    """n synthetic 512 px faces (PNG) and CelebAMask-HQ-style part masks
    (`{i // 2000}/{i:05d}_{part}.png`, 255 inside an ellipse, 225 on a
    few pixels) for `bisenet_tools preprocess`."""
    import numpy as np
    from consistentid_torch.apps.bisenet_tools import CELEBA_PARTS
    from consistentid_torch.utils.png import encode_png

    rng = np.random.RandomState(32)
    faces, masks = root / "faces", root / "masks" / "0"
    faces.mkdir(parents=True)
    masks.mkdir(parents=True)
    yy, xx = np.mgrid[:512, :512]
    for i in range(n):
        img = rng.randint(0, 255, (512, 512, 3), np.uint8)
        (faces / f"{i}.jpg").write_bytes(encode_png(img))   # PNG bytes
        for part, _ in CELEBA_PARTS[::2]:
            cy, cx = rng.randint(64, 448, 2)
            ry, rx = rng.randint(20, 120, 2)
            m = ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1)
            m = np.where(m, 255, 0).astype(np.uint8)
            m[rng.rand(512, 512) < 0.01] = 225
            (masks / f"{i:05d}_{part}.png").write_bytes(encode_png(m))
    return faces, root / "masks"


def bisenet_phase(outdir) -> dict:
    """Phase 32: BiSeNet training at the JAX hyperparameters (batch 16,
    crop 448, 19 classes, SGD momentum 0.9, lr 1e-2): `bisenet_tools
    preprocess` over 16 synthetic part-mask sets, `FaceMaskDataset` over
    them and 16 synthetic faces, 5 single-rank steps (s/step, peak GiB),
    then 2 ranks x 8 with SyncBN against 1 x 16 from the same state (the
    one-device replay of the 2-rank step, `ohem_shards=2`; TF32 off):
    loss 1e-5 relative, parameters rtol 2e-4 / atol 2e-6,
    batch statistics 2e-4 / 1e-5; `bisenet_tools evaluate` and `makeup`
    over the trained parser; K5/K6 launches (none: the trainer's
    BatchNorm is flax's, plain torch)."""
    import numpy as np
    import torch
    from consistentid_torch.apps import bisenet_tools
    from consistentid_torch.io.export_backbones import bisenet_to_torch
    from consistentid_torch.io.from_jax import tree_from_module
    from consistentid_torch.io.safetensors_reader import write_safetensors
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.parallel import launch
    from consistentid_torch.testing import tf32_off
    from consistentid_torch.training.bisenet_train import (
        FaceMaskDataset, create_bisenet_train_state, make_bisenet_train_step)
    from consistentid_torch.utils.png import read_array

    counters = launch_counters() + bn_counters()
    fa.reset_launches(*counters)
    root = Path(outdir, "bisenet")
    faces, mask_root = _write_bisenet_data(root)
    bisenet_tools.main(["preprocess", "--mask-root", str(mask_root),
                        "--out", str(root / "labels"), "--num-images", "16"])
    t0 = time.perf_counter()
    images, labels = next(FaceMaskDataset(str(faces), str(root / "labels"),
                                          crop=448, seed=0).batches(16))
    data_s = time.perf_counter() - t0
    if images.shape != (16, 448, 448, 3) or labels.max() > 255:
        raise AssertionError(f"BiSeNet data {images.shape} {labels.max()}")
    state = create_bisenet_train_state(seed=0, device="cuda")
    step = make_bisenet_train_step()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, images, labels)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"BiSeNet losses {losses}")
    path = root / "start.pt"
    torch.save({"model": {k: v.cpu() for k, v in
                          state.model.state_dict().items()},
                "momentum": {k: v.cpu() for k, v in
                             state.optimizer.trace.items()},
                "count": dict(state.optimizer.count), "step": state.step,
                "images": images, "labels": labels}, path)
    ref = _bisenet_start(path)
    with tf32_off():
        ref, m = make_bisenet_train_step(ohem_shards=2)(ref, images, labels)
    ref_loss = float(m["loss"])
    t1 = time.perf_counter()
    ranks = launch(bisenet_rank, 2, str(path), device_type="cuda")
    ranks_s = time.perf_counter() - t1
    want = {k: v.cpu() for k, v in ref.model.state_dict().items()}
    off = []
    for r in ranks:
        if abs(r["loss"] - ref_loss) > 1e-5 * abs(ref_loss):
            off.append(("loss", r["loss"], ref_loss))
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            stats = k.endswith(("running_mean", "running_var"))
            if not torch.allclose(r["state"][k], v,
                                  rtol=2e-4, atol=1e-5 if stats else 2e-6):
                off.append((k, (r["state"][k] - v).abs().max().item()))
    if off:
        raise AssertionError(f"BiSeNet 2 x 8 vs 1 x 16: {off[:6]}")
    ckpt = root / "face_parsing.safetensors"
    write_safetensors(str(ckpt), bisenet_to_torch(*tree_from_module(
        state.model)))
    bisenet_tools.main(["evaluate", "--images", str(faces), "--out",
                        str(root / "parsed"), "--bisenet", str(ckpt),
                        "--batch", "8"])
    bisenet_tools.main(["makeup", "--image", str(faces / "0.jpg"), "--out",
                        str(root / "makeup.png"), "--bisenet", str(ckpt)])
    parsed = sorted((root / "parsed").iterdir())
    made = read_array(str(root / "makeup.png"))
    launches = [c.launches for c in counters]
    if len(parsed) != 16 or made.shape != (512, 512, 3) or any(launches):
        raise AssertionError(f"BiSeNet tools: {len(parsed)} overlays, "
                             f"makeup {made.shape}; launches {launches}")
    out = dict(data_s=data_s, s_per_step=times, losses=losses,
               peak_gib=peak, sync_loss=ranks[0]["loss"], ref_loss=ref_loss,
               backend=ranks[0]["backend"], ranks_s=ranks_s,
               launches=launches)
    log(f"phase 32 (BiSeNet training, batch 16, crop 448): data "
        f"{data_s:.2f} s, s/step {[round(t, 4) for t in times]}, peak "
        f"{peak:.2f} GiB, losses {[round(x, 4) for x in losses]}; 2 ranks x"
        f" 8 ({ranks[0]['backend']}) against 1 x 16: loss {ranks[0]['loss']}"
        f" vs {ref_loss}; tools evaluate and makeup done; K1-K6 launches "
        f"{launches}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    if not (REPO / "consistentid_torch" / "csrc").is_dir():
        print(f"chip_smoke: the consistentid_torch package is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()

    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from consistentid_torch.ops import build
    t0 = time.perf_counter()

    def build_all():
        with ThreadPoolExecutor(len(build.LIBRARIES) + 1) as pool:
            variant = pool.submit(build_fp32_dq_variant)   # nvcc each
            list(pool.map(build.load_library, build.LIBRARIES))
            return variant.result()
    fp32_dq = phase("build", build_all)
    sources = [s for srcs in build.LIBRARIES.values() for s in srcs]
    log(f"build: {', '.join(sources)} -> {build.BUILD_DIR.name}/ in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel: "
        f"{build.build_seconds or 'cached'})")
    resources = phase("kernel_resources", kernel_resources)

    k1_rows = phase("K1 kernel checks", kernel_phase)
    train_rows = phase("K2, K3 + K4 kernel checks", train_kernel_phase)
    dq_order = phase("dq order", dq_order_phase, fp32_dq)
    bn_rows, bn_launches, bn_per_call = phase("K5, K6 kernel checks",
                                              bn_kernel_phase)
    bundle, main = phase("main path", main_path)
    path = phase("UNet path check", unet_path_check, bundle)
    profile = phase("UNet profile", profile_unet, bundle)
    init_paths = phase("init-image paths", init_image_phase, bundle)
    deepcache = phase("DeepCache", deepcache_phase, bundle, rounds=1)
    int8 = phase("int8 headline", int8_headline_phase, bundle, smi,
                 rounds=1)
    int8["micro_table"] = phase("int8 micro table", int8_micro_table, smi)
    hooks, perception = phase("perception", perception_phase)
    photo = phase("generate from the photo", photo_generate, bundle, *hooks)
    tmp = tempfile.mkdtemp(prefix="cid_checkpoints_")
    try:
        paths, written = phase("write the SD1.5 set", write_checkpoint_set,
                               bundle, hooks, tmp)
        loaded = {**written, **phase("load the SD1.5 set", load_phase,
                                     bundle, hooks, paths)}
        del hooks
        infer_pipe, inferred = phase("infer CLI", infer_phase, paths, tmp)
        infer_variants = phase("infer variants", infer_variants_phase,
                               paths, tmp)
        int8["infer"] = phase("infer int8", infer_int8_phase, paths, tmp)
        samplers = phase("samplers", samplers_phase, infer_pipe)
        served = phase("serve", serve_phase, infer_pipe)
        del infer_pipe
        gc.collect()  # the server's handler objects hold it in cycles
        torch.cuda.empty_cache()
        demos = phase("demos", demos_phase, paths, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        int8["serve"] = phase("serve int8", serve_int8_phase, paths, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        validated = phase("validate, eval_sweep", validate_phase, paths, tmp)
        set_dir = Path(tmp, "llava-1.5-7b-hf")
        fgid = phase("LLaVA, apps.fgid", fgid_phase, paths, tmp, smi,
                     set_dir)
        parallel = phase("parallel", parallel_phase, paths, tmp, set_dir)
        shutil.rmtree(set_dir, ignore_errors=True)
        bisenet = phase("BiSeNet training", bisenet_phase, tmp)
        cli = phase("train CLIs", train_cli_phase, paths, tmp)
        sdxl_bundle, sdxl = phase("SDXL", sdxl_path)
        int8["sdxl_int8_static"] = sdxl.pop("int8_static")
        sdxl_infer = phase("SDXL set, infer CLI", sdxl_infer_phase,
                           sdxl_bundle, paths, tmp)
        sdxl_train = phase("SDXL training", sdxl_training_path, sdxl_bundle)
        del sdxl_bundle
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state, train = phase("training path", training_path, bundle)
    train_profile = phase("train step profile", profile_train_step, bundle,
                          state)
    train_path = phase("training UNet path check", train_unet_path_check,
                       bundle, state)
    remat = phase("remat", sd15_remat_phase, bundle, state)
    del bundle, state
    torch.cuda.empty_cache()
    tiny = phase("tiny card vs CPU", tiny_reference_check)
    tiny_train = phase("tiny train card vs CPU", tiny_train_check)

    def entry(name, source, replaces, launches, rows, library):
        top = rows[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "library": library,
                "shapes": rows}

    def train_launches(kernel):
        """K2's ("k2") or K3 + K4's ("bwd") launches per step on the other
        training paths: SDXL (none and full remat), SD1.5 under remat, the
        CLI runs."""
        per = {f"sdxl_{mode}": (None if r is None else
                                r[f"{kernel}_per_step"])
               for mode, r in sdxl_train["runs"].items()}
        per.update({f"sd15_{mode}": (r["k2_launches"] if kernel == "k2"
                                     else 10) for mode, r in remat.items()})
        by_route = {mode: r["launches_by_route"][kernel]
                    for mode, r in sdxl_train["runs"].items()
                    if r is not None}
        return {"launches_per_train_step": per,
                "sdxl_train_launches_by_route": by_route,
                "cli_launches": {k: 10 * cli[k]["steps"]
                                 for k in ("encoded", "resumed", "pixel")},
                "train_launches_note":
                    "launches: over the 5 timed SD1.5 steps (batch 2, "
                    "512 px); launches_per_train_step: per step of SDXL "
                    "training (1024 px, batch 1) without remat and with "
                    "remat full, and of SD1.5 with remat none, full, dots; "
                    "cli_launches: over each apps.train run"}

    fwd_src = "consistentid_torch/csrc/flash_attention_sm90.cu"
    bwd_src = "consistentid_torch/csrc/flash_attention_bwd_sm90.cu"
    jax_src = "consistentid_tpu/ops/flash_attention.py"
    k2, k34 = train["launches"][1:3]
    sm90 = resources["flash_attention_sm90"]
    sm90_info = dict(
        dispatch="sm90 (wgmma + TMA); mma.sync (flash_attention.cu) for "
                 "other 16-bit shapes, SIMT for fp32",
        mma_ms=k1_rows[0]["mma_ms"],
        kernel_resources=[k for k in sm90["kernels"]
                          if "flash_fwd_sm90_kernel" in k["kernel"]],
        wgmma_remarks=sm90["wgmma_remarks"])
    kernels = [
        {**entry("flash_attention_fwd (K1)", fwd_src, f"{jax_src}:63",
                 main["launches"], k1_rows, "sdpa forward"), **sm90_info,
         "launches_by_route": main["launches_by_route"],
         "photo_launches_by_route": photo["launches_by_route"],
         "launches_per_infer_call": inferred["launches"],
         "infer_launches_by_route": inferred["launches_by_route"],
         "launches_per_served_batch": served["k1_launches_per_batch"],
         "launches_per_sdxl_request": sdxl["launches"],
         "sdxl_launches_by_route": sdxl["launches_by_route"],
         "launches_per_sdxl_infer_call": sdxl_infer["launches"],
         "sdxl_infer_launches_by_route": sdxl_infer["launches_by_route"],
         "launches_per_img2img": init_paths["img2img"]["launches"],
         "launches_per_inpaint": init_paths["inpaint"]["launches"],
         "launches_per_inpaint9": init_paths["inpaint9"]["launches"],
         "launches_per_controlnet_inpaint": {
             mode: r["launches"] for mode, r in
             init_paths["controlnet_inpaint"]["runs"].items()},
         "launches_per_deepcache": {
             **{f"interval_{ci}": n for ci, n in
                deepcache["launches"].items()},
             "sdxl_interval_3": sdxl["deepcache"]["launches"]},
         "launches_per_infer_inpaint": infer_variants["inpaint"]["launches"],
         "launches_per_infer_deepcache":
             infer_variants["deepcache"]["launches"],
         "launches_in_validate_run": validated["launches"][0],
         "launches_parallel_per_rank": {
             "tp2_unet_call": parallel["ranks"][1]["unet_call"][
                 "k1_launches"],
             "tp2_generate": parallel["ranks"][1]["tp_generate"][
                 "launches"][0],
             "dp2_generate_batch": parallel["ranks"][1][
                 "dp_generate_batch"]["launches"][0],
             "backend": parallel["ranks"][1]["backend"],
             "note": f"per rank of 2 on one card: one UNet call (batch 8), "
                     f"a generate of 2 images and a generate_batch of 4 "
                     f"requests (2 a rank), {PAR_STEPS} DDIM steps, 512 px"},
         "launches_per_tp_served_batch": parallel["serve"]["k1_launches"],
         "launches_in_eval_sweep_run": validated["eval_sweep_launches"],
         "launches_per_demo_request": demos["demo"]["launches"],
         "demo_launches_by_route": demos["demo"]["launches_by_route"],
         "launches_per_example_twin": {
             name: r["launches"][0] for name, r in demos["twins"].items()},
         "example_twin_launches_by_route": {
             name: r["launches_by_route"]
             for name, r in demos["twins"].items()},
         "launches_note": "launches: per generate (batch 4, 50 DDIM steps,"
                          " 512 px); also per infer call (768x512, 50 "
                          "Euler steps), per served batch (512 px, 50 "
                          "DDIM steps), per SDXL generate (1 image, "
                          "1024x1024, 50 DDIM steps: 10 calls at X1 = "
                          "sdxl_level1 and 60 at X2 = sdxl_level2 per UNet "
                          "call) and per SDXL infer call (50 Euler steps); "
                          "per img2img request (strength 0.8: 40 of 50 DDIM "
                          "steps), inpaint (4- and 9-channel) and ControlNet "
                          "inpaint request (strength 1, 50 steps; 4 "
                          "ControlNet calls a step), DeepCache request (batch"
                          " 4 at intervals 1, 2, 3; SDXL 1 image at 3) and "
                          "infer call with --init-image --mask-image and "
                          "with --cache-interval 3 (768x512, 50 Euler "
                          "steps); in all over one apps.validate run "
                          "(SD1.5 and inpaint images, a 4-row sweep, the "
                          "int8 calibration, each serving mode's warm-up and"
                          " batch-4 request) and one apps.eval_sweep run "
                          "(two batches of 4; 512 px, 50 DDIM steps); C0, "
                          "C1: the init-image paths' shapes; per demo "
                          "request (apps.demo, 512 px, 50 DDIM steps) and "
                          "per run of each examples/*_demo_torch.py twin "
                          "(minimal and ControlNet tiny fp32 at 64 px, 4 "
                          "steps, on the f32 route; inpaint --full-size at "
                          "512 px, 50 DDIM steps)"},
        {**entry("flash_attention_fwd_lse (K2)", fwd_src, f"{jax_src}:234",
                 k2, train_rows["K2"], "sdpa forward, inputs requiring grad"),
         **sm90_info, "mma_ms": train_rows["K2"][0]["mma_ms"],
         "launches_by_route": train["k2_launches_by_route"],
         "launches_dp2_train_per_rank_step": [
             l[1] for l in parallel["ranks"][1]["dp_train"][
                 "launches_per_step"]],
         **train_launches("k2")},
        {**entry("flash_attention_bwd (K3 + K4, fused)", bwd_src,
                 f"{jax_src}:273", k34, train_rows["K3+K4"],
                 "sdpa backward alone (dq, dk, dv)"),
         "also_replaces": f"{jax_src}:308",
         "dispatch": "sm90 (one fused wgmma + TMA kernel, dQ added as "
                     "fixed-point integers, with a maxima kernel, a "
                     "statistics set-up and a dq pass); K3's and K4's "
                     "mma.sync kernels (flash_attention_bwd.cu) for other "
                     "16-bit shapes, their SIMT kernels for fp32",
         "mma_ms": train_rows["K3+K4"][0]["mma_ms"],
         "dq_run_to_run_rel_l2": train_rows["K3+K4"][0][
             "dq_run_to_run_rel_l2"],
         "dq_order": dq_order,
         "launches_by_route": train["bwd_launches_by_route"],
         "launches_dp2_train_per_rank_step": [
             l[2] for l in parallel["ranks"][1]["dp_train"][
                 "launches_per_step"]],
         **train_launches("bwd"),
         "kernel_resources": [
             k for k in resources["flash_attention_bwd_sm90"]["kernels"]
             if "flash_bwd_sm90_kernel" in k["kernel"]],
         "wgmma_remarks":
             resources["flash_attention_bwd_sm90"]["wgmma_remarks"]},
    ]
    bn_src = "consistentid_torch/csrc/fused_bn_act.cu"
    bn_jax = "consistentid_tpu/ops/fused_bn_act.py"
    note = ("launches: per call of fused_bn_act in the kernel phase; "
            "main_path_launches: counted over the serving request, the "
            "request from the photo and the 5 timed train steps (no model "
            "calls K5 or K6, as in the JAX package); "
            "device_kernels_per_call: torch.profiler over one call at P "
            "fp32; fused_bn_act: K5 then K6 under programmatic dependent "
            "launch, beside F.batch_norm (training) then F.leaky_relu; "
            "copy_ms, sum_ms, launch_floor_ms: y.copy_(x), x.sum() and a "
            "one-element add in the same run")
    for i, ((label, line, rows, lib, symbol), n) in enumerate(zip(
            (("batch_moments (K5)", 35, bn_rows["K5"],
              "torch.var_mean over (rows, C), correction 0",
              "bn_moments_kernel"),
             ("apply_bn_act (K6)", 58, bn_rows["K6"],
              "F.batch_norm (inference) on the channels-last view, then "
              "F.leaky_relu: two calls", "bn_apply_kernel")),
            bn_launches)):
        on_paths = {"generate": main["bn_launches"][i],
                    "generate_from_photo": photo["launches"][3 + i],
                    "train_steps": train["launches"][3 + i]}
        kernels.append({**entry(label, bn_src, f"{bn_jax}:{line}", n, rows,
                                lib),
                        "main_path_launches": on_paths,
                        "launches_in_bisenet_training":
                            bisenet["launches"][3 + i],
                        "device_kernels_per_call": bn_per_call,
                        "fused_bn_act": bn_rows["fused"],
                        "kernel_resources": [
                            k for k in resources["fused_bn_act"]["kernels"]
                            if symbol in k["kernel"]],
                        "note": note})
    for entry, n in zip(kernels, fgid["launches"]):
        entry["launches_in_fgid_phase"] = n     # phase 30: none
    log(json.dumps({"main_path": main, "unet_path_check": path,
                    "init_image_paths": init_paths, "deepcache": deepcache,
                    "int8": int8,
                    "infer_variants": infer_variants,
                    "perception": perception, "photo_generate": photo,
                    "dq_order": dq_order, "load": loaded, "infer": inferred,
                    "samplers": samplers, "serve": served,
                    "demos": demos, "sdxl": sdxl,
                    "validate": validated, "fgid": fgid,
                    "parallel": parallel, "bisenet_training": bisenet,
                    "sdxl_infer": sdxl_infer,
                    "tiny_card_vs_cpu": tiny, "unet_profile": profile,
                    "training_path": train, "train_profile": train_profile,
                    "training_unet_path_check": train_path,
                    "tiny_train_card_vs_cpu": tiny_train,
                    "train_cli": cli, "sdxl_training": sdxl_train,
                    "sd15_remat": remat,
                    "kernel_resources": resources,
                    "phase_s": PHASE_S,
                    "total_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
