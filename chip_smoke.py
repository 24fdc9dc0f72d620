#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the main path from csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at ragged fp32 shapes, and time kernel, plain
     version and the library call beside the kernel's bound;
  4. the main path: a full-width SD1.5 ConsistentID bundle (bf16, LoRA rank
     128, 4 IP tokens, ViT-H, CLIP-L, full VAE; random weights from a seed)
     runs generate() at batch 4, 50 DDIM steps, 512 px; checks the output
     and that the flash kernel was launched 500 times;
  5. path checks: one full-width UNet call through the kernel and through
     the plain version, and a tiny fp32 bundle on the card against the same
     bundle on the CPU;
  6. one full-width UNet call under torch.profiler: its device time by
     kernel.
The last three lines are the kernels' JSON ({"kernels": [...]}), the
nvidia-smi reading and {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks at its 700 W limit (NVIDIA data sheet): HBM bytes/s, dense
# bf16/fp16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, and
# special-function (exp2) results/s: 132 SMs x 16/clk x 1.83 GHz.
HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
SFU_PER_S = 3.9e12

PROMPT = ("portrait photo of a man with a strong face, blue eyes, a sharp "
          "nose and a wide mouth")


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, sq, sk, d, itemsize, tensor_cores):
    """Least time (ms) for the attention forward, and what bounds it: the
    bytes of q, k, v and o once each; 4*b*h*sq*sk*d FLOPs; one exp per
    score."""
    bytes_ms = itemsize * b * h * d * 2 * (sq + sk) / HBM_BYTES_PER_S * 1e3
    flops = 4.0 * b * h * sq * sk * d
    flops_ms = flops / (TENSOR_FLOPS if tensor_cores else FP32_FLOPS) * 1e3
    exp_ms = b * h * sq * sk / SFU_PER_S * 1e3
    bound = max(bytes_ms, flops_ms, exp_ms)
    by = "bytes" if bound == bytes_ms else "operations"
    limiter = {bytes_ms: "bytes", flops_ms: "flops", exp_ms: "exp"}[bound]
    return bound, by, limiter


def kernel_phase():
    import torch
    import torch.nn.functional as F
    from consistentid_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)

    gen = torch.Generator("cuda").manual_seed(0)
    # tolerance on max |kernel - plain|: bf16 outputs of magnitude < 1 are
    # one bf16 ulp (2**-8) apart at most in theory; 1e-2 leaves room for P
    # rounded to bf16 before P V. fp32: summation order only, 1e-5.
    cases = [
        ("level0", (8, 8, 4096, 40), 4096, torch.bfloat16, 1e-2, 20),
        ("level1", (8, 8, 1024, 80), 1024, torch.bfloat16, 1e-2, 50),
        ("ragged_fp32_d40", (2, 3, 1000, 40), 1037, torch.float32, 1e-5, 20),
        ("ragged_fp32_d64", (2, 4, 500, 64), 700, torch.float32, 1e-5, 20),
    ]
    rows = []
    for name, (b, h, sq, d), sk, dtype, tol, iters in cases:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"K1 {name}: max |kernel - plain| {err} "
                                 f"> {tol}")
        ms = cuda_ms(lambda: flash_attention(q, k, v), iters)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                         iters)
        bound, by, limiter = attention_bound(
            b, h, sq, sk, d, q.element_size(), dtype != torch.float32)
        row = dict(case=name, shape=[b, h, sq, d], sk=sk,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   tolerance=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound, bound_by=by, bound_limiter=limiter)
        rows.append(row)
        log(f"K1 {name} {b}x{h}x{sq}x{d} sk={sk} {row['dtype']}: "
            f"max_abs_err {err:.3g} (tol {tol:g}), kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({limiter})")
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
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPT, face, seed=1, num_inference_steps=50,
                           return_float=True, **kw)
    out = postprocess_to_uint8(images)
    seconds = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if out.shape != (4, 512, 512, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    if not torch.isfinite(images.float()).all():
        raise AssertionError("non-finite decoded images")
    if launches != 500:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             "expected 500 (10 per UNet call x 50 steps)")
    stages = {k: round(v, 1) for k, v in pipe.last_stage_ms.items()}
    log(f"main path: generate batch 4, 50 DDIM steps, 512 px: "
        f"{seconds:.3f} s, {4 / seconds * 60:.2f} images/min, "
        f"stages ms {stages}, peak memory {peak_gib:.2f} GiB, "
        f"K1 launches {launches}, image std {float(images.float().std()):.4f}")
    return bundle, dict(seconds=seconds, images_per_min=4 / seconds * 60,
                        stage_ms=stages, peak_gib=peak_gib, launches=launches)


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
        before = fa.flash_attention.launches
        with_kernel = unet(x, t, ctx).float()
        torch.cuda.synchronize()
        per_call = fa.flash_attention.launches - before
        kernel = fa.flash_attention
        fa.flash_attention = fa.flash_attention_plain
        try:
            with_plain = unet(x, t, ctx).float()
        finally:
            fa.flash_attention = kernel
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


def profile_unet(bundle, top: int = 12):
    """Device time of one full-width UNet call (batch 8, as CFG at 4 images
    runs it) by kernel, from torch.profiler: the total, the share of the
    call's wall time the card was busy, and the `top` kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn((8, 64, 64, 4), generator=gen, device="cuda")
    t = torch.full((8,), 501.0, device="cuda")
    ctx = torch.randn((8, 81, 768), generator=gen, device="cuda")
    unet = bundle.infer_unet(1.0)
    with torch.no_grad():
        unet(x, t, ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            unet(x, t, ctx)
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
    log(f"UNet call profile (bf16, batch 8, 64x64 latents): wall "
        f"{wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
        f"({device_ms / wall_ms:.1%})")
    for r in rows:
        log(f"  {r['ms']:9.3f} ms {r['share']:6.1%} x{r['calls']:<4d} "
            f"{r['kernel']}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, top=rows)


def tiny_reference_check():
    """The tiny fp32 bundle's encode + 3-step denoise + decode on the card
    (K1's fp32 path at the level-0 cutover) against the same bundle on the
    CPU (plain attention), with TF32 off on the card."""
    import numpy as np
    import torch
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import synthetic_clip_tokenizer, tiny_bundle

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
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
            before = fa.flash_attention.launches
            img = pipe._generate_core(cond, latents.to(device), 5.0, 1, 3,
                                      "ddim", 1.0, 1.0)
            outs.append((img.float().cpu(),
                         fa.flash_attention.launches - before))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
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
    build.load_library("flash_attention", ["flash_attention.cu"])
    built = build.build_seconds.get("flash_attention")
    log(f"build: flash_attention.cu -> {build.BUILD_DIR.name}/ in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({'nvcc ' + format(built, '.2f') + ' s' if built else 'cached'})")

    k1_rows = kernel_phase()
    bundle, main = main_path()
    path = unet_path_check(bundle)
    profile = profile_unet(bundle)
    del bundle
    torch.cuda.empty_cache()
    tiny = tiny_reference_check()

    top = k1_rows[0]
    kernels = [{
        "name": "flash_attention_fwd (K1)",
        "route": "cuda",
        "source": "consistentid_torch/csrc/flash_attention.cu",
        "replaces": "consistentid_tpu/ops/flash_attention.py:63",
        "launches": main["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shapes": k1_rows,
    }]
    log(json.dumps({"main_path": main, "unet_path_check": path,
                    "tiny_card_vs_cpu": tiny, "unet_profile": profile,
                    "total_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
