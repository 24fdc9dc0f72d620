#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ (nvcc, sm_90a), one nvcc per source, all
     started together;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at ragged shapes, by the relative L2 error of
     each output (each limit with a control: the plain version with one key
     or query tile dropped must read above it), and time kernel, plain
     version and the library call beside the kernel's bound: K1 at the
     serving shapes, K2, K3 and K4 at the training shapes;
  4. serving: a full-width SD1.5 ConsistentID bundle (bf16, LoRA rank 128,
     4 IP tokens, ViT-H, CLIP-L, full VAE; random weights from a seed) runs
     generate() at batch 4, 50 DDIM steps, 512 px; checks the output and
     that K1 was launched 500 times;
  5. serving path checks: one full-width UNet call through K1 and through
     its plain version; one UNet call under torch.profiler;
  6. training: the same bundle with fp32 trainable masters takes 1 warm-up
     and 5 timed AdamW steps of the adapter objective (batch 2, 512 px,
     synthetic batch); checks finite losses, a nonzero first gradient on
     every trainable leaf, moved trainable and bit-identical frozen
     parameters, and 10 launches each of K2, K3 and K4 (and none of K1) per
     step; one step under torch.profiler;
  7. training path checks: one full-width UNet forward and backward through
     K2-K4, each of its 10 calls held against the plain versions on its own
     inputs (K3 and K4 at their own precision) and so are the LoRA leaves
     each call feeds, and the trainable gradients against a second pass
     through the plain versions; the tiny fp32 bundle's loss and gradients
     on the card against the CPU;
  8. the tiny fp32 bundle's generate core on the card against the CPU.
The last three lines are the kernels' JSON ({"kernels": [...]}), the
nvidia-smi reading and {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
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
# K3 and K4 feed (relative L2 of each leaf's gradient through the kernels'
# dq, dk, dv against that through the same-precision plain backward's):
# just above the 1.9e-3 read on an H100, below the controls' 0.06 (PERF.md)
UNET_LEAF_REL_L2 = 5e-3

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


def attention_bound(b, h, sq, sk, d, itemsize, tensor_cores, kind="fwd"):
    """Least time (ms) for one flash-attention kernel, what bounds it
    ("bytes" or "operations") and the limiter (bytes, flops or exp).
    Bytes: each input read once, each output written once. FLOPs: 4, 6 or 8
    x b*h*sq*sk*d (fwd: S and PV; dq: S, dP, dQ; dkv: S, dV, dP, dK). One exp
    per score in each kernel."""
    bh = b * h
    qo = bh * sq * d * itemsize         # one (sq, d) tensor
    kv = bh * sk * d * itemsize         # one (sk, d) tensor
    stat = bh * sq * 4                  # one fp32 (sq,) vector
    nbytes, mult = {
        "k1": (2 * qo + 2 * kv, 4),                     # q, k, v -> o
        "fwd": (2 * qo + 2 * kv + stat, 4),             # -> o, lse
        "dq": (3 * qo + 2 * kv + 2 * stat, 6),          # q, dO, k, v, lse,
        "dkv": (2 * qo + 4 * kv + 2 * stat, 8),         # delta -> dq | dk, dv
    }[kind]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops = float(mult) * bh * sq * sk * d
    flops_ms = flops / (TENSOR_FLOPS if tensor_cores else FP32_FLOPS) * 1e3
    exp_ms = bh * sq * sk / SFU_PER_S * 1e3
    bound = max(bytes_ms, flops_ms, exp_ms)
    by = "bytes" if bound == bytes_ms else "operations"
    limiter = {bytes_ms: "bytes", flops_ms: "flops", exp_ms: "exp"}[bound]
    return bound, by, limiter


def kernel_phase():
    import torch
    import torch.nn.functional as F
    from consistentid_torch.ops.flash_attention import (flash_attention_fwd,
                                                        flash_attention_plain)
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            KERNEL_REL_L2_FP32,
                                            drop_last_tile, rel_l2)

    gen = torch.Generator("cuda").manual_seed(0)
    # limits on the relative L2 error: consistentid_torch/testing.py
    cases = [
        ("level0", (8, 8, 4096, 40), 4096, torch.bfloat16, 20),
        ("level1", (8, 8, 1024, 80), 1024, torch.bfloat16, 50),
        ("ragged_fp32_d40", (2, 3, 1000, 40), 1037, torch.float32, 20),
        ("ragged_fp32_d64", (2, 4, 500, 64), 700, torch.float32, 20),
    ]
    rows = []
    for name, (b, h, sq, d), sk, dtype, iters in cases:
        tol = (KERNEL_REL_L2_FP32 if dtype == torch.float32
               else KERNEL_REL_L2_16BIT)
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
        out = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v)
        cut = drop_last_tile(sk)
        control = rel_l2(flash_attention_plain(q, k[:, :, :cut],
                                               v[:, :, :cut]), ref)
        err = (out.float() - ref.float()).abs().max().item()
        rel = rel_l2(out, ref)
        check(f"K1 {name} o", rel, control, tol)
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                         iters)
        bound, by, limiter = attention_bound(
            b, h, sq, sk, d, q.element_size(), dtype != torch.float32, "k1")
        row = dict(case=name, shape=[b, h, sq, d], sk=sk,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   rel_l2=rel, control_rel_l2=control, tolerance=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=by, bound_limiter=limiter)
        rows.append(row)
        log(f"K1 {name} {b}x{h}x{sq}x{d} sk={sk} {row['dtype']}: "
            f"rel_l2 {rel:.3g} (limit {tol:g}; control {control:.3g}), "
            f"max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({limiter})")
    return rows


def launch_counters():
    """The kernels' wrappers, whose .launches count their launches: K1-K4."""
    from consistentid_torch.ops import flash_attention as fa
    return [fa.flash_attention_fwd, fa.flash_attention_lse,
            fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv]


@contextmanager
def plain_flash():
    """Swap the plain versions in for K2, K3 and K4 inside the autograd
    Function (on the card), so a run through it launches none of them."""
    from consistentid_torch.ops import flash_attention as fa
    saved = (fa.flash_attention_lse, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv)

    def dq(q, k, v, do, lse, delta, scale=None):
        return fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                            scale)[0].to(q.dtype)

    def dkv(q, k, v, do, lse, delta, scale=None):
        _, dk, dv = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                 scale)
        return dk.to(k.dtype), dv.to(v.dtype)

    fa.flash_attention_lse = fa.flash_attention_lse_plain
    fa.flash_attention_bwd_dq = dq
    fa.flash_attention_bwd_dkv = dkv
    try:
        yield
    finally:
        (fa.flash_attention_lse, fa.flash_attention_bwd_dq,
         fa.flash_attention_bwd_dkv) = saved


def train_kernel_phase():
    """K2, K3 and K4 against their plain versions at the training shapes
    (batch 2: level 0 (2, 8, 4096, 40), level 1 (2, 8, 1024, 80), bf16), at
    a ragged bf16 shape and at two ragged fp32 shapes; times of kernel,
    plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                            KERNEL_REL_L2_FP32,
                                            KERNEL_REL_L2_SAME_PRECISION,
                                            drop_last_tile, rel_l2)

    gen = torch.Generator("cuda").manual_seed(1)
    # limits on the relative L2 error: consistentid_torch/testing.py; lse:
    # fp32 statistics on both sides, 1e-4 absolute
    cases = [
        ("level0", (2, 8, 4096, 40), 4096, torch.bfloat16, 20),
        ("level1", (2, 8, 1024, 80), 1024, torch.bfloat16, 50),
        ("ragged_bf16_d40", (2, 3, 1000, 40), 1037, torch.bfloat16, 10),
        ("ragged_fp32_d40", (2, 3, 1000, 40), 1037, torch.float32, 10),
        ("ragged_fp32_d80", (1, 4, 333, 80), 517, torch.float32, 10),
    ]
    rows = {"K2": [], "K3": [], "K4": []}
    for name, (b, h, sq, d), sk, dtype, iters in cases:
        shape = (b, h, sq, d)
        bf16 = dtype != torch.float32
        tol = KERNEL_REL_L2_16BIT if bf16 else KERNEL_REL_L2_FP32
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in (shape, (b, h, sk, d), (b, h, sk, d), shape))
        out, lse = fa.flash_attention_lse(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v)
        delta = (do.float() * ref_out.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, do, ref_lse, delta)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= 1e-4:
            raise AssertionError(f"K2 {name}: lse off by {lse_err}")

        # controls: the last key tile (K2, K3) or query tile (K4) dropped
        kc, qc = drop_last_tile(sk), drop_last_tile(sq)
        ctl_out = fa.flash_attention_lse_plain(q, k[:, :, :kc],
                                               v[:, :, :kc])[0]
        ctl_dq = fa.flash_attention_bwd_plain(q, k[:, :, :kc], v[:, :, :kc],
                                              do, ref_lse, delta)[0]
        _, ctl_dk, ctl_dv = fa.flash_attention_bwd_plain(
            q[:, :, :qc], k, v, do[:, :, :qc], ref_lse[:, :, :qc],
            delta[:, :, :qc])
        outputs = {"K2": [("o", out, ref_out, ctl_out)],
                   "K3": [("dq", dq, ref[0], ctl_dq)],
                   "K4": [("dk", dk, ref[1], ctl_dk), ("dv", dv, ref[2],
                                                       ctl_dv)]}
        # K3 and K4 at their own precision too: P and dS rounded to bf16
        same = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
            q, k, v, do, ref_lse, delta, round_to=dtype))) if bf16 else {}
        readings = {}
        for kname, outs in outputs.items():
            rels, ctls, errs, sames = [], [], [], []
            for oname, got, want, ctl in outs:
                rel, control = rel_l2(got, want), rel_l2(ctl, want)
                check(f"{kname} {name} {oname}", rel, control, tol)
                rels.append(rel)
                ctls.append(control)
                errs.append((got.float() - want.float()).abs().max().item())
                if oname in same:
                    s_ref = same[oname].to(dtype)
                    s_rel = rel_l2(got, s_ref)
                    check(f"{kname} {name} {oname} at the kernel's precision",
                          s_rel, rel_l2(ctl, s_ref),
                          KERNEL_REL_L2_SAME_PRECISION)
                    sames.append(s_rel)
            readings[kname] = dict(rel_l2=max(rels), control_rel_l2=min(ctls),
                                   max_abs_err=max(errs),
                                   same_precision_rel_l2=max(sames, default=None))

        tc = dtype != torch.float32
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        times = {
            "K2": (cuda_ms(lambda: fa.flash_attention_lse(q, k, v), iters),
                   cuda_ms(lambda: fa.flash_attention_lse_plain(q, k, v), 3),
                   cuda_ms(lambda: F.scaled_dot_product_attention(*leaves),
                           iters)),
            "K3": (cuda_ms(lambda: fa.flash_attention_bwd_dq(
                       q, k, v, do, ref_lse, delta), iters),
                   cuda_ms(lambda: fa.flash_attention_bwd_plain(
                       q, k, v, do, ref_lse, delta), 3), None),
            "K4": (cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                       q, k, v, do, ref_lse, delta), iters),
                   cuda_ms(lambda: fa.flash_attention_bwd_plain(
                       q, k, v, do, ref_lse, delta), 3), None),
        }
        # SDPA's backward alone (its dq, dk, dv together): K3 + K4's yardstick
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, do, retain_graph=True), iters)
        for kname, kind in (("K2", "fwd"), ("K3", "dq"), ("K4", "dkv")):
            ms, plain_ms, lib_ms = times[kname]
            if lib_ms is None:
                lib_ms = sdpa_bwd
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
            log(f"{kname} {name} {b}x{h}x{sq}x{d} sk={sk} {row['dtype']}: "
                f"rel_l2 {r['rel_l2']:.3g} (limit {tol:g}; control "
                f"{r['control_rel_l2']:.3g}{same_txt}), max_abs_err "
                f"{r['max_abs_err']:.3g}, kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound:.4f} ms ({limiter})")
        del leaves, sdpa_out
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
    counters = launch_counters()
    for w in counters:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe.generate(PROMPT, face, seed=1, num_inference_steps=50,
                           return_float=True, **kw)
    out = postprocess_to_uint8(images)
    seconds = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    others = [w.launches for w in counters[1:]]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if out.shape != (4, 512, 512, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    if not torch.isfinite(images.float()).all():
        raise AssertionError("non-finite decoded images")
    if launches != 500 or any(others):
        raise AssertionError(f"K1 launched {launches} times, expected 500 "
                             "(10 per UNet call x 50 steps); K2-K4 "
                             f"{others}, expected none")
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


def training_path(bundle):
    """The training main path: the full-width bundle with fp32 trainable
    masters takes 1 warm-up and 5 timed steps (TrainConfig defaults: batch
    2, 512 px, 5 localization layers, lr 1e-4) on a synthetic batch."""
    import torch
    from consistentid_torch.core import SchedulerConfig, TrainConfig
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

    counters = launch_counters()
    for w in counters:
        w.launches = 0
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
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [float(m["loss"]) for m in step_metrics]
    s_per_step = seconds / n_steps
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches != [0, 10 * n_steps, 10 * n_steps, 10 * n_steps]:
        raise AssertionError(f"launches K1-K4 over {n_steps} steps: "
                             f"{launches}, expected 0 and 10 per step each")
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
        f"{n_train / 1e6:.1f} M trainable fp32 params, launches K1-K4 "
        f"{launches}, losses {[round(x, 5) for x in losses]}")
    return state, dict(s_per_step=s_per_step, examples_per_s=2 / s_per_step,
                       warmup_s=warm_s, peak_gib=peak_gib, losses=losses,
                       launches=launches, trainable_params=n_train,
                       steps=n_steps)


def profile_train_step(bundle, state, top: int = 14):
    """Device time of one training step by kernel (torch.profiler), and the
    share of the step's wall time the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.training import make_train_step, synthetic_batch
    from consistentid_torch.training.train_step import batch_to_tensors

    config = TrainConfig()
    step = make_train_step(bundle, NoiseSchedule.create(SchedulerConfig()),
                           config)
    batch = batch_to_tensors(synthetic_batch(
        2, 512, bundle.vision_config.image_size,
        bundle.adapter_config.id_embeddings_dim, seed=1), bundle.device)
    gen = torch.Generator("cuda").manual_seed(5)
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
    log(f"train step profile (bf16, batch 2, 512 px): wall {wall_ms:.3f} ms "
        f"under the profiler, device busy {device_ms:.3f} ms")
    for r in rows:
        log(f"  {r['ms']:9.3f} ms {r['share']:6.1%} x{r['calls']:<4d} "
            f"{r['kernel']}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, top=rows)


class Recorder:
    """Stands in for a kernel's wrapper and keeps each call's arguments and
    results; the wrapper still launches, and its launch counter (which it
    reaches through its module name) stays the wrapper's own."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.calls = []

    def __call__(self, *args):
        result = self.wrapper(*args)
        self.calls.append((args, result))
        return result

    launches = property(lambda self: self.wrapper.launches,
                        lambda self, n: setattr(self.wrapper, "launches", n))


@contextmanager
def recorded_flash():
    """Record every call the autograd Function makes to K2, K3 and K4, in
    call order: yields {wrapper name: [(arguments, result), ...]}."""
    from consistentid_torch.ops import flash_attention as fa
    names = ("flash_attention_lse", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
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
           calls["flash_attention_bwd_dq"]}
    dkv = {args[4].data_ptr(): res for args, res in
           calls["flash_attention_bwd_dkv"]}
    call_rows, held = [], {}
    for i, ((q, k, v, scale), (o, lse)) in enumerate(
            calls["flash_attention_lse"]):
        owner = [n for c, n in starts if c <= i][-1]
        (_, _, _, do, _, delta, _), dq = bwd[lse.data_ptr()]
        dk, dv = dkv[lse.data_ptr()]
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
    latents) through K2-K4, every kernel call kept; then
      - each call's K2 output against its plain version, and its K3 and K4
        outputs against the plain backward at the kernels' precision (P and
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
    ok = (n_kernel == [0, 10, 10, 10] and n_plain == [0, 0, 0, 0]
          and len(call_rows) == 10 and len(held) == 60
          and math.isfinite(overall) and overall <= 0.02 and not bad)
    worst_call = max(max(r["rel_l2"].values()) for r in call_rows)
    log(f"training UNet path check (bf16, batch 2, 64x64 latents, "
        f"{len(params)} trainable leaves): launches K1-K4 kernel route "
        f"{n_kernel}, plain route {n_plain}; per call (10): K2 o worst "
        f"{max(r['o_rel_l2'] for r in call_rows):.4g} (limit "
        f"{KERNEL_REL_L2_16BIT:g}), K3/K4 vs same precision worst "
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
    (K2-K4 fp32 paths) against the same bundle on the CPU (plain versions),
    with TF32 off on the card and the same draws."""
    import torch
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.testing import tiny_bundle
    from consistentid_torch.training import (Draws, consistentid_loss,
                                             create_train_state, make_draws,
                                             synthetic_batch)
    from consistentid_torch.training.train_step import batch_to_tensors

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
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
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (cpu_loss, cpu_g, cpu_n), (gpu_loss, gpu_g, gpu_n) = outs
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                for a, b in zip(gpu_g, cpu_g))
    # fp32 on both devices, other summation orders through the VAE, ViT,
    # CLIP, adapters and UNet: the CPU parity tests' bounds, loss 1e-5
    # relative, each gradient leaf 1e-4 of its largest element
    ok = (cpu_n == [0, 0, 0, 0] and gpu_n == [0, 3, 3, 3]
          and loss_rel <= 1e-5 and worst <= 1e-4)
    log(f"tiny fp32 train step, card vs CPU (64 px, batch 2): loss "
        f"{gpu_loss:.7g} vs {cpu_loss:.7g} (relative {loss_rel:.3g}, tol "
        f"1e-5), worst gradient leaf {worst:.3g} of its max (tol 1e-4), "
        f"launches K1-K4 card {gpu_n} / cpu {cpu_n}")
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
            before = fa.flash_attention_fwd.launches
            img = pipe._generate_core(cond, latents.to(device), 5.0, 1, 3,
                                      "ddim", 1.0, 1.0)
            outs.append((img.float().cpu(),
                         fa.flash_attention_fwd.launches - before))
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
    with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:  # one nvcc each
        list(pool.map(build.load_library, build.LIBRARIES))
    sources = [s for srcs in build.LIBRARIES.values() for s in srcs]
    log(f"build: {', '.join(sources)} -> {build.BUILD_DIR.name}/ in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel: "
        f"{build.build_seconds or 'cached'})")

    k1_rows = kernel_phase()
    train_rows = train_kernel_phase()
    bundle, main = main_path()
    path = unet_path_check(bundle)
    profile = profile_unet(bundle)
    state, train = training_path(bundle)
    train_profile = profile_train_step(bundle, state)
    train_path = train_unet_path_check(bundle, state)
    del bundle, state
    torch.cuda.empty_cache()
    tiny = tiny_reference_check()
    tiny_train = tiny_train_check()

    def entry(name, source, replaces, launches, rows, library):
        top = rows[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "library": library,
                "shapes": rows}

    fwd_src = "consistentid_torch/csrc/flash_attention.cu"
    bwd_src = "consistentid_torch/csrc/flash_attention_bwd.cu"
    jax_src = "consistentid_tpu/ops/flash_attention.py"
    k2, k3, k4 = train["launches"][1:]
    kernels = [
        entry("flash_attention_fwd (K1)", fwd_src, f"{jax_src}:63",
              main["launches"], k1_rows, "sdpa forward"),
        entry("flash_attention_fwd_lse (K2)", fwd_src, f"{jax_src}:234", k2,
              train_rows["K2"], "sdpa forward, inputs requiring grad"),
        entry("flash_attention_bwd_dq (K3)", bwd_src, f"{jax_src}:273", k3,
              train_rows["K3"], "sdpa backward alone (dq, dk, dv: K3 + K4)"),
        entry("flash_attention_bwd_dkv (K4)", bwd_src, f"{jax_src}:308", k4,
              train_rows["K4"], "sdpa backward alone (dq, dk, dv: K3 + K4)"),
    ]
    log(json.dumps({"main_path": main, "unet_path_check": path,
                    "tiny_card_vs_cpu": tiny, "unet_profile": profile,
                    "training_path": train, "train_profile": train_profile,
                    "training_unet_path_check": train_path,
                    "tiny_train_card_vs_cpu": tiny_train,
                    "total_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
