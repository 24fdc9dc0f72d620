#!/usr/bin/env python3
"""Design alternatives of K5 and K6 (consistentid_torch/csrc/
fused_bn_act.cu), timed in one run on the card (NVIDIA H100):

    python3 scripts/bn_variants.py [--out results.json]

Each build variant is the source with a few lines of its text replaced
(K5's rows a thread keeps in flight, its ticket and barrier, the CTAs an
SM the registers allow; and ablations, for timing only, that cut K5 after
a stage), built by nvcc for sm_90a in parallel
under build/variants/; each is launched with several plans (`bn_plan`
with other CTAs an SM and cluster sizes) at BiSeNet training's stem
(16, 224, 224, 64) fp32 and the parser's P = (1, 256, 256, 64) in fp32 and
bf16. K5's bits are held to `moments_in_kernel_order` for its plan, K6's
output to the plain version; each is timed with chip_smoke.py's `cuda_ms`
on copies of x in turn. Prints one line per (variant, plan, shape), one
JSON object, then the card's name and power limit. Needs the card and
nvcc.
"""
import argparse
import ctypes
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SRC = REPO / "consistentid_torch" / "csrc" / "fused_bn_act.cu"
OUT = REPO / "build" / "variants"

K6_BOUNDS = "__global__ void __launch_bounds__(kThreads)\nbn_apply_kernel("
VARIANTS = {
    "as built": [],
    "K5 8 rows in flight": [("kMomentRows = 4;", "kMomentRows = 8;")],
    "K5 at most 2 CTAs an SM": [("__launch_bounds__(kThreads, 3)",
                                 "__launch_bounds__(kThreads, 2)")],
    "K5 fence + atomicAdd ticket": [(
        "    __syncthreads();\n    if (t == 0) {\n      unsigned int ticket;",
        "    __threadfence();\n    __syncthreads();\n    if (t == 0) {\n"
        "      unsigned int ticket;"), (
        '      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"\n'
        '                   : "=r"(ticket) : "l"(&tickets[blockIdx.y]) : '
        '"memory");',
        "      ticket = atomicAdd(&tickets[blockIdx.y], 1u);")],
    "K5 no PDL trigger": [("let_dependents_launch();", "")],
    "K6 3 CTAs an SM": [(K6_BOUNDS, K6_BOUNDS.replace("(kThreads)",
                                                      "(kThreads, 3)"))],
    "K6 4 CTAs an SM": [(K6_BOUNDS, K6_BOUNDS.replace("(kThreads)",
                                                      "(kThreads, 4)"))],

    "K5 one cluster.sync": [
        ("  cluster_arrive_relaxed();\n  const int t", "  const int t"),
        ("  const unsigned int rank = cluster.block_rank();\n"
         "  cluster_wait();",
         "  const unsigned int rank = cluster.block_rank();\n"
         "  cluster.sync();")],
}
# Ablations of K5, for timing only (their results are wrong): each cuts
# the kernel after one of its stages, or skips one
NO_BARRIER = ("  cluster_arrive_relaxed();\n  const int t", "  const int t")
ABLATIONS = {
    "K5 ablation: loads only": [NO_BARRIER, (
        "  float val[2];\n",
        "  if (s[0] == 1234.5f) mean[0] = q[0];\n  return;\n"
        "  float val[2];\n")],
    "K5 ablation: up to the CTA's tree": [NO_BARRIER, (
        "  // 2. each CTA puts",
        "  if (val[0] == 1234.5f) mean[0] = val[1];\n  return;\n"
        "  // 2. each CTA puts")],
    "K5 ablation: up to the tree, arrived": [(
        "  // 2. each CTA puts",
        "  if (val[0] == 1234.5f) mean[0] = val[1];\n  return;\n"
        "  // 2. each CTA puts")],
    "K5 ablation: up to the push": [(
        "  if (rank != 0) {   // nothing reads",
        "  return;\n  if (rank != 0) {   // nothing reads")],
    "K5 ablation: up to rank 0's wait": [(
        "  cluster_wait();\n  const int64_t cluster_id",
        "  cluster_wait();\n  if (slots[0][0][0][t % 32] == 1234.5f) "
        "mean[0] = 1.f;\n  return;\n  const int64_t cluster_id")],
    "K5 ablation: no ticket": [(
        "  if (n_clusters > 1) {\n    // 3. the ticket",
        "  if (false) {\n    // 3. the ticket")],
}
VARIANTS.update(ABLATIONS)
# (K5 CTAs an SM, K5's largest cluster)
PLANS = [(2, 8), (1, 8), (3, 8), (2, 4), (2, 1)]
# the variants timed at the first plan only
ONE_PLAN = ("K5 fence + atomicAdd ticket", "K5 no PDL trigger",
            "K5 one cluster.sync", "K6 3 CTAs an SM", "K6 4 CTAs an SM")
ABLATION_PLANS = [(2, 8)]
SHAPES = [((16, 224, 224, 64), "float32"), ((1, 256, 256, 64), "float32"),
          ((1, 256, 256, 64), "bfloat16")]


def build(name, edits):
    """Compile one variant; returns (name, library path, ptxas report)."""
    from consistentid_torch.ops import build as port_build
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in the source")
        text = text.replace(old, new)
    slug = re.sub(r"\W+", "_", name)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"fused_bn_act_{slug}.cu"
    lib = OUT / f"lib_{slug}.so"
    src.write_text(text)
    proc = subprocess.run(
        port_build.nvcc_command(port_build.find_nvcc(), [src], lib),
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name!r}:\n{proc.stderr}")
    return name, lib, port_build.ptxas_report(proc.stdout + proc.stderr)


def plan_with(x, ctas_per_sm, cluster):
    """The wrapper's plan for x with K5 at `ctas_per_sm` CTAs an SM in
    clusters of at most `cluster`."""
    from consistentid_torch.ops import fused_bn_act as bn
    saved = (bn.MOMENT_CTAS_PER_SM, bn.MAX_CLUSTER)
    bn.MOMENT_CTAS_PER_SM, bn.MAX_CLUSTER = ctas_per_sm, cluster
    try:
        return bn.plan_for(x)
    finally:
        bn.MOMENT_CTAS_PER_SM, bn.MAX_CLUSTER = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None)
    p.add_argument("--only", nargs="*", default=None,
                   help="names of the variants to run (default all)")
    args = p.parse_args(argv)
    import torch
    import chip_smoke as cs
    from consistentid_torch.ops import build as port_build
    from consistentid_torch.ops import fused_bn_act as bn
    from consistentid_torch.testing import moments_in_kernel_order, rel_l2

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    variants = {k: v for k, v in VARIANTS.items()
                if not args.only or k in args.only}
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda kv: build(*kv), variants.items()))
    libs = {}
    for name, lib, report in built:
        libs[name] = ctypes.CDLL(str(lib))
        for k in report:
            cs.log(f"{name}: {k['function'][-60:]}: {k['registers']} regs, "
                   f"{k['shared_bytes']} B smem, spills "
                   f"{k['spill_stores']}/{k['spill_loads']}")
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    gen = torch.Generator("cuda").manual_seed(7)
    results = []
    for shape, dtype in SHAPES:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda")
             + torch.randn(c, generator=gen, device="cuda")
             ).to(getattr(torch, dtype))
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c, generator=gen, device="cuda")
        st = bn.batch_moments_plain(x)
        y_ref = bn.apply_bn_act_plain(x, *st, scale, bias)
        xs = itertools.cycle(cs.rotation(x, l2))
        rows = math.prod(shape) // c
        k5_bound = cs.bn_bound(rows, c, x.element_size(), "moments")[0]
        k6_bound = cs.bn_bound(rows, c, x.element_size(), "apply")[0]
        iters = 20 if rows > 100000 else 100
        for (name, dll), (per_sm, cluster) in itertools.product(
                libs.items(), PLANS):
            if name in ABLATIONS and (per_sm, cluster) not in ABLATION_PLANS:
                continue
            if name in ONE_PLAN and (per_sm, cluster) != PLANS[0]:
                continue
            plan = plan_with(x, per_sm, cluster)
            # the wrappers launch through the library loaded under this name
            port_build._loaded["fused_bn_act"] = dll
            mean, var = bn._batch_moments(x, plan)
            want = moments_in_kernel_order(x, plan)
            bits = bool(torch.equal(mean, want[0])
                        and torch.equal(var, want[1]))
            y = bn.apply_bn_act(x, *st, scale, bias)
            y_rel = rel_l2(y, y_ref)
            ms5 = cs.cuda_ms(lambda: bn._batch_moments(next(xs), plan), iters)
            ms6 = cs.cuda_ms(lambda: bn.apply_bn_act(next(xs), *st, scale,
                                                     bias), iters)
            row = dict(variant=name, ctas_per_sm=per_sm, max_cluster=cluster,
                       shape=list(shape), dtype=dtype,
                       plan=dataclasses.asdict(plan), k5_bits=bits,
                       k6_rel_l2=y_rel, k5_ms=ms5, k6_ms=ms6,
                       k5_bound_share=k5_bound / ms5,
                       k6_bound_share=k6_bound / ms6)
            results.append(row)
            cs.log(f"{name:28s} {per_sm}/SM cluster<={cluster} {shape} "
                   f"{dtype}: K5 {ms5:.4f} ms ({k5_bound / ms5:.0%}, bits "
                   f"{bits}), K6 {ms6:.4f} ms ({k6_bound / ms6:.0%}, rel_l2 "
                   f"{y_rel:.2g})")
        del x, xs
    out = json.dumps({"variants": results})
    cs.log(out)
    if args.out:
        Path(args.out).write_text(out)
    cs.log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
