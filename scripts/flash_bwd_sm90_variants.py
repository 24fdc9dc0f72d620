#!/usr/bin/env python3
"""Design alternatives of the fused sm90 flash-attention backward (K3 + K4),
checked and timed in one run on the card (NVIDIA H100):

    python3 scripts/flash_bwd_sm90_variants.py

Each variant is consistentid_torch/csrc/flash_attention_bwd_sm90.cu with a
few lines of its text replaced: dQ's partial sums added in fp32, in
arrival order (the kernel before dQ was made deterministic), the next
tile's scores issued under a branch (not on the last tile), the dQ
reduction taken out, the depth of the Q/dO ring, or, as an ablation that
shows where the time goes and computes wrong outputs, one part of the work
taken out (the exps, the dQ product, the dV and dK products, all but the
score products). Each is built by nvcc for sm_90a in parallel under
build/variants/, held against the plain backward at the kernel's own
precision (`flash_attention_bwd_plain(..., round_to=dtype)`, relative L2 of
dq, dk and dv) at the training shapes and at ragged shapes, and timed with
chip_smoke.py's `cuda_ms` at the training shapes beside the mma.sync pair
(K3 then K4), SDPA's backward alone and the "bwd" bound; the variant
without the dQ reduction computes no dq, and the ablations are timed only.
The built kernel's time is also split by kernel (the set-up with the
maxima of dO, K and V, the fused kernel, the dq pass) with torch.profiler,
and dq is read twice for its run-to-run relative L2. Also prints the ptxas
report of the forward's library (its registers must not move with the
shared header). Prints one JSON object per line, then the card's name and
power limit. Needs the card
and nvcc; exits 2 without them.
"""
import ctypes
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "consistentid_torch" / "csrc" / "flash_attention_bwd_sm90.cu"
OUT = REPO / "build" / "variants"

NO_EXP = [("= ex2(fmaf(", "= (fmaf(")]
NO_DQ = [("    issue_dq<T, DP>(dq,", "    if (false) issue_dq<T, DP>(dq,")]
NO_DVDK = [(f"    issue_xt<T, DP>({acc},",
            f"    if (false) issue_xt<T, DP>({acc},")
           for acc in ("dv_acc", "dk_acc")]
NO_REDUCE = [("    if (tid == 0) {\n      bulk_reduce_add(",
              "    if (false) {\n      bulk_reduce_add(")]
# dQ's partial sums added in fp32, in arrival order (the kernel before dQ
# was made deterministic)
FP32_DQ = [("constexpr bool kFixedDq = true;",
            "constexpr bool kFixedDq = false;")]
STAGES = "kStages = DP == 128 ? 2 : 4;"
# the next tile's scores issued only when there is a next tile
BRANCH = [(
    "    issue_scores(s, dp, st1);\n"
    "    fence_regs(s);  // in flight until the next iteration's waits\n"
    "    fence_regs(dp);\n"
    "    wgmma_wait<2>();  // dV, dK and dQ of this tile have landed\n",
    "    if (it + 1 < q_tiles) {\n"
    "      issue_scores(s, dp, st1);\n"
    "      fence_regs(s);\n"
    "      fence_regs(dp);\n"
    "      wgmma_wait<2>();\n"
    "    } else {\n"
    "      wgmma_wait<0>();\n"
    "    }\n")]
VARIANTS = {
    "as built": [],
    "dQ in fp32, arrival order": FP32_DQ,
    "next scores under a branch": BRANCH,
    "no dQ reduction": NO_REDUCE,
    "3 ring stages": [(STAGES, "kStages = DP == 128 ? 2 : 3;")],
    "2 ring stages": [(STAGES, "kStages = 2;")],
    # ablations, for where the time goes (their outputs are wrong)
    "ablation: no exp": NO_EXP,
    "ablation: no dQ product": NO_DQ,
    "ablation: no dV, dK products": NO_DVDK,
    "ablation: S, dP and exps only": NO_DQ + NO_DVDK + NO_REDUCE,
    "ablation: S and dP only": NO_EXP + NO_DQ + NO_DVDK + NO_REDUCE,
}
ABLATIONS = [n for n in VARIANTS if n.startswith("ablation")]
# (B, H, Sq, D), Sk, dtype, timed
CASES = [((2, 8, 4096, 40), 4096, "bfloat16", True),
         ((2, 8, 1024, 80), 1024, "bfloat16", True),
         ((2, 3, 1000, 40), 1037, "bfloat16", False),
         ((2, 3, 1000, 80), 1037, "float16", False),
         ((2, 4, 777, 64), 900, "bfloat16", False),
         ((2, 2, 500, 128), 333, "float16", False),
         ((1, 1, 50, 40), 30, "bfloat16", False)]


def build(name, edits):
    """Compile one variant; returns (name, library path or None, ptxas
    registers and spill-store bytes per kernel, nvcc's error text)."""
    from consistentid_torch.ops import build as port_build
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in the source")
        text = text.replace(old, new)
    slug = re.sub(r"\W+", "_", name)
    src = SRC.parent / f"_variant_bwd_{slug}.cu"  # beside the headers
    lib = OUT / f"lib_bwd_{slug}.so"
    src.write_text(text)
    try:
        proc = subprocess.run(
            port_build.nvcc_command(port_build.find_nvcc(), [src], lib),
            capture_output=True, text=True)
    finally:
        src.unlink()
    report = proc.stdout + proc.stderr
    kernels = [(k["function"][:60], k["registers"], k["spill_stores"])
               for k in port_build.ptxas_report(report)]
    remarks = [line.strip() for line in report.splitlines()
               if "wgmma" in line.lower()]
    return name, (lib if proc.returncode == 0 else None), kernels, remarks, (
        report[-3000:] if proc.returncode else "")


def kernel_split(call, calls: int = 10):
    """Device time per call of each kernel `call` launches, from
    torch.profiler: the set-up (statistics and the maxima of dO, K and V),
    the fused kernel, the dq pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {e.key[:40]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import attention_bound, cuda_ms, nvidia_smi
    from consistentid_torch.ops import build as port_build
    from consistentid_torch.ops import flash_attention as fa
    from consistentid_torch.testing import rel_l2

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS) + 2) as pool:
        libs = pool.map(port_build.load_library,
                        ("flash_attention_sm90", "flash_attention_bwd"))
        built = list(pool.map(lambda kv: build(*kv), VARIANTS.items()))
        list(libs)
    fwd = port_build.ptxas_report(port_build.load_report(
        "flash_attention_sm90"))
    print(json.dumps({"forward_ptxas": [(k["function"][:60], k["registers"],
                                         k["spill_stores"]) for k in fwd]}),
          flush=True)
    fns = {}
    for name, lib, kernels, remarks, err in built:
        print(json.dumps({"variant": name, "built": lib is not None,
                          "registers_spills": kernels,
                          "wgmma_remarks": remarks}), flush=True)
        if lib is None:
            print(err, file=sys.stderr)
            continue
        fn = ctypes.CDLL(str(lib)).cid_flash_attention_backward_sm90
        fn.argtypes = fa._SIGNATURES["cid_flash_attention_backward_sm90"][1]
        fns[name] = fn
    if "as built" not in fns:
        return 1

    gen = torch.Generator("cuda").manual_seed(0)
    for (b, h, sq, d), sk, dtype_name, timed in CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                                 (b, h, sq, d)))
        out, lse = fa.flash_attention_lse_plain(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        same = [t.to(dtype) for t in fa.flash_attention_bwd_plain(
            q, k, v, do, lse, delta, round_to=dtype)]
        scale = 1.0 / math.sqrt(d)
        ws = torch.empty(fa.sm90_bwd_workspace_floats(b * h, sq, d),
                         device="cuda")
        grads = [torch.empty_like(t) for t in (q, k, v)]
        row = {"shape": [b, h, sq, d], "sk": sk, "dtype": dtype_name}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         *(t.data_ptr() for t in grads), ws.data_ptr(),
                         b * h, sq, sk, d, scale, fa._DTYPE_CODES[dtype],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            for t in grads:
                t.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            first = grads[0].clone()
            rels = {n: rel_l2(g, s) for n, g, s in
                    zip(("dq", "dk", "dv"), grads, same)}
            entry = {"rel_l2": rels}
            if name == "as built":
                call()
                torch.cuda.synchronize()
                entry["dq_run_to_run_rel_l2"] = rel_l2(grads[0], first)
            if timed:
                entry["ms"] = cuda_ms(call, 20)
            if timed and name == "as built":
                entry["kernels_ms"] = kernel_split(call)
            row[name] = entry
        if timed:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            sdpa = torch.nn.functional.scaled_dot_product_attention(*leaves)
            row["sdpa_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
                sdpa, leaves, do, retain_graph=True), 20)
            args = (b * h, sq, sk, d, scale, fa._DTYPE_CODES[dtype])

            def pair():
                fa._launch("cid_flash_attention_backward_dq", q.device, q, k,
                           v, do, lse, delta, grads[0], *args)
                fa._launch("cid_flash_attention_backward_dkv", q.device, q,
                           k, v, do, lse, delta, grads[1], grads[2], *args)
            row["mma_pair_ms"] = cuda_ms(pair, 20)
            row["bound_ms"] = attention_bound(b, h, sq, sk, d, 2, True,
                                              "bwd")[0]
            del leaves, sdpa
        print(json.dumps(row), flush=True)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
