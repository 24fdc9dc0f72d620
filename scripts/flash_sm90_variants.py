#!/usr/bin/env python3
"""Design alternatives of the sm90 flash-attention forward, timed in one
run on the card (NVIDIA H100):

    python3 scripts/flash_sm90_variants.py

Each variant is consistentid_torch/csrc/flash_attention_sm90.cu with a few
lines of its text replaced (the swizzle span of the tiles, the depth of the
K/V ring, CTAs per SM), built by nvcc for sm_90a in parallel under
build/variants/, checked against fp32 attention (relative L2) and timed
with chip_smoke.py's `cuda_ms` at the serving and training shapes, beside
SDPA. Prints one JSON object per shape, then the card's name and power
limit. Needs the card and nvcc; exits 2 without them.
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
SRC = REPO / "consistentid_torch" / "csrc" / "flash_attention_sm90.cu"
OUT = REPO / "build" / "variants"

SWIZZLE = "static constexpr int kSwizzle = DP == 80 ? 32 : 128;"
VARIANTS = {
    "as built": [],
    "32-byte boxes at every depth":
        [(SWIZZLE, "static constexpr int kSwizzle = 32;")],
    "128-byte boxes at every depth":
        [(SWIZZLE, "static constexpr int kSwizzle = 128;")],
    "3 ring stages": [("kSmStages = 4;", "kSmStages = 3;")],
    "one CTA per SM": [("DP <= 80 ? 2 : 1", "1")],
    "one CTA per SM, 6 ring stages": [("DP <= 80 ? 2 : 1", "1"),
                                      ("kSmStages = 4;", "kSmStages = 6;")],
}
SHAPES = [(8, 8, 4096, 40), (8, 8, 1024, 80), (2, 8, 4096, 40),
          (2, 8, 1024, 80), (2, 2, 2048, 128)]


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
    src = SRC.parent / f"_variant_{slug}.cu"   # beside flash_common.cuh
    lib = OUT / f"lib_{slug}.so"
    src.write_text(text)
    try:
        proc = subprocess.run(
            port_build.nvcc_command(port_build.find_nvcc(), [src], lib),
            capture_output=True, text=True)
    finally:
        src.unlink()
    report = proc.stdout + proc.stderr
    kernels = [(k["registers"], k["spill_stores"])
               for k in port_build.ptxas_report(report)]
    return name, (lib if proc.returncode == 0 else None), kernels, (
        report[-2000:] if proc.returncode else "")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F
    from chip_smoke import cuda_ms, nvidia_smi

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: build(*kv), VARIANTS.items()))
    fns = {}
    for name, lib, kernels, err in built:
        print(json.dumps({"variant": name, "built": lib is not None,
                          "registers_spills": kernels}), flush=True)
        if lib is None:
            print(err, file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(lib)).cid_flash_attention_forward_lse_sm90
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fns[name] = fn

    gen = torch.Generator("cuda").manual_seed(0)
    for shape in SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), device="cuda")
        ref = F.scaled_dot_product_attention(q.float(), k.float(), v.float())
        row = {"shape": list(shape), "dtype": "bfloat16",
               "sdpa_ms": cuda_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v), 20)}
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), b * h, s, s, d,
                         1 / math.sqrt(d), 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            rel = ((o.float() - ref).norm() / ref.norm()).item()
            row[name] = {"ms": cuda_ms(call, 20), "rel_l2": rel}
        print(json.dumps(row), flush=True)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
