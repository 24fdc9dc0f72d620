#!/usr/bin/env python3
"""Where the time of writing and loading a full-width SD1.5 checkpoint set
goes, on the card (NVIDIA H100):

    python3 scripts/profile_checkpoint_io.py [--top 22]

Builds chip_smoke.py's serving bundle (ConsistentID SD1.5, bf16, LoRA rank
128, seeded random weights) on the card, writes it as a reference-layout
set in fp16 (`io.export.write_reference_checkpoints`) to a temporary
directory, and loads it back with
`pipelines.loading.load_sd15_consistentid`, each under cProfile (functions
by their own time), then loads it once more without the profiler. Prints
the file system of the temporary directory, the seconds of each step, the
profiles and the card's name and power limit. Needs the card; exits 2
without it.
"""
import argparse
import cProfile
import io
import pstats
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def profiled(label: str, fn, top: int):
    import torch
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    out = fn()
    torch.cuda.synchronize()
    prof.disable()
    seconds = time.perf_counter() - t0
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(top)
    print(f"==== {label}: {seconds:.2f} s\n{text.getvalue()}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=22)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_checkpoint_io: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from consistentid_torch.core import AdapterConfig, sd15_unet_config
    from consistentid_torch.io.export import write_reference_checkpoints
    from consistentid_torch.pipelines import SD15Bundle
    from consistentid_torch.pipelines.loading import load_sd15_consistentid
    from consistentid_torch.testing import synthetic_clip_tokenizer

    bundle = SD15Bundle(sd15_unet_config(lora_rank=128, ip_num_tokens=4),
                        AdapterConfig(), dtype=torch.bfloat16, device="cuda")
    bundle.random_params(torch.Generator("cuda").manual_seed(0))
    out = tempfile.mkdtemp(prefix="cid_io_")
    try:
        print(subprocess.run(["df", "-hT", out], capture_output=True,
                             text=True).stdout, flush=True)
        paths, nbytes = profiled(
            "write_reference_checkpoints (fp16)",
            lambda: write_reference_checkpoints(
                out, bundle, vocab=synthetic_clip_tokenizer().encoder),
            args.top)
        print(f"set: {nbytes} bytes", flush=True)
        kw = {k: v for k, v in paths.items() if k != "base"}

        def load():
            return load_sd15_consistentid(paths["base"], device="cuda", **kw)
        pipe = profiled("load_sd15_consistentid", load, args.top)
        del pipe
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipe = load()
        torch.cuda.synchronize()
        print(f"load_sd15_consistentid without the profiler: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del pipe
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
