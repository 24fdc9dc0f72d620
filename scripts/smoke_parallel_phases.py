#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phases 31 (parallel/, two ranks on the card) and
32 (BiSeNet training) alone, after the least set-up they need: the kernels
built, the full-width SD1.5 bundle and perception hooks, the SD1.5 set and
the seeded LLaVA-1.5-7B set written to a temporary directory.

    python3 scripts/smoke_parallel_phases.py [--out results.json]

Prints each phase's figures (the smoke's own log lines) and the seconds
of each step; with --out also writes the phases' results as JSON. Needs
one CUDA card.
"""
import argparse
import json
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    from consistentid_torch.core.config import LlavaConfig
    from consistentid_torch.models.llava import random_llava
    from consistentid_torch.ops import build
    from consistentid_torch.utils.png import encode_png

    cs.log(cs.nvidia_smi())
    with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:
        list(pool.map(build.load_library, build.LIBRARIES))
    bundle, _ = cs.phase("main path", cs.main_path)
    hooks, _ = cs.phase("perception", cs.perception_phase)
    tmp = tempfile.mkdtemp(prefix="cid_phases_")
    try:
        paths, _ = cs.phase("write the SD1.5 set", cs.write_checkpoint_set,
                            bundle, hooks, tmp)
        del hooks, bundle
        torch.cuda.empty_cache()
        Path(tmp, "face.png").write_bytes(encode_png(cs.face_inputs()[0]))
        set_dir = Path(tmp, "llava-1.5-7b-hf")
        set_dir.mkdir()
        model = random_llava(LlavaConfig(), seed=0, dtype=torch.bfloat16,
                             device="cuda")
        cs.phase("write the LLaVA set", cs.write_llava_set, model, set_dir)
        del model
        torch.cuda.empty_cache()
        par = cs.phase("parallel", cs.parallel_phase, paths, tmp, set_dir)
        bis = cs.phase("BiSeNet training", cs.bisenet_phase, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log(json.dumps(cs.PHASE_S))
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"parallel": par, "bisenet": bis, "phase_s": cs.PHASE_S},
            default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
