"""Readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N] [--out FILE]

For each seed, as a run of the cell would: the system, its weights and its
inputs are made from the seed; one round of the cell's traffic (every
client's first request in batches of max_batch, or one batch) goes
through the pipeline's generate_batch with the benchmark's recording hooks
on (harness/capture.py); a sample of as many requests as a run compares
is judged stage by stage (reference/stepwise.py): start, eps, step, image.

On the first `control-seeds` seeds each number's control is read too
(`--controls`), on the same requests: the UNet numbers under both of the
system's int8 serving paths below its bf16, each recorded the same way
(`int8`: dynamic W8A8, `apps.serve --quant int8`; `int8s`: int8_static,
its scales calibrated on the round's first request as `apps.serve --quant
int8_static` does on one photo); parse and embed, the reference's
perception with TF32 on (below its fp32) in the system's place; cond and
its parts, the reference's text towers, ViT-H and adapters with every
product's input and weight rounded to fp8 e4m3 (below their bf16); step,
the reference's sampler update in bf16 (below the system's fp32 update);
image, the reference's decoder rounded to fp8 (below a bf16 decoder) or
to bf16 (below an fp32 one). The lower reading of a number is its largest
over the seeds, the upper the least of every control's readings. One JSON
line per seed and a summary go to standard output (and --out).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_round(pipe, reqs, traffic, todo):
    """Serve `todo` [(prompt, face, seed)] through generate_batch in
    batches of the cell's size; returns {seed: image}."""
    size = traffic.get("batch", traffic.get("max_batch"))
    served = {}
    for i in range(0, len(todo), size):
        b = todo[i:i + size]
        images = pipe.generate_batch([r[0] for r in b],
                                     [reqs.faces[r[1]] for r in b],
                                     seeds=[r[2] for r in b])
        for r, img in zip(b, images):
            served[r[2]] = img
    return served


CONTROLS = ("int8", "int8s", "low")


def calibrate(cell, seeds, control_seeds: int, device="cuda", emit=print,
              controls=CONTROLS,
              deadline: float = float("inf")):
    """The per-seed rows (each emitted as a JSON line) and the summary;
    `seeds` a list of run seeds; `controls` the controls read on the first
    `control_seeds` seeds; no seed is started after `deadline`
    (time.perf_counter())."""
    import numpy as np
    import torch
    from benchmark.harness.build import (DTYPES, build_program,
                                         build_reference)
    from benchmark.harness.capture import Capture, plan
    from benchmark.harness.inputs import Requests, face_pool
    from benchmark.harness.spec import load_mode
    from benchmark.reference.stepwise import follow, lower_precision, worst

    cuda = torch.device(device).type == "cuda"

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    traffic, request = cell.traffic, cell.traffic["request"]
    check = cell.workload["check"]
    k_check = check["requests"]
    probes = check.get("probes", [])
    probe_steps = check.get("probe_steps", [])
    vae_dtype = (torch.float32 if cell.config["vae"].get("force_upcast")
                 else DTYPES[cell.config["dtype"]])
    below = torch.float8_e4m3fn if vae_dtype != torch.float32 \
        else torch.bfloat16
    first_round = load_mode(traffic["mode"]).first_round
    rows = []
    for k, seed in enumerate(seeds):
        if time.perf_counter() > deadline:
            break
        control = k < control_seeds
        t0 = time.perf_counter()
        pipe = build_program(cell.config, request, seed, device=device)
        faces = face_pool(seed, traffic["faces"], traffic["face_px"])
        reqs = Requests(seed, traffic["prompts"], faces)
        todo = first_round(reqs, traffic)
        quants = {}
        if control and "int8" in controls:
            quants["int8"] = pipe.with_quant("int8")
        if control and "int8s" in controls:
            quants["int8s"] = pipe.calibrate_int8(todo[0][0],
                                                  faces[todo[0][1]])
        size = traffic.get("batch", traffic.get("max_batch"))
        picks = plan(seed, k_check, -(-len(todo) // size))
        cap = Capture(pipe, picks, probes, probe_steps)
        served = one_round(pipe, reqs, traffic, todo)
        qcap, qserved = {}, {}
        for name, q in quants.items():
            qcap[name] = Capture(q, picks, probes, probe_steps)
            qserved[name] = one_round(q, reqs, traffic, todo)
        del pipe, quants
        free()
        ref = build_reference(cell.config, request, seed, device=device)
        m = ref.m
        towers = [m.text_encoder, m.image_encoder, m.proj, m.facial_encoder]
        if m.sdxl:
            towers.append(m.text_encoder_2)
        got, ctl, each = {}, {}, []
        pick = [r for r in todo if r[2] in cap.got]
        for prompt, face, s in pick:
            gaps = follow(ref, prompt, faces[face], s, cap.got[s], served[s])
            worst(got, gaps)
            each.append(dict(gaps, seed=s, faceid_zero=bool(
                not np.any(cap.got[s]["faceid"]))))
            for name in qcap:
                q = follow(ref, prompt, faces[face], s, qcap[name].got[s],
                           qserved[name][s])
                worst(ctl, {f"{name}:{n}": v for n, v in q.items()
                            if n.startswith("unet")})
            if control and "low" in controls:
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = True
                tf32 = dict(cap.got[s], labels=ref.parser(faces[face]),
                            faceid=ref.embedder(faces[face]))
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                with lower_precision(towers, torch.float8_e4m3fn), \
                        lower_precision([m.vae], below):
                    low = follow(ref, prompt, faces[face], s, tf32,
                                 served[s], step_dtype=torch.bfloat16,
                                 unet=False)
                worst(ctl, {f"low:{n}": v for n, v in low.items()
                            if n != "start" and not n.startswith("unet")})
        del ref, m, towers
        free()
        row = {"seed": seed, "program": got, "control": ctl or None,
               "requests": each,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        emit(json.dumps(row))
    summary = {"cell": cell.name, "seeds": len(rows),
               "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    for n in rows[0]["program"]:
        summary[f"{n}_lower"] = max(r["program"][n] for r in rows)
        ups = [v for r in rows for c, v in (r["control"] or {}).items()
               if c.split(":", 1)[1] == n]
        summary[f"{n}_upper"] = min(ups) if ups else None
    emit(json.dumps(summary))
    return rows, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=5_000_000_017)
    p.add_argument("--seed-list", type=int, nargs="*",
                   help="these seeds instead of --seeds from --first-seed")
    p.add_argument("--controls", nargs="*", default=list(CONTROLS),
                   choices=CONTROLS)
    p.add_argument("--minutes", type=float, default=float("inf"),
                   help="start no seed after this many minutes")
    p.add_argument("--out")
    args = p.parse_args(argv)
    t_end = time.perf_counter() + 60 * args.minutes
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.spec import load_cell

    seeds = args.seed_list or [args.first_seed + 7919 * k
                               for k in range(args.seeds)]
    rows, summary = calibrate(load_cell(args.workload), seeds,
                              args.control_seeds,
                              emit=lambda line: print(line, flush=True),
                              controls=args.controls, deadline=t_end)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
