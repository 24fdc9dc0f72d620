#!/usr/bin/env python3
"""Run `chip_smoke.py`'s K5/K6 phase alone: build the fused BatchNorm
library from csrc/fused_bn_act.cu, print each of its kernels' registers,
shared memory and spills (ptxas), then check and time K5, K6 and
fused_bn_act at the smoke's five shapes (`chip_smoke.bn_kernel_phase`).

    python3 scripts/smoke_bn_phase.py [--out results.json]

With `--parent DIR`, DIR holds another checkout (say the parent commit,
unpacked with `git archive`): its own K5/K6 phase runs first and last, this
tree's twice between them (parent, change, change, parent), each in its
own process on the same card, and the K5, K6 times of each run are printed
side by side. Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# one run of a checkout's phase, in its own process: prints one JSON line
_RUN = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
from consistentid_torch.ops import build
build.load_library("fused_bn_act")
out = cs.bn_kernel_phase()
print("BN_ROWS " + json.dumps(out[0]))
"""


def run_checkout(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                          capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"the K5/K6 phase of {root} failed "
                           f"({proc.returncode})")
    line = [l for l in proc.stdout.splitlines() if l.startswith("BN_ROWS ")]
    return json.loads(line[-1][len("BN_ROWS "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None)
    p.add_argument("--parent", default=None)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from consistentid_torch.ops import build

    cs.log(cs.nvidia_smi())
    build.load_library("fused_bn_act")
    for k in build.ptxas_report(build.load_report("fused_bn_act") or ""):
        cs.log(f"  {k['function']}: {k['registers']} registers, "
               f"{k['shared_bytes']} B static smem, stack {k['stack_bytes']}"
               f" B, spills {k['spill_stores']}/{k['spill_loads']} B")
    if args.parent is None:
        runs = {"change": [cs.phase("K5, K6 kernel checks",
                                    cs.bn_kernel_phase)[0]]}
    else:
        parent = Path(args.parent).resolve()
        runs = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            runs[who].append(run_checkout(parent if who == "parent"
                                          else ROOT))
        for kname in ("K5", "K6"):
            for i, row in enumerate(runs["change"][0][kname]):
                times = {who: [r[kname][i]["ms"] for r in rs]
                         for who, rs in runs.items()}
                cs.log(f"{kname} {row['case']}: parent {times['parent']} "
                       f"ms, change {times['change']} ms, bound "
                       f"{row['bound_ms']:.4f} ms")
    if args.out:
        Path(args.out).write_text(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
