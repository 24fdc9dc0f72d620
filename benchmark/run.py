"""Run one cell of the benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name (harness/spec.py): the cell in
BENCHMARK.json and workloads/<cell>.json, its configuration, its traffic
mix, the mix's mode in modes/<mode>.py, and one reader per metric in
metrics/<name>.py. The mode builds the system under test
(consistentid_torch) with weights and inputs made from --seed, warms up the
shapes its traffic uses, drives the traffic for --seconds, and then checks
a sample of what the window produced against the plain fp32 reference
(reference/). With --trace 0 it reports the cell's
end-to-end metrics, with --trace 1 its per-layer metrics from a profiled
sub-window. The last line of standard output is one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the result's last key. Exits non-zero, printing no result,
without a card or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "consistentid_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device="cuda", start: float = START):
    """One run of `cell`: (result dict, stderr lines). `device` "cpu"
    serves the tests, at a toy configuration."""
    import torch
    from benchmark.harness.spec import load_mode, load_reader
    from benchmark.harness.trace import summarize

    cuda = torch.device(device).type == "cuda"
    session = load_mode(cell.traffic["mode"]).make(cell, seed, device)
    session.warm_up()
    records, t0 = session.drive(seconds, trace)
    setup_s = t0 - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = session.spans
    summary = (summarize(spans.prof) if cuda and spans is not None
               and spans.prof is not None else None)
    attempted = len(records)
    failed = sum(not r.ok for r in records)

    session.release()
    gaps, compared = session.check()
    limits = cell.workload["check"]["limits"]
    checks = {f"{k}_rel_l2": {"value": gaps.get(k, float("inf")),
                              "limit": limits[k]} for k in limits}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    correct = (attempted > 0 and compared > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    ctx = SimpleNamespace(cell=cell, traffic=cell.traffic, records=records,
                          t0=t0, setup_s=setup_s, spans=spans, trace=summary,
                          request_flops=session.request_flops)
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": cell.entry["chips"],
                      "memory_peak_bytes": peak}}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s,
                             window_s=summary.window_s)
        out["breakdown"] = summary.breakdown()
    out["checks"] = checks
    late = max((r.sent - r.scheduled for r in records), default=0.0)
    lines = [f"requests sent {attempted}, failed {failed}, compared "
             f"{compared}; the generator ran late by at most {late:.4f} s"]
    for v in checks.values():                  # JSON has no infinity
        if v["value"] == float("inf"):
            v["value"] = 1e30
    lines.append("not compared: " + ", ".join(
        f"{k}_rel_l2 {v}" for k, v in sorted(gaps.items())
        if k not in limits))
    lines += [f"{k} {v['value']} limit {v['limit']}"
              for k, v in checks.items()]
    return out, lines


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch
    chips = cell.entry["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"needs {chips} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    out, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
