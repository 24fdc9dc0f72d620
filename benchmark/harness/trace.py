"""The traced sub-window: torch.profiler over a few batches or steps of
steady traffic, reduced to device busy and idle time (the union of the
device's operation intervals), kernel time by name, device time inside the
benchmark's own host spans (their GPU user annotations), and the longest
idle gaps named by the host span open when each began."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[float, float, str]]          # (start, end, name) s
    by_name: Dict[str, float]
    spans_device_s: Dict[str, List[float]]           # annotation -> [s]
    span_kernels: Dict[str, List[List[Tuple[str, float]]]]
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_s(self, match) -> float:
        """Device seconds of kernels whose name satisfies `match`."""
        return sum(b - a for a, b, n in self.kernels if match(n))

    def breakdown(self) -> Dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def summarize_events(events: List[Dict]) -> TraceSummary:
    """Reduce chrome-trace events (ts and dur in microseconds)."""
    dev, gpu_ann, host_ann = [], [], []
    lo, hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        lo, hi = min(lo, a), max(hi, b)
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((a, b, e["name"]))
        elif cat == "gpu_user_annotation":
            gpu_ann.append((a, b, e["name"]))
        elif cat == "user_annotation":
            host_ann.append((a, b, e["name"]))
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    busy = union([(a, b) for a, b, _ in dev])
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        by_name[n[:120]] += b - a
    dev.sort()
    starts = [a for a, _, _ in dev]
    spans: Dict[str, List[float]] = defaultdict(list)
    inside: Dict[str, List[List[Tuple[str, float]]]] = defaultdict(list)
    for a, b, n in sorted(gpu_ann):
        i = bisect.bisect_left(starts, a - 1e-7)
        ks = []
        while i < len(dev) and dev[i][0] < b + 1e-7:
            if dev[i][1] <= b + 1e-6:
                ks.append((dev[i][2], dev[i][1] - dev[i][0]))
            i += 1
        spans[n].append(sum(d for _, d in ks))
        inside[n].append(ks)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    host_ann.sort(key=lambda t: t[1] - t[0])          # innermost first
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        name = next((n for s, e, n in host_ann if s <= a < e), "no span")
        gaps[name] += b - a
    return TraceSummary(
        window_s=hi - lo, busy_s=sum(b - a for a, b in busy),
        kernels=dev, by_name=dict(by_name), spans_device_s=dict(spans),
        span_kernels=dict(inside),
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def summarize(prof) -> TraceSummary:
    """Export the stopped profiler's trace into TMPDIR, reduce it, and
    delete the file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize_events(events)
