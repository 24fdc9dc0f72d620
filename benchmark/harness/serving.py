"""The session of the serving modes (modes/serve_closed.py,
modes/serve_open.py, modes/batch_closed.py): one instance of the system's
pipeline built from the seed, with the recording hooks that the check
reads (capture.py), driven by the mode's traffic loop, and checked stage
by stage against the reference (reference/stepwise.py).

A mode file exposes `make(cell, seed, device)`, which returns a session
with `warm_up()`, `drive(seconds, trace) -> (records, t0)`, `release()`,
`check() -> (gaps, compared)`, `spans` and `request_flops()`; a mode of
another kind (training) brings a session of its own with the same
methods."""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict

import torch

from .build import build_program, build_reference, with_options
from .capture import Capture, plan
from .inputs import Requests, face_pool, mix


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class ServingSession:
    """`loop(target, reqs, traffic, seconds, t0, grace_s) -> records`
    drives `target`: the system's MicroBatcher over the pipeline when
    `batcher`, else the pipeline itself."""

    def __init__(self, cell, seed: int, device, loop: Callable,
                 batcher: bool):
        self.cell, self.seed, self.device = cell, seed, device
        self.loop, self.batcher = loop, batcher
        self.traffic = traffic = cell.traffic
        self.request = traffic["request"]
        self.faces = face_pool(seed, traffic["faces"], traffic["face_px"])
        self.reqs = Requests(seed, traffic["prompts"], self.faces)
        pipe = build_program(cell.config, self.request, seed, device=device,
                             options=self.options())
        self.pipe = with_options(pipe, self.options(), self.reqs)
        self.capture = self.spans = None

    def options(self) -> Dict:
        """The pipeline's options (quant, cache_interval): the
        configuration's, then the traffic mix's over them."""
        return {**self.cell.config.get("pipeline", {}),
                **self.traffic.get("pipeline", {})}

    def warm_up(self) -> None:
        """A short generate at every batch size the traffic can run."""
        for b in self.traffic["warm_batches"]:
            batch = [self.reqs.get(-1, i) for i in range(b)]
            self.pipe.generate_batch([r[0] for r in batch],
                                     [self.faces[r[1]] for r in batch],
                                     seeds=[r[2] for r in batch],
                                     num_inference_steps=self.traffic[
                                         "warm_steps"])

    def drive(self, seconds: float, trace: bool):
        """Run the traffic for `seconds`; with `trace`, then a profiled
        sub-window of more of the same traffic, so that tracing slows
        nothing the window times. Returns (records, t0)."""
        from .spans import Spans
        traffic = self.traffic
        check = self.cell.workload["check"]
        k = check["requests"]
        self.capture = Capture(self.pipe, plan(self.seed, k, k),
                               check.get("probes", ()),
                               check.get("probe_steps", ()))
        if trace:
            self.spans = Spans(self.pipe, *traffic["trace_batches"])
        target, batcher = self.pipe, None
        if self.batcher:
            from consistentid_torch.apps.serve import MicroBatcher
            batcher = target = MicroBatcher(
                self.pipe, max_batch=traffic["max_batch"],
                window_ms=traffic["window_ms"])
        sync(self.device)
        t0 = time.perf_counter()
        try:
            records = self.loop(target, self.reqs, traffic, seconds, t0,
                                traffic["grace_s"])
            if self.spans is not None:
                self.spans.arm()
                more = Requests(mix(self.reqs.seed, 0x7ACE),
                                self.reqs.prompts, self.faces)
                for _ in range(4):
                    if self.spans.finished:
                        break
                    self.loop(target, more, traffic,
                              traffic["trace_seconds"], time.perf_counter(),
                              traffic["grace_s"])
        finally:
            if batcher is not None:
                batcher.stop()
        self.records = records
        return records, t0

    def release(self) -> None:
        """Free the system under test before the reference is built."""
        self.pipe = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The widest gap of each number over the sampled requests of the
        window, and how many were compared. A sampled request not
        answered, or not wholly recorded, reads inf."""
        from ..reference.stepwise import NUMBERS, follow, worst
        ref = build_reference(self.cell.config, self.request, self.seed,
                              device=self.device)
        by_seed = {r.seed: r for r in self.records}
        gaps: Dict[str, float] = {}
        compared = 0
        for seed, got in self.capture.got.items():
            r = by_seed.get(seed)
            if r is None:
                continue
            compared += 1
            if not r.ok or got["final"] is None:
                worst(gaps, {k: float("inf") for k in NUMBERS})
                continue
            worst(gaps, follow(ref, r.prompt, self.faces[r.face], seed, got,
                               r.image))
        return gaps, compared

    def request_flops(self) -> Dict[str, int]:
        from .yardstick import request_flops
        return request_flops(self.cell.config, self.request)
