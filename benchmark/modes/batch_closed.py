"""batch_closed: one caller of the pipeline's generate_batch with `batch`
requests at a time, back to back, until the window ends."""
from __future__ import annotations

import time
from typing import List

from benchmark.harness.drive import Record
from benchmark.harness.inputs import Requests
from benchmark.harness.serving import ServingSession


def loop(pipe, reqs: Requests, traffic, seconds: float, t0: float,
         grace_s: float) -> List[Record]:
    records: List[Record] = []
    n = traffic["batch"]
    k = 0
    while time.perf_counter() < t0 + seconds:
        now = time.perf_counter()
        batch = [Record(*reqs.get(0, k * n + j), now, now) for j in range(n)]
        try:
            images = pipe.generate_batch(
                [r.prompt for r in batch], [reqs.faces[r.face] for r in batch],
                seeds=[r.seed for r in batch])
            done = time.perf_counter()
            for r, img in zip(batch, images):
                r.done, r.image, r.batch_size = done, img, n
        except Exception as e:  # noqa: BLE001 - a failed batch is counted
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
        records += batch
        k += 1
    return records


def first_round(reqs: Requests, traffic):
    """One batch (calibrate.py's round)."""
    return [reqs.get(0, i) for i in range(traffic["batch"])]


def make(cell, seed: int, device):
    return ServingSession(cell, seed, device, loop, batcher=False)
