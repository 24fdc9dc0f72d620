"""serve_open: an open loop into the system's MicroBatcher (apps.serve,
in process, no HTTP): Poisson arrivals at `rate_per_s`, the schedule drawn
from the seed; each request is timed from its scheduled send, and the
generator's lateness is recorded beside it."""
from __future__ import annotations

import time
from typing import List

import numpy as np

from benchmark.harness.drive import Record, finish, pending
from benchmark.harness.inputs import Requests, mix
from benchmark.harness.serving import ServingSession


def poisson_schedule(seed: int, rate: float, seconds: float) -> List[float]:
    """Arrival offsets in [0, seconds) of a Poisson process at `rate`."""
    rng = np.random.default_rng(mix(seed, 0xA55))
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= seconds:
            return out
        out.append(t)


def loop(batcher, reqs: Requests, traffic, seconds: float, t0: float,
         grace_s: float) -> List[Record]:
    from consistentid_torch.apps import serve
    schedule = poisson_schedule(reqs.seed, traffic["rate_per_s"], seconds)
    sent = []
    for i, off in enumerate(schedule):
        due = t0 + off
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        prompt, face, seed = reqs.get(0, i)
        r = Record(prompt, face, seed, due, time.perf_counter())
        sent.append((r, batcher.submit(pending(serve, r, reqs.faces))))
    deadline = t0 + seconds + grace_s
    for r, p in sent:
        if p.event.wait(max(0.0, deadline - time.perf_counter())):
            finish(r, p)
        else:
            r.error = "no answer"
    return [r for r, _ in sent]


def first_round(reqs: Requests, traffic):
    """The first `max_batch` arrivals (calibrate.py's round)."""
    return [reqs.get(0, i) for i in range(traffic["max_batch"])]


def make(cell, seed: int, device):
    return ServingSession(cell, seed, device, loop, batcher=True)
