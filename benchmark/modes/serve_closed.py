"""serve_closed: `clients` closed-loop clients of the system's
MicroBatcher (apps.serve, in process, no HTTP), `max_batch` rows a batch
after a `window_ms` wait: each client sends its next request when its
last one returns, until the window ends."""
from __future__ import annotations

import threading
import time
from typing import List

from benchmark.harness.drive import Record, finish, pending
from benchmark.harness.inputs import Requests
from benchmark.harness.serving import ServingSession


def loop(batcher, reqs: Requests, traffic, seconds: float, t0: float,
         grace_s: float) -> List[Record]:
    from consistentid_torch.apps import serve
    records: List[Record] = []
    lock = threading.Lock()
    end = t0 + seconds

    def client(c: int):
        i = 0
        while time.perf_counter() < end:
            prompt, face, seed = reqs.get(c, i)
            now = time.perf_counter()
            r = Record(prompt, face, seed, now, now)
            p = batcher.submit(pending(serve, r, reqs.faces))
            if not p.event.wait(seconds + grace_s):
                r.error = "no answer"
            else:
                finish(r, p)
            with lock:
                records.append(r)
            i += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(traffic["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 2 * grace_s)
    return records


def first_round(reqs: Requests, traffic):
    """Every client's first request (calibrate.py's round)."""
    return [reqs.get(c, 0) for c in range(traffic["clients"])]


def make(cell, seed: int, device):
    return ServingSession(cell, seed, device, loop, batcher=True)
