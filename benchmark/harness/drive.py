"""What the traffic loops of the serving modes (modes/<mode>.py) share:
the record of one request and the MicroBatcher's pending entry for it.

Every request is (prompt, face, seed) from harness/inputs.py. Each loop
returns the records of all requests sent before the window ended, after
each has completed (or `grace_s` has passed)."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


class StampedEvent(threading.Event):
    """A threading.Event that notes when it was set."""

    t: Optional[float] = None

    def set(self) -> None:
        self.t = time.perf_counter()
        super().set()


@dataclass
class Record:
    prompt: str
    face: int
    seed: int
    scheduled: float
    sent: float
    done: Optional[float] = None
    image: Optional[np.ndarray] = None
    error: Optional[str] = None
    batch_size: int = 0

    @property
    def ok(self) -> bool:
        return self.image is not None and self.error is None


def pending(batcher_mod, r: Record, faces):
    return batcher_mod._Pending(r.prompt, faces[r.face], "", r.seed,
                                event=StampedEvent())


def finish(r: Record, p) -> None:
    r.done, r.image, r.error, r.batch_size = (p.event.t, p.result, p.error,
                                              p.batch_size)
