"""Tracing, step timing and metrics, the counterpart of the JAX package's
utils/profiling.py:
  - `trace(dir)`: a torch.profiler trace of the block (CPU and CUDA),
    written as a Chrome trace into `dir`;
  - `annotate(name)`: a named span on that timeline (record_function);
  - `StepTimer`: rolling per-step wall time with the data-loading share;
  - `MetricsLogger`: a JSONL metrics stream, a console line and, when its
    writer imports, TensorBoard scalars; rank 0 only under
    torch.distributed.
The JAX module's peak-FLOP table and MFU are for TPUs and are not carried.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block; the trace goes to log_dir."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span on the profiler timeline."""
    return torch.profiler.record_function(name)


def _is_main_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


class StepTimer:
    """Per-step timing with a separate data-loading bucket."""

    def __init__(self, window: int = 50):
        self.step_times = deque(maxlen=window)
        self.data_times = deque(maxlen=window)
        self._t = time.perf_counter()

    def data_loaded(self):
        now = time.perf_counter()
        self.data_times.append(now - self._t)
        self._t = now

    def step_done(self):
        now = time.perf_counter()
        self.step_times.append(now - self._t)
        self._t = now

    def summary(self) -> Dict[str, float]:
        def avg(d):
            return sum(d) / len(d) if d else 0.0
        return {"step_time_s": avg(self.step_times),
                "data_time_s": avg(self.data_times)}


class MetricsLogger:
    """metrics.jsonl in log_dir, a console line per record and optional
    TensorBoard scalars, written by the main process only."""

    def __init__(self, log_dir: Optional[str] = None, echo: bool = True,
                 tensorboard: bool = True):
        self.is_main = _is_main_process()
        self.echo = echo
        self._f = None
        self._tb = None
        if log_dir and self.is_main:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(os.path.join(log_dir,
                                                          "tensorboard"))
                except Exception:  # noqa: BLE001 (no tensorboard package)
                    self._tb = None

    def log(self, step: int, metrics: Dict):
        if not self.is_main:
            return
        rec = {"step": int(step),
               **{k: float(v) for k, v in metrics.items()}}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, rec["step"])
        if self.echo:
            parts = " ".join(f"{k}={v:.5g}" for k, v in rec.items()
                             if k != "step")
            print(f"step {rec['step']}: {parts}", flush=True)

    def close(self):
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
