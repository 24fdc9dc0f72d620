"""The benchmark's own spans around the system's calls, installed on one
pipeline instance (its bound methods wrapped, nothing in the package
edited), in traced runs: prepare_batch ("prepare", host seconds and rows),
  _branches ("encode"), bundle.infer_unet ("fold"), each UNet call
  ("unet", forward hooks on the UNet that infer_unet returns; the rows of
  each profiled call logged), _decode ("decode"), the safety checker
  ("safety").

Each traced span is a torch.profiler.record_function range, so under the
profiler the kernels it launched carry its name on the device timeline.
The window itself runs untraced (prepare's host time is summed there);
once `arm` is called, after the window, the profiler is started and
stopped at the start of the `first`-th and `first + count`-th prepare
that follow, on the thread that prepares (the microbatcher's worker, or
the caller)."""
from __future__ import annotations

import time
from typing import Dict, List

import torch


class Spans:
    def __init__(self, pipe, first: int, count: int):
        self.prepare_s = 0.0
        self.prepare_rows = 0
        self.prepares = 0
        self.unet_rows_log: List[int] = []   # rows of each profiled call
        self.first, self.count = first, count
        self.prof = None
        self.profiling = False
        self.armed = False
        self._wrap(pipe, "_branches", "encode")
        self._wrap(pipe, "_decode", "decode")
        if getattr(pipe, "safety_checker", None) is not None:
            self._wrap(pipe, "safety_checker", "safety")
        self._wrap_prepare(pipe)
        self._wrap_fold(pipe.bundle)

    @staticmethod
    def _wrap(obj, name, span):
        inner = getattr(obj, name)

        def call(*a, **k):
            with torch.profiler.record_function(span):
                return inner(*a, **k)

        setattr(obj, name, call)

    def _wrap_prepare(self, pipe):
        inner = pipe.prepare_batch

        def call(prompts, *a, **k):
            if not self.armed:
                t0 = time.perf_counter()
                with torch.profiler.record_function("prepare"):
                    out = inner(prompts, *a, **k)
                self.prepare_s += time.perf_counter() - t0
                self.prepare_rows += len(prompts)
                return out
            self.prepares += 1
            if self.prepares == self.first:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                self.prof = profile(activities=acts)
                self.prof.start()
                self.profiling = True
            elif self.prepares == self.first + self.count and self.profiling:
                self.stop()
            with torch.profiler.record_function("prepare"):
                return inner(prompts, *a, **k)

        pipe.prepare_batch = call

    def arm(self) -> None:
        self.armed = True

    @property
    def finished(self) -> bool:
        return self.prof is not None and not self.profiling

    def stop(self) -> None:
        if self.profiling:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.profiling = False

    def _wrap_fold(self, bundle):
        inner = bundle.infer_unet

        def call(*a, **k):
            with torch.profiler.record_function("fold"):
                unet = inner(*a, **k)
            state: Dict[str, object] = {}

            def pre(module, args):
                if self.profiling:
                    self.unet_rows_log.append(args[0].shape[0])
                state["rf"] = torch.profiler.record_function("unet")
                state["rf"].__enter__()

            def post(module, args, out):
                state.pop("rf").__exit__(None, None, None)

            unet.register_forward_pre_hook(pre)
            unet.register_forward_hook(post)
            return unet

        bundle.infer_unet = call

