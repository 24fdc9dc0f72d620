"""What the served path computes for the sampled requests, recorded while
it serves them (the benchmark's hooks on one pipeline instance; nothing
in the package edited): for each sampled request, every UNet call's input
row, its conditioning rows (context, and SDXL's pooled embedding and time
ids) and its two output rows (CFG), at the probe steps the two rows of
each probed UNet block's output, the decoder's input row, and the
perception hooks' outputs for it (the face parser's label map and the face
embedder's embedding, taken in the order prepare calls them, one a row). The
reference then judges each stage on these (reference/stepwise.py).

The sample is drawn from the seed by batch and position: `plan(seed, k,
batches)` spreads k picks over the first `batches` batches the pipeline
runs, the first pick in the back half of its batch, so that a fault in
part of a batch shows. A pick that lands on a padded row takes the request
it repeats."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .inputs import mix


def plan(seed: int, k: int, batches: int) -> Dict[int, List[float]]:
    """{batch number: [fraction of the batch's rows, one a pick]}."""
    rng = np.random.default_rng(mix(seed, 0x5A3))
    out: Dict[int, List[float]] = {}
    for i in range(k):
        frac = 0.5 + 0.5 * rng.random() if i == 0 else rng.random()
        out.setdefault(i % batches, []).append(float(frac))
    return out


class Capture:
    def __init__(self, pipe, picks: Dict[int, List[float]],
                 probes: Sequence[str] = (), probe_steps: Sequence[int] = ()):
        self.picks = picks
        self.probes = tuple(probes)
        self.probe_steps = frozenset(probe_steps)
        self.batches = 0
        self.got: Dict[int, Dict[str, List]] = {}
        self._rows: Dict[int, int] = {}
        for name in ("generate_batch", "generate_batch_async"):
            self._wrap_batch(pipe, name)
        self._calls: Dict[str, list] = {"labels": [], "faceid": []}
        self._wrap_fold(pipe.bundle)
        self._wrap_decode(pipe)
        self._wrap_hook(pipe, "face_parser", "labels")
        self._wrap_hook(pipe, "face_embedder", "faceid")

    def _wrap_hook(self, pipe, name, key):
        inner = getattr(pipe, name)

        def call(image):
            out = inner(image)
            calls = self._calls[key]
            i = len(calls)
            calls.append(out)
            for s, row in self._rows.items():
                if row == i:
                    self.got[s][key] = np.array(out, copy=True)
            return out

        setattr(pipe, name, call)

    def _wrap_batch(self, pipe, name):
        inner = getattr(pipe, name)

        def call(prompts, face_images, *a, seeds=None, **k):
            seeds = [int(s) for s in seeds or []]
            rows = {}
            for frac in self.picks.get(self.batches, []):
                s = seeds[min(int(frac * len(seeds)), len(seeds) - 1)]
                rows[s] = seeds.index(s)
            self.batches += 1
            self._rows = rows
            self._calls = {"labels": [], "faceid": []}
            for s in rows:
                self.got[s] = {"x": [], "ctx": [], "added": [], "eps": [],
                               "probe": {b: {} for b in self.probes},
                               "final": None, "labels": None,
                               "faceid": None}
            return inner(prompts, face_images, *a, seeds=seeds, **k)

        setattr(pipe, name, call)

    def _wrap_fold(self, bundle):
        inner = bundle.infer_unet

        def call(*a, **k):
            unet = inner(*a, **k)
            rows = dict(self._rows)
            if not rows:
                return unet

            def pre(module, args, kwargs):
                x, ctx = args[0], args[2]
                half = x.shape[0] // 2
                added = kwargs.get("added_cond")
                for s, i in rows.items():
                    g = self.got[s]
                    g["x"].append(x[i:i + 1].detach().clone())
                    g["ctx"].append(ctx[[i, half + i]].detach().clone())
                    g["added"].append(None if added is None else {
                        k: v[[i, half + i]].detach().clone()
                        for k, v in added.items()})

            def post(module, args, out):
                half = out.shape[0] // 2
                for s, i in rows.items():
                    self.got[s]["eps"].append(
                        out[[i, half + i]].detach().clone())

            def probe(block):
                def keep(module, args, out):
                    for s, i in rows.items():
                        g = self.got[s]
                        step = len(g["x"]) - 1
                        if step in self.probe_steps:
                            half = out.shape[0] // 2
                            g["probe"][block][step] = (
                                out[[i, half + i]].detach().clone())
                return keep

            unet.register_forward_pre_hook(pre, with_kwargs=True)
            unet.register_forward_hook(post)
            for block in self.probes:
                getattr(unet, block).register_forward_hook(probe(block))
            return unet

        bundle.infer_unet = call

    def _wrap_decode(self, pipe):
        inner = pipe._decode

        def call(final, *a, **k):
            for s, i in self._rows.items():
                self.got[s]["final"] = final[i:i + 1].detach().clone()
            return inner(final, *a, **k)

        pipe._decode = call
