"""HTTP inference server with cross-request microbatching (the JAX
package's apps/serve.py), on the card unless `--device cpu` is given.

One pipeline and a microbatching queue: concurrent requests within a
collection window are stacked, padded to a bucket size {1, 2, 4, ...} and
run through `generate_batch` as one batch. Batches are double-buffered:
while the card runs batch i, batch i + 1 is drained, prepared on the host
and enqueued, and only then is batch i collected (`generate_batch_async`).
`warmup` runs each bucket once so kernel builds and cuDNN/cuBLAS set-up are
done before the first live request.

Security model: no authentication; it trusts its callers. It binds to
127.0.0.1 by default. Requests are capped (--max-body bytes; images at
--max-image-px per side, read from the PNG header before decoding).

API:
  GET  /healthz    -> {"status": "ok", "requests": N, "batches": M}
  POST /generate   JSON {prompt, image_b64 (PNG), negative_prompt?, seed?}
                   -> {image_b64 (PNG), batch_size}
    seed is per request: each request's latents come from its own seed.
    The server samples with DDIM, as the JAX server does, unless
    --scheduler names another sampler. The infer CLI's --seed,
    --num-images, --out and --negative-prompt, and --lora-scale or
    --ip-scale at other than 1.0, exit through the parser.
    --cache-interval N serves every batch with DeepCache (the infer CLI's
    flag, carried by the pipeline's PipelineConfig as in the JAX server).
    --quant int8 serves the W8A8 UNet; --quant int8_static calibrates its
    activation scales at startup, before the warm-up, over every
    --calib-image (max-merged) with --calib-prompt, or reads them from
    --act-scales; --save-act-scales writes the calibration's.

Data and tensor parallelism (the JAX server's --dp/--tp, serve.py:293-359):
`--dp N --tp M` serves over N*M of the visible cards (`--dp 0`: all of
them, trimmed to a multiple of M), one rank each, started by the port's
launcher (parallel/launch.py) unless the process already runs under one;
with one card (or --device cpu) there is no mesh and the server is the
single-device one, as the JAX server is on one chip. The ranks run in
lockstep: rank 0 owns the HTTP server and the MicroBatcher, whose buckets
are multiples of the data size (max_batch rounded up to a full row), and
broadcasts each bucket's call to the other ranks (`LockstepPipeline`),
which make the same pipeline call in the same order (`follow`). A request
rank 0 rejects never reaches them.

    python -m consistentid_torch.apps.serve --base ... --port 8000
    python -m consistentid_torch.apps.serve --base ... --dp 0 --tp 2
"""
from __future__ import annotations

import base64
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from ..utils.png import as_rgb, decode_png, encode_png, png_size

MAX_BODY_BYTES = 16 * 1024 * 1024
MAX_IMAGE_PX = 4096


@dataclass
class _Pending:
    prompt: str
    image: np.ndarray
    negative: str
    seed: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    batch_size: int = 0
    error: Optional[str] = None


def _buckets(max_batch: int) -> List[int]:
    out = [1]
    while out[-1] * 2 <= max_batch:
        out.append(out[-1] * 2)
    if out[-1] != max_batch:
        out.append(max_batch)
    return out


class MicroBatcher:
    """Collects requests for up to `window_ms` (or `max_batch`), pads the
    drained batch to the nearest bucket size, and runs it as one
    generate_batch call on a worker thread.

    When the pipeline carries a mesh with a data axis of D > 1, every
    bucket is a multiple of D ({D, 2D, 4D, ...}, max_batch rounded up to at
    least one full row), so generate_batch always splits it over the data
    group (JAX serve.py:74-96); a model axis replicates the batch and does
    not count."""

    def __init__(self, pipeline, max_batch: int = 4, window_ms: float = 30.0):
        from ..parallel.mesh import data_axis_size

        self.pipeline = pipeline
        self.mesh_size = data_axis_size(getattr(pipeline, "mesh", None))
        if self.mesh_size > 1:
            max_batch = max(max_batch, self.mesh_size)
            max_batch = -(-max_batch // self.mesh_size) * self.mesh_size
            self.buckets = [b * self.mesh_size
                            for b in _buckets(max_batch // self.mesh_size)]
        else:
            self.buckets = _buckets(max_batch)
        self.max_batch = max_batch
        self.window_ms = window_ms
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.requests_served = 0
        self.batches_run = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def warmup(self, image_size: Optional[int] = None) -> None:
        """Run every bucket once (a grey face, the serving config), so no
        live request waits on a kernel build or a library's first call."""
        size = image_size or self.pipeline.config.height
        dummy = np.full((size, size, 3), 127, np.uint8)
        for b in self.buckets:
            self.pipeline.generate_batch(
                ["warmup"] * b, [dummy] * b, negative_prompts=[""] * b,
                seeds=list(range(b)))

    def submit(self, req: _Pending) -> _Pending:
        with self._lock:
            self._queue.append(req)
        self._wake.set()
        return req

    def _drain(self) -> List[_Pending]:
        with self._lock:
            batch = self._queue[: self.max_batch]
            self._queue = self._queue[self.max_batch:]
        return batch

    def _bucket_size(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _submit_batch(self, batch):
        """Enqueue one padded batch; returns a zero-argument resolver that
        collects the images and wakes the waiting requests."""
        n = len(batch)
        padded = batch + [batch[-1]] * (self._bucket_size(n) - n)
        err = None
        try:
            finish = self.pipeline.generate_batch_async(
                [r.prompt for r in padded], [r.image for r in padded],
                negative_prompts=[r.negative for r in padded],
                seeds=[r.seed for r in padded])
        except Exception as e:  # noqa: BLE001
            finish, err = None, str(e)

        def resolve():
            try:
                if finish is None:
                    raise RuntimeError(err)
                images = finish()
                for i, r in enumerate(batch):
                    r.result = images[i]
                    r.batch_size = n
            except Exception as e:  # noqa: BLE001
                for r in batch:
                    r.error = str(e)
            self.batches_run += 1
            self.requests_served += n
            for r in batch:
                r.event.set()

        return resolve

    def _worker(self):
        # one batch in flight and one being prepared: batch i + 1 is
        # drained, prepared and enqueued before batch i is collected
        pending = None
        while not self._stop:
            if pending is None:
                self._wake.wait(timeout=0.1)
            if self._stop:
                break
            time.sleep(self.window_ms / 1000.0)  # let requests pile up
            self._wake.clear()
            batch = self._drain()
            nxt = self._submit_batch(batch) if batch else None
            if pending is not None:
                pending()
            pending = nxt
        if pending is not None:
            pending()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=30)


# --------------------------------------------------------------- lockstep

_LOCKSTEP_CALLS = ("generate_batch", "generate_batch_async")


class LockstepPipeline:
    """Rank 0's view of the pipeline under a mesh: each generate_batch(
    _async) call is first broadcast, (name, args, kwargs), to the other
    ranks over the mesh's control group, then made here. Every other
    attribute is the pipeline's. `stop()` releases the followers."""

    def __init__(self, pipeline, mesh):
        self._pipeline = pipeline
        self._mesh = mesh

    def __getattr__(self, name):
        attr = getattr(self._pipeline, name)
        if name not in _LOCKSTEP_CALLS:
            return attr

        def call(*args, **kwargs):
            from ..parallel.mesh import broadcast_object
            broadcast_object((name, args, kwargs), self._mesh)
            return attr(*args, **kwargs)
        return call

    def stop(self) -> None:
        from ..parallel.mesh import broadcast_object
        broadcast_object(None, self._mesh)


def follow(pipeline, mesh) -> int:
    """A rank other than 0: make every call rank 0 broadcasts, in order,
    until it stops; returns the number of calls. A call that raises here
    raised on rank 0 too (the same inputs); it is reported and the loop
    goes on."""
    from ..parallel.mesh import broadcast_object

    calls = 0
    while True:
        msg = broadcast_object(None, mesh)
        if msg is None:
            return calls
        name, args, kwargs = msg
        if name not in _LOCKSTEP_CALLS:
            raise ValueError(f"lockstep call {name!r} is not a serving call")
        try:
            out = getattr(pipeline, name)(*args, **kwargs)
            if callable(out):
                out()
        except Exception as e:  # noqa: BLE001
            print(f"rank {mesh.rank}: {name} failed: {e}", flush=True)
        calls += 1


def mesh_ranks(dp: int, tp: int, visible: int) -> int:
    """Ranks of `--dp dp --tp tp` over `visible` cards, by the JAX server's
    rules: dp 0 takes every card (trimmed to a multiple of tp), otherwise
    the first dp * tp of them; one rank means no mesh."""
    if dp == 1 and tp == 1:
        return 1
    if dp == 0:
        n = visible - visible % tp if tp > 1 else visible
    else:
        n = min(dp * tp, visible)
    if n > 1 and n % tp:
        raise SystemExit(f"--tp {tp} does not divide the {n} cards taken")
    return max(n, 1)


def _load_image(b64: str, max_px: int = MAX_IMAGE_PX) -> np.ndarray:
    data = base64.b64decode(b64, validate=True)
    w, h = png_size(data)  # from the header, before inflating
    if w > max_px or h > max_px:
        raise ValueError(f"image {w}x{h} exceeds {max_px}px limit")
    return as_rgb(decode_png(data))


def make_handler(batcher: MicroBatcher, max_body: int = MAX_BODY_BYTES,
                 max_image_px: int = MAX_IMAGE_PX):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "requests": batcher.requests_served,
                                 "batches": batcher.batches_run})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body:
                    return self._json(413, {
                        "error": f"body {n} exceeds {max_body} bytes"})
                payload = json.loads(self.rfile.read(n))
                image = _load_image(payload["image_b64"], max_image_px)
                req = _Pending(
                    prompt=payload["prompt"], image=image,
                    negative=payload.get("negative_prompt", ""),
                    seed=int(payload.get("seed", 0)))
            except Exception as e:  # noqa: BLE001
                return self._json(400, {"error": f"bad request: {e}"})
            batcher.submit(req)
            req.event.wait()
            if req.error:
                return self._json(500, {"error": req.error})
            self._json(200, {
                "image_b64": base64.b64encode(
                    encode_png(req.result)).decode(),
                "batch_size": req.batch_size,
            })

    return Handler


def serve(pipeline, port: int = 8000, max_batch: int = 4,
          window_ms: float = 30.0, host: str = "127.0.0.1",
          warmup: bool = False, max_body: int = MAX_BODY_BYTES,
          max_image_px: int = MAX_IMAGE_PX):
    """(server, batcher): call server.serve_forever() (port 0 picks a free
    port: server.server_address); stop with server.shutdown(),
    server.server_close() and batcher.stop()."""
    batcher = MicroBatcher(pipeline, max_batch, window_ms)
    if warmup:
        batcher.warmup()
    server = ThreadingHTTPServer(
        (host, port), make_handler(batcher, max_body, max_image_px))
    return server, batcher


def build_parser():
    """The infer CLI's flags and the server's own; no flag twice."""
    from .infer import build_parser as infer_parser

    p = infer_parser(one_shot=False)
    p.description = __doc__
    # the JAX server samples with PipelineConfig's default (ddim); an
    # explicit --scheduler is honoured here (JAX drops it). The infer
    # flags a request overrides or the server never reads default to None,
    # so main can refuse them when given
    p.set_defaults(scheduler="ddim", seed=None, num_images=None, out=None,
                   negative_prompt=None)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; 0.0.0.0 only behind a real ingress "
                        "(this server has no auth)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--window-ms", type=float, default=30.0)
    p.add_argument("--max-body", type=int, default=MAX_BODY_BYTES)
    p.add_argument("--max-image-px", type=int, default=MAX_IMAGE_PX)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every batch bucket at startup")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel serving over N cards (1: one card, "
                        "0: every visible card): buckets become multiples "
                        "of N and each is split over the ranks")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel UNet over M cards per replica "
                        "(attention and feed-forward split over the ranks); "
                        "composes with --dp: dp*tp cards in all")
    p.add_argument("--calib-image", action="append", default=None,
                   help="--quant int8_static: a representative face "
                        "(.png or .npy) for the startup calibration of the "
                        "activation scales; repeatable, the scales "
                        "max-merged over all of them. Required for "
                        "int8_static unless --act-scales is given")
    p.add_argument("--calib-prompt",
                   default="a photo of a person, portrait, high quality",
                   help="--quant int8_static: the calibration prompt")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    from .infer import check_args, load_pipeline, read_act_scales

    p = build_parser()
    args = p.parse_args(argv)
    if args.sdxl or args.tokenizer_2:
        p.error("the server serves SD1.5 only, as the JAX package's does "
                "(SDXL serving: ROADMAP A5)")
    if args.init_image or args.mask_image:
        p.error("the server serves text to image only; --init-image and "
                "--mask-image are the infer CLI's")
    for flag in ("seed", "num_images", "out", "negative_prompt"):
        if getattr(args, flag) is not None:
            p.error(f"--{flag.replace('_', '-')} is the infer CLI's: a "
                    "request brings its own seed and negative prompt, and "
                    "gets one image back")
    for flag in ("lora_scale", "ip_scale"):
        if getattr(args, flag) != 1.0:
            p.error(f"--{flag.replace('_', '-')} is the infer CLI's: the "
                    "server serves, and calibrates int8_static, at 1.0")
    check_args(p, args)
    if args.quant == "int8_static" and not (args.calib_image
                                            or args.act_scales):
        p.error("--quant int8_static requires --calib-image (activation "
                "scales are calibrated at startup) or --act-scales (a "
                "saved calibration artifact)")
    if args.calib_image and (args.quant != "int8_static"
                             or args.act_scales):
        p.error("--calib-image calibrates --quant int8_static when no "
                "--act-scales is given")
    act_scales = read_act_scales(p, args)
    visible = 1
    if args.device.startswith("cuda"):
        import torch
        visible = torch.cuda.device_count()
    ranks = mesh_ranks(args.dp, args.tp, visible)
    if ranks > 1:
        import os

        from ..parallel import launch
        if "WORLD_SIZE" in os.environ:
            return _serve_rank(args, act_scales)
        launch(_serve_rank, ranks, args, act_scales, device_type="cuda")
        return
    print("serving on one device (no mesh)")
    _serve(args, load_pipeline(args), act_scales)


def _serve_rank(args, act_scales) -> None:
    """One rank of a mesh server: rank 0 serves HTTP, the others follow."""
    from ..parallel import initialize_multihost, make_mesh
    from .infer import load_pipeline

    initialize_multihost()
    mesh = make_mesh(model=args.tp, device_type="cuda")
    print(f"rank {mesh.rank}: {mesh.describe()}", flush=True)
    pipe = load_pipeline(args, mesh)
    if not mesh.is_main:
        if args.quant == "int8_static":
            pipe = _int8_static(args, pipe, act_scales)
        follow(pipe, mesh)
        return
    lockstep = LockstepPipeline(pipe, mesh)
    try:
        _serve(args, pipe, act_scales, lockstep)
    finally:
        lockstep.stop()


def _int8_static(args, pipe, act_scales):
    from ..utils.png import read_image
    from .infer import to_int8_static

    if act_scales is None:
        print("calibrating int8 activation scales on "
              f"{', '.join(args.calib_image)}")
    return to_int8_static(
        pipe, act_scales,
        [(args.calib_prompt, read_image(im)) for im in
         args.calib_image or ()],
        args.save_act_scales)


def _serve(args, pipe, act_scales, lockstep=None) -> None:
    """Calibrate (int8_static), warm up and serve until interrupted; with
    `lockstep` (rank 0 of a mesh) the batcher calls go through it."""
    if args.quant == "int8_static":
        pipe = _int8_static(args, pipe, act_scales)
    if lockstep is not None:
        lockstep._pipeline = pipe
        pipe = lockstep
    server, batcher = serve(pipe, args.port, args.max_batch, args.window_ms,
                            host=args.host, max_body=args.max_body,
                            max_image_px=args.max_image_px)
    if not args.no_warmup:
        print(f"warming up buckets {batcher.buckets} ...")
        batcher.warmup(image_size=args.height)
    print(f"serving on {args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.stop()


if __name__ == "__main__":
    main()
