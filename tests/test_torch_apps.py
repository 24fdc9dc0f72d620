"""The port's entry points on the CPU: the `infer` CLI and the `serve` HTTP
server on reference-layout checkpoints (tiny configs, written by the JAX
package's `apps.validate.synthesize`, see test_torch_loading.py), and the
PNG codec that stands in for PIL (PIL is the oracle here)."""
import base64
import io
import json
import os
import struct
import threading
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from consistentid_torch.apps import infer, serve
from consistentid_torch.utils.png import (decode_png, encode_png, png_size,
                                          read_image)
from test_torch_loading import fast_synthesize, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return fast_synthesize(str(tmp_path_factory.mktemp("synth")))


def _face(seed=0, shape=(96, 80, 3)):
    return np.random.default_rng(seed).integers(0, 255, shape, np.uint8)


def _args(synth, *extra):
    root = os.path.dirname(synth["base"])
    return ["--base", synth["base"],
            "--consistentid", synth["consistentid"],
            "--image-encoder", synth["image_encoder"],
            "--bisenet", synth["bisenet"],
            "--arcface", os.path.join(root, "arcface.onnx"),
            "--scrfd", synth["scrfd"],
            "--tiny", "--device", "cpu", "--steps", "2",
            "--height", "64", "--width", "48", *extra]


# ------------------------------------------------------------------ infer

def test_infer_cli_writes_decodable_pngs(synth, tmp_path):
    face = tmp_path / "face.png"
    Image.fromarray(_face()).save(face)
    out = str(tmp_path / "out.png")
    pipe = infer.main(_args(synth, "--image", str(face), "--prompt",
                            "a photo of a man", "--out", out,
                            "--num-images", "2", "--scheduler", "dpmpp_2m"))
    assert pipe.safety_checker is not None
    for name in (str(tmp_path / "out_0.png"), str(tmp_path / "out_1.png")):
        with open(name, "rb") as f:
            data = f.read()
        img = decode_png(data)
        assert img.shape == (64, 48, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(np.asarray(Image.open(name)), img)
        assert png_size(data) == (48, 64)


def test_infer_cli_reads_npy_face(synth, tmp_path):
    face = tmp_path / "face.npy"
    np.save(face, _face(1))
    out = str(tmp_path / "one.png")
    infer.main(_args(synth, "--image", str(face), "--prompt", "a woman",
                     "--out", out, "--no-safety-checker"))
    assert read_image(out).shape == (64, 48, 3)


@pytest.mark.parametrize("flags, reason", [
    (["--mask-image", "x.png"], "--mask-image requires --init-image"),
    (["--init-image", "x.png", "--strength", "1.5"],
     "--strength must be in (0, 1]"),
    (["--init-image", "x.png", "--num-images", "2"],
     "--num-images > 1 is text-to-image only"),
    (["--init-image", "x.png", "--quant", "int8_static"],
     "calibrates/serves the t2i path only"),
    (["--quant", "int8_static", "--act-scales", "FOREIGN"],
     "is not an act-scales artifact"),
    (["--quant", "int8", "--act-scales", "s.npz"],
     "--act-scales applies to --quant int8_static only"),
    (["--quant", "int8_static", "--act-scales", "s.npz",
      "--save-act-scales", "t.npz"], "with --act-scales nothing is"),
    (["--init-image", "x.png", "--cache-interval", "2"],
     "--cache-interval applies to the text-to-image path only")])
def test_unported_flags_exit_with_not_ported_yet(flags, reason, capsys,
                                                 tmp_path):
    """The JAX CLI's argument errors (mask without init, strength out of
    (0, 1], several images, DeepCache or int8_static from an init image),
    an --act-scales file without the artifact's marker (FOREIGN: a plain
    .npz), and scale flags that would do nothing, which the JAX CLI
    ignores: exit 2 with the reason, before anything is loaded."""
    foreign = str(tmp_path / "foreign.npz")
    np.savez(foreign, w=np.ones(3, np.float32))
    flags = [foreign if f == "FOREIGN" else f for f in flags]
    with pytest.raises(SystemExit) as exc:
        infer.main(["--base", "b", "--image", "f.png", "--prompt", "p",
                    *flags])
    assert exc.value.code == 2
    assert reason in capsys.readouterr().err


def test_infer_cli_runs_int8(synth, tmp_path):
    """--quant int8 loads the pipeline with the W8A8 UNet and writes an
    image."""
    face = tmp_path / "face.png"
    Image.fromarray(_face()).save(face)
    out = str(tmp_path / "int8.png")
    pipe = infer.main(_args(synth, "--image", str(face), "--prompt",
                            "a woman", "--out", out, "--quant", "int8",
                            "--no-safety-checker"))
    assert pipe.bundle.quant == "int8"
    assert read_image(out).shape == (64, 48, 3)


def test_infer_cli_saves_and_reuses_act_scales(synth, tmp_path):
    """--quant int8_static calibrates on the request's prompt and face and
    --save-act-scales writes the scales (the JAX package reads the file);
    a second run given them with --act-scales serves the same PNG bytes
    without calibrating."""
    from consistentid_tpu.io.quant_scales import load_act_scales
    face = tmp_path / "face.png"
    Image.fromarray(_face()).save(face)
    scales = str(tmp_path / "scales.npz")
    pngs = []
    for i, flags in enumerate((["--save-act-scales", scales],
                               ["--act-scales", scales])):
        out = str(tmp_path / f"static_{i}.png")
        pipe = infer.main(_args(synth, "--image", str(face), "--prompt",
                                "a man", "--out", out, "--quant",
                                "int8_static", "--no-safety-checker",
                                *flags))
        assert pipe.bundle.quant == "int8_static"
        with open(out, "rb") as f:
            pngs.append(f.read())
    assert pngs[0] == pngs[1]
    tree = load_act_scales(scales)
    assert tree["down_0_resnet_0"]["conv1"]["act_scale"] > 0


@pytest.mark.parametrize("mode", ["img2img", "inpaint"])
def test_infer_cli_edits_an_init_image(synth, tmp_path, mode):
    """--init-image (a PNG of another size) loads the img2img pipeline, with
    --mask-image (a grey PNG, white regenerates) the inpainting one, through
    load_sd15_consistentid(pipeline_cls=...)."""
    face, init, mask = (tmp_path / n for n in ("face.png", "init.png",
                                               "mask.png"))
    Image.fromarray(_face()).save(face)
    Image.fromarray(_face(2, (40, 56, 3))).save(init)
    m = np.zeros((64, 48), np.uint8)
    m[16:48, 12:36] = 255
    Image.fromarray(m).save(mask)
    out = str(tmp_path / "edit.png")
    flags = ["--init-image", str(init), "--strength", "0.5"]
    if mode == "inpaint":
        flags += ["--mask-image", str(mask), "--strength", "1.0"]
    pipe = infer.main(_args(synth, "--image", str(face), "--prompt",
                            "a photo of a man", "--out", out,
                            "--no-safety-checker", *flags))
    assert type(pipe).__name__ == {
        "img2img": "ConsistentIDImg2ImgPipeline",
        "inpaint": "ConsistentIDInpaintPipeline"}[mode]
    assert read_image(out).shape == (64, 48, 3)


def test_infer_cli_runs_deepcache(synth, tmp_path):
    face = tmp_path / "face.png"
    Image.fromarray(_face()).save(face)
    out = str(tmp_path / "cached.png")
    pipe = infer.main(_args(synth, "--image", str(face), "--prompt",
                            "a woman", "--out", out, "--steps", "4",
                            "--cache-interval", "3", "--no-safety-checker"))
    assert pipe.config.cache_interval == 3
    assert read_image(out).shape == (64, 48, 3)


def test_loader_refuses_the_controlnet_pipeline():
    """As the JAX loader: no file here holds a ControlNet."""
    from consistentid_torch.pipelines import \
        ConsistentIDControlNetInpaintPipeline
    from consistentid_torch.pipelines.loading import load_sd15_consistentid
    with pytest.raises(ValueError, match="ControlNet"):
        load_sd15_consistentid(
            "unused", pipeline_cls=ConsistentIDControlNetInpaintPipeline,
            device="cpu")


def test_serve_parser_defines_each_flag_once(capsys):
    """The JAX serve adds --act-scales and --save-act-scales a second time
    over infer's parser (argparse raises); the port's adds none of
    infer's flags again, and its requests bring --image and --prompt.
    int8_static without --calib-image or --act-scales exits through the
    parser's error, as the JAX server means to."""
    p = serve.build_parser()
    flags = [s for a in p._actions for s in a.option_strings]
    assert len(flags) == len(set(flags))
    args = p.parse_args(["--base", "b", "--port", "0", "--max-batch", "2"])
    assert args.port == 0 and args.max_batch == 2 and args.image is None
    assert args.calib_image is None and args.act_scales is None
    with pytest.raises(SystemExit) as exc:
        serve.main(["--base", "b", "--quant", "int8_static"])
    assert exc.value.code == 2
    assert "requires --calib-image" in capsys.readouterr().err


def test_serve_cli_calibrates_int8_static(synth, tmp_path, monkeypatch):
    """serve --quant int8_static --calib-image A --calib-image B calibrates
    over both faces (max-merged) before serving and --save-act-scales
    writes the scales; the served pipeline is static int8 (serve_forever
    returns at once here)."""
    from consistentid_torch.ops.quant import merge_act_scales
    faces = []
    for i in range(2):
        faces.append(str(tmp_path / f"calib{i}.png"))
        Image.fromarray(_face(i + 3)).save(faces[-1])
    scales = str(tmp_path / "served.npz")
    served = {}
    real_serve = serve.serve

    def spy(pipe, *a, **kw):
        served["pipe"] = pipe
        return real_serve(pipe, *a, **kw)

    monkeypatch.setattr(serve, "serve", spy)
    monkeypatch.setattr(serve.ThreadingHTTPServer, "serve_forever",
                        lambda self: None)
    serve.main(_args(synth, "--quant", "int8_static", "--calib-image",
                     faces[0], "--calib-image", faces[1], "--calib-prompt",
                     "a face", "--save-act-scales", scales, "--no-warmup",
                     "--port", "0", "--no-safety-checker"))
    pipe = served["pipe"]
    assert pipe.bundle.quant == "int8_static"
    singles = [pipe.calibrate_int8(samples=[("a face", read_image(f))])
               .bundle.act_scales for f in faces]
    merged = merge_act_scales(singles)
    got = pipe.bundle.act_scales
    for key in ("down_0_resnet_0", "mid_resnet_1"):
        for conv in ("conv1", "conv2"):
            assert float(got[key][conv]["act_scale"]) == float(
                merged[key][conv]["act_scale"])
    assert os.path.getsize(scales) > 0


def test_serve_parser_takes_cache_interval(capsys):
    """--cache-interval reaches the server's pipeline through its
    PipelineConfig (infer.load_pipeline); an init image is the infer CLI's
    alone."""
    args = serve.build_parser().parse_args(["--base", "b",
                                            "--cache-interval", "3"])
    assert args.cache_interval == 3
    with pytest.raises(SystemExit):
        serve.main(["--base", "b", "--init-image", "x.png"])
    assert "text to image only" in capsys.readouterr().err


# ------------------------------------------------------------------ serve

@pytest.fixture(scope="module")
def server(synth):
    args = infer.build_parser(one_shot=False).parse_args(
        _args(synth, "--no-safety-checker"))
    pipe = infer.load_pipeline(args)
    srv, batcher = serve.serve(pipe, port=0, max_batch=4, window_ms=400,
                               max_body=300_000, max_image_px=128)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", batcher
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()


def _post(url, payload: bytes):
    req = urllib.request.Request(url + "/generate", data=payload,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _request(seed, face_seed, prompt="a photo of a man"):
    return json.dumps({"prompt": prompt, "seed": seed, "image_b64":
                       base64.b64encode(encode_png(
                           _face(face_seed, (64, 64, 3)))).decode()}
                      ).encode()


def test_server_batches_requests_with_their_own_seeds(server):
    """3 concurrent requests run as one batch (padded to the bucket of 4);
    a request sent alone gives its batched image again (decoded uint8,
    within one grey level: fp32 matmuls of another batch size)."""
    url, batcher = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        before = json.loads(r.read())
    with ThreadPoolExecutor(3) as pool:
        replies = list(pool.map(lambda i: _post(url, _request(10 + i, i)),
                                range(3)))
    images = []
    for code, body in replies:
        assert code == 200, body
        assert body["batch_size"] == 3
        images.append(decode_png(base64.b64decode(body["image_b64"])))
        assert images[-1].shape == (64, 48, 3)
    code, body = _post(url, _request(11, 1))
    assert code == 200 and body["batch_size"] == 1
    solo = decode_png(base64.b64decode(body["image_b64"]))
    assert np.abs(solo.astype(int) - images[1]).max() <= 1
    assert not np.array_equal(images[0], images[1])
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["requests"] - before["requests"] == 4
    assert health["batches"] - before["batches"] == 2


def test_server_refuses_bad_requests(server):
    url, _ = server
    code, body = _post(url, b"{not json")
    assert code == 400 and "bad request" in body["error"]
    big = json.dumps({"prompt": "x", "image_b64": base64.b64encode(
        encode_png(_face(0, (200, 64, 3)))).decode()}).encode()
    code, body = _post(url, big)
    assert code == 400 and "exceeds 128px" in body["error"]
    code, body = _post(url, _request(0, 0, prompt="x" * 400_000))
    assert code == 413


# -------------------------------------------------------------------- png

@pytest.mark.parametrize("mode, shape", [
    ("L", (33, 17)), ("LA", (20, 31, 2)), ("RGB", (31, 45, 3)),
    ("RGBA", (16, 9, 4))])
def test_png_decodes_what_pil_writes(mode, shape):
    """PIL picks its own row filters, so these cover the adaptive mix."""
    rng = np.random.default_rng(len(shape) + shape[0])
    smooth = (np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
              % 256).astype(np.uint8)
    arr = rng.integers(0, 255, shape, np.uint8)
    arr[: shape[0] // 2] = (smooth[..., None] if len(shape) == 3
                            else smooth)[: shape[0] // 2]
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    got = decode_png(buf.getvalue())
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)


@pytest.mark.parametrize("shape", [(7, 5), (12, 9, 3), (4, 21, 4)])
def test_png_roundtrip_read_by_pil(shape):
    arr = np.random.default_rng(3).integers(0, 255, shape, np.uint8)
    data = encode_png(arr)
    np.testing.assert_array_equal(decode_png(data).reshape(shape), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  arr)


def _filtered_png(arr: np.ndarray, ftype: int) -> bytes:
    """A PNG whose every row uses filter `ftype` (the spec's filters)."""
    h, w, c = arr.shape
    raw = arr.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decodes_each_filter_type(ftype):
    arr = np.random.default_rng(ftype).integers(0, 255, (9, 11, 3),
                                                np.uint8)
    data = _filtered_png(arr, ftype)
    np.testing.assert_array_equal(decode_png(data), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  arr)


def test_png_refuses_what_it_cannot_decode():
    buf = io.BytesIO()
    Image.fromarray(_face(0, (8, 8, 3))).convert("P").save(buf, "PNG")
    with pytest.raises(ValueError, match="palette"):
        decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth"):
        decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_face(0, (8, 8, 3))).save(buf, "JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(buf.getvalue())
    data = bytearray(encode_png(_face(0, (4, 4, 3))))
    data[28] = 1            # the IHDR's interlace byte
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a....")
