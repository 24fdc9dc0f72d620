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


@pytest.mark.parametrize("flags, item", [
    (["--init-image", "x.png"], "A6"), (["--mask-image", "x.png"], "A6"),
    (["--strength", "0.5"], "A6"), (["--quant", "int8"], "A9"),
    (["--quant", "int8_static"], "A9"), (["--act-scales", "s.npz"], "A9"),
    (["--save-act-scales", "s.npz"], "A9"),
    (["--cache-interval", "2"], "A8")])
def test_unported_flags_exit_with_not_ported_yet(flags, item, capsys):
    with pytest.raises(SystemExit) as exc:
        infer.main(["--base", "b", "--image", "f.png", "--prompt", "p",
                    *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP {item}" in err


def test_serve_parser_defines_each_flag_once():
    """The JAX serve adds --act-scales and --save-act-scales a second time
    over infer's parser (argparse raises); the port's adds none of
    infer's flags again, and its requests bring --image and --prompt."""
    p = serve.build_parser()
    flags = [s for a in p._actions for s in a.option_strings]
    assert len(flags) == len(set(flags))
    args = p.parse_args(["--base", "b", "--port", "0", "--max-batch", "2"])
    assert args.port == 0 and args.max_batch == 2 and args.image is None
    with pytest.raises(SystemExit):
        serve.main(["--base", "b", "--quant", "int8_static"])


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
