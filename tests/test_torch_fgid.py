"""The port's FGID dataset production (apps/fgid.py), its captioner adapters
(conditioning/captioner.py) and its binding of the native loader
(io/native_loader.py) against the JAX package's, on the CPU: a tree of 3
PNG faces of different shapes, BiSeNet at full width and a tiny ArcFace
iresnet with seeded random weights written as reference-layout files that
both packages read, each stage run by both.

Tolerances: mask labels equal on at least 99.9% of pixels (fp32 argmax;
a near-tie may flip); the resized PNGs, the JSON stubs and fields, the
fused manifest and the loader's batches exactly; FaceID embeddings 1e-5
(both fp32, XLA's and torch's CPU kernels summing in other orders)."""
import base64
import http.server
import json
import os
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from consistentid_tpu.apps import fgid as jax_fgid
from consistentid_tpu.conditioning import captioner as jax_captioner
from consistentid_tpu.io import native_loader as jax_native
from consistentid_torch.apps import fgid
from consistentid_torch.conditioning import SimpleTokenizer, captioner
from consistentid_torch.io import export_backbones as exp
from consistentid_torch.io import native_loader
from consistentid_torch.io.from_jax import tree_from_module
from consistentid_torch.models.arcface import IResNet
from consistentid_torch.models.bisenet import BiSeNet
from consistentid_torch.testing import (PERCEPTION_LABEL_AGREEMENT,
                                        randomize_perception_module)
from consistentid_torch.training import FGIDDataset
from consistentid_torch.utils.image import IMAGENET_MEAN, IMAGENET_STD
from consistentid_torch.utils.png import decode_png, encode_png
from test_torch_loading import one_torch_thread  # noqa: F401

SIZE = 64                    # the mask stage's parse size here
IRESNET = dict(layers=(1, 1, 1, 1), embedding_dim=32, input_size=32)
SHAPES = [(70, 60), (64, 64), (50, 80)]


def _faces():
    rng = np.random.default_rng(7)
    out = []
    for h, w in SHAPES:
        base = rng.integers(40, 200, (1, 1, 3))
        out.append(np.clip(base + rng.integers(-50, 50, (h, w, 3)), 0,
                           255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The PNG tree, face_parsing.pth (BiSeNet, 19 classes) and arcface.pt
    (a tiny iresnet), from seeded port modules through the exporters."""
    root = tmp_path_factory.mktemp("fgid")
    images = root / "images"
    images.mkdir()
    for i, face in enumerate(_faces()):
        (images / f"face{i}.png").write_bytes(encode_png(face))
    gen = torch.Generator().manual_seed(0)
    parser = BiSeNet()
    embedder = IResNet(**IRESNET)
    with torch.no_grad():
        randomize_perception_module(parser, gen)
        randomize_perception_module(embedder, gen)
    as_torch = lambda sd: {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}
    torch.save(as_torch(exp.bisenet_to_torch(*tree_from_module(parser))),
               root / "face_parsing.pth")
    params, stats = tree_from_module(embedder, flatten_nhwc={"fc": 512})
    torch.save(as_torch(exp.iresnet_to_torch(params, stats,
                                             layers=IRESNET["layers"],
                                             spatial=2)),
               root / "arcface.pt")
    return root


FAKE_WORKER = textwrap.dedent("""
    import json, sys, os
    for line in sys.stdin:
        req = json.loads(line)
        prompt = req["prompt"]
        if "image_path" in req:
            tag = os.path.basename(req["image_path"])
        else:
            tag = f"b64:{len(req['image_b64'])}"
        kind = "detail" if "facial features" in prompt else "caption"
        print(json.dumps({"text": f"{kind} of {tag}"}), flush=True)
""")


@pytest.fixture(scope="module")
def worker_cmd(files):
    script = files / "fake_vlm.py"
    script.write_text(FAKE_WORKER)
    return [sys.executable, str(script)]


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX binding's library built from the same source into a
    temporary directory: its own default is native/, where the JAX
    package's tests build it at the same time."""
    so = tmp_path_factory.mktemp("jax_native") / "libfgid_loader.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SO", str(so))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "HAS_NATIVE", None)
        assert jax_native.get_lib() is not None
        yield


@pytest.fixture(scope="module")
def produced(files, worker_cmd, jax_native_lib):
    """Each stage through JAX's run_* and through the port's CLI (main, on
    the CPU), into two output trees."""
    images, outs = str(files / "images"), {}
    for side in ("jax", "port"):
        outs[side] = out = str(files / side)
        if side == "jax":
            jax_fgid.run_mask(images, out, str(files / "face_parsing.pth"),
                              batch_size=2, size=SIZE)
            with jax_captioner.SubprocessCaptioner(worker_cmd) as cap:
                jax_fgid.run_caption(images, out, cap)
            jax_fgid.run_faceid(images, out, str(files / "arcface.pt"),
                                batch_size=2)
            jax_fgid.run_fuse(out)
            continue
        fgid.run_mask(images, out, str(files / "face_parsing.pth"),
                      batch_size=2, size=SIZE, device="cpu")
        cmd = " ".join(worker_cmd)
        assert fgid.main(["caption", "--images", images, "--out", out,
                          "--captioner-cmd", cmd, "--device", "cpu"]) == 0
        assert fgid.main(["faceid", "--images", images, "--out", out,
                          "--arcface", str(files / "arcface.pt"),
                          "--batch-size", "2", "--device", "cpu"]) == 0
        assert fgid.main(["fuse", "--out", out]) == 0
    return outs


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def test_mask_stage_matches_jax(produced):
    stems = [f"face{i}" for i in range(len(SHAPES))]
    agree = total = 0
    for stem in stems:
        got = {d: _png(os.path.join(produced["port"], d, f"{stem}.png"))
               for d in ("resize", "mask", "color")}
        want = {d: np.asarray(Image.open(os.path.join(
            produced["jax"], d, f"{stem}.png"))) for d in got}
        np.testing.assert_array_equal(got["resize"], want["resize"])
        assert got["mask"].shape == (SIZE, SIZE, 1)   # one grey channel
        got["mask"] = got["mask"][..., 0]
        assert want["mask"].shape == (SIZE, SIZE)
        same = got["mask"] == want["mask"]
        agree += int(same.sum())
        total += same.size
        np.testing.assert_array_equal(got["color"][same], want["color"][same])
    assert agree >= PERCEPTION_LABEL_AGREEMENT * total, (agree, total)


def _manifest(out):
    with open(os.path.join(out, "JSON_all.json")) as f:
        return json.load(f)


def test_json_stubs_and_manifest_equal_jax(produced):
    for name in sorted(os.listdir(os.path.join(produced["jax"], "json"))):
        with open(os.path.join(produced["jax"], "json", name)) as f:
            want = json.load(f)
        with open(os.path.join(produced["port"], "json", name)) as f:
            assert json.load(f) == want
    want = _manifest(produced["jax"])
    assert _manifest(produced["port"]) == want
    assert sorted(want) == [f"face{i}" for i in range(len(SHAPES))]
    assert want["face0"]["vqa_llva"] == "caption of face0.png"


def test_faceid_stage_matches_jax(produced):
    for i in range(len(SHAPES)):
        paths = [os.path.join(produced[s], "faceid", f"face{i}.bin")
                 for s in ("port", "jax")]
        assert os.path.getsize(paths[0]) == os.path.getsize(paths[1]) == \
            4 * IRESNET["embedding_dim"]
        got, want = (np.fromfile(p, np.float32) for p in paths)
        np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-6)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_fgid_dataset_reads_the_fused_manifest(produced):
    out = produced["port"]
    ds = FGIDDataset(os.path.join(out, "JSON_all.json"), SimpleTokenizer(),
                     size=SIZE, clip_size=28, image_root=out,
                     id_dim=IRESNET["embedding_dim"])
    assert len(ds) == len(SHAPES)
    ex = ds[0]
    assert ex["images"].shape[:2] == (SIZE, SIZE)
    want = np.fromfile(os.path.join(out, "faceid", "face0.bin"), np.float32)
    np.testing.assert_array_equal(ex["faceid_embeds"].reshape(-1), want)


# ----------------------------------------------------------- decode routes

@pytest.fixture(scope="module")
def mixed_tree(tmp_path_factory):
    """PNG and JPEG faces (JPEG written with PIL)."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(5):
        arr = rng.integers(0, 256, (40 + 3 * i, 52 - 2 * i, 3),
                           dtype=np.uint8)
        p = root / f"im{i}.{'jpg' if i % 2 else 'png'}"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("center_crop", [False, True])
def test_native_batches_equal_jax(mixed_tree, center_crop, jax_native_lib):
    assert native_loader.get_lib() is not None, native_loader.BUILD_ERROR
    assert jax_native.get_lib() is not None
    assert native_loader.LIBRARY.startswith(native_loader.BUILD_DIR)
    kw = dict(mean=(0.5, 0.4, 0.3), std=(0.2, 0.3, 0.4),
              center_crop=center_crop)
    got = list(native_loader.NativeImageLoader(mixed_tree, 24, 20, 2, **kw))
    want = list(jax_native.NativeImageLoader(mixed_tree, 24, 20, 2, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.start == w.start
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.ok, w.ok)
    one = native_loader.decode_resize_normalize(mixed_tree[1], 24, 20, **kw)
    np.testing.assert_array_equal(one, got[0].images[1])


@pytest.mark.parametrize("center_crop", [False, True])
def test_numpy_route_equals_jax_pil_route(mixed_tree, center_crop,
                                          monkeypatch, capsys):
    """Without the native library both fall back: the port's numpy route
    on the PNGs is JAX's PIL route bit for bit; the JPEGs, which only PIL
    decodes, are skipped (ok False) with their reason."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(native_loader, "get_lib", lambda: None)
    mean = tuple(IMAGENET_MEAN.reshape(-1))
    std = tuple(IMAGENET_STD.reshape(-1))
    got = list(fgid._decoded_batches(mixed_tree, 32, 28, 2, mean, std,
                                     center_crop=center_crop))
    want = list(jax_fgid._decoded_batches(mixed_tree, 32, 28, 2, mean, std,
                                          center_crop=center_crop))
    printed = capsys.readouterr().out
    assert "decode route: numpy" in printed and "JPEG" in printed
    for (gc, gb, gok), (wc, wb, wok) in zip(got, want):
        assert gc == wc
        for i, path in enumerate(gc):
            if path.endswith(".png"):
                assert gok[i] and wok[i]
                np.testing.assert_array_equal(gb[i], wb[i])
            else:
                assert wok[i] and not gok[i]


def test_native_build_failure_is_reported(monkeypatch, tmp_path):
    """A build that fails leaves the numpy route and the compiler's last
    error line; nothing is written beside the source."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", str(src))
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native_loader, "LIBRARY",
                        str(tmp_path / "b" / "lib.so"))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "HAS_NATIVE", None)
    assert native_loader.get_lib() is None
    assert "error" in native_loader.BUILD_ERROR
    assert native_loader.route().startswith("numpy")
    assert os.listdir(tmp_path / "b") == []


# -------------------------------------------------------- captioner adapters

def test_template_and_vlm_captioners_equal_jax():
    for side in (jax_captioner, captioner):
        assert side.TemplateCaptioner()("x.png") == \
            jax_captioner.TemplateCaptioner()("x.png")

    class Echo:
        def generate(self, image, prompt):
            return f"{image}|{prompt[:9]}"

    assert captioner.VLMCaptioner(Echo())("a.png") == \
        jax_captioner.VLMCaptioner(Echo())("a.png")
    assert captioner.CAPTION_PROMPT == jax_captioner.CAPTION_PROMPT
    assert captioner.DETAIL_PROMPT == jax_captioner.DETAIL_PROMPT
    assert captioner.LLAVA_SYSTEM == jax_captioner.LLAVA_SYSTEM
    assert captioner.llava_v1_prompt_parts("q") == \
        jax_captioner.llava_v1_prompt_parts("q")


def test_subprocess_captioner_protocol(worker_cmd, tmp_path):
    face = _faces()[1]
    with captioner.SubprocessCaptioner(worker_cmd) as cap:
        assert cap("/data/img_001.jpg") == ("caption of img_001.jpg",
                                            "detail of img_001.jpg")
        caption, _ = cap(face)
    png = encode_png(face)
    assert caption == f"caption of b64:{len(base64.b64encode(png))}"
    script = tmp_path / "dies.py"
    script.write_text("import sys; sys.exit(3)")
    dead = captioner.SubprocessCaptioner([sys.executable, str(script)])
    with pytest.raises(RuntimeError, match="died"):
        dead("/x.png")


def test_http_captioner_sends_jax_requests():
    bodies = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            bodies.append(body)
            req = json.loads(body)
            out = json.dumps({"text": req["prompt"][:8]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}/caption"
        got = captioner.HTTPCaptioner(url)("/faces/a.png")
        want = jax_captioner.HTTPCaptioner(url)("/faces/a.png")
        face = _faces()[0]
        pair = captioner.HTTPCaptioner(url)(face)
    finally:
        server.shutdown()
        server.server_close()
    assert got == want == ("Please d", "Describe")
    assert bodies[0] == bodies[2] and bodies[1] == bodies[3]
    sent = json.loads(bodies[4])
    assert pair == ("Please d", "Describe")
    assert decode_png(base64.b64decode(sent["image_b64"])).tolist() == \
        face.tolist()


def test_make_captioner_and_tp_refusal(worker_cmd, files):
    assert isinstance(captioner.make_captioner(),
                      captioner.TemplateCaptioner)
    assert isinstance(captioner.make_captioner(url="http://127.0.0.1:9/x"),
                      captioner.HTTPCaptioner)
    with captioner.make_captioner(" ".join(worker_cmd)) as cap:
        assert isinstance(cap, captioner.SubprocessCaptioner)
    # --tp splits the in-repo LLaVA only (JAX's make_captioner): without
    # one the template comes back, and the CLI refuses the flag
    assert isinstance(captioner.make_captioner(tp=2),
                      captioner.TemplateCaptioner)
    with pytest.raises(SystemExit) as e:
        fgid.main(["caption", "--images", str(files / "images"), "--out",
                   str(files / "tp"), "--tp", "2", "--device", "cpu"])
    assert e.value.code == 2
