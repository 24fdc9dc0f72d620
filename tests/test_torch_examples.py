"""The PyTorch twins of the examples (examples/*_demo_torch.py) end to end
on the CPU at their tiny sizes, each run in-process through runpy with
`--device cpu --steps 2`: the PNG each writes has the pipeline's shape,
the minimal twin's training step has a finite loss, and the inpaint
twin's --image route parses the photo with --bisenet, which it requires
(the JAX example's --image route loads no face parser and cannot run)."""
import json
import os
import runpy
import sys

import numpy as np
import pytest

from consistentid_torch.apps import validate
from consistentid_torch.utils.png import encode_png, read_image
from test_torch_loading import one_torch_thread  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _run(script, argv, tmp_path):
    """Run the twin as `python examples/<script> --device cpu --steps 2
    <argv> --out <png>`; the decoded PNG."""
    out = str(tmp_path / "out.png")
    old = sys.argv
    sys.argv = [script, "--device", "cpu", "--steps", "2", *argv,
                "--out", out]
    try:
        runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    finally:
        sys.argv = old
    return read_image(out)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return validate.synthesize(str(tmp_path_factory.mktemp("synth")))


def test_minimal_twin_generates_and_trains(tmp_path, capsys):
    img = _run("minimal_demo_torch.py", [], tmp_path)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    line, = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("train step: ")]
    metrics = json.loads(line[len("train step: "):])
    assert np.isfinite(metrics["loss"]) and metrics["loss"] > 0


def test_controlnet_twin_inpaints(tmp_path):
    img = _run("controlnet_demo_torch.py", [], tmp_path)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert img.std() > 1.0


def _set_args(synth):
    return ["--base", synth["base"], "--consistentid", synth["consistentid"],
            "--image-encoder", synth["image_encoder"]]


def _image_files(tmp_path):
    rng = np.random.default_rng(3)
    files = {}
    for name, arr in (
            ("image", rng.integers(0, 255, (80, 72, 3), np.uint8)),
            ("init-image", rng.integers(0, 255, (64, 64, 3), np.uint8)),
            ("mask-image", np.pad(np.full((32, 32), 255, np.uint8), 16))):
        files[name] = str(tmp_path / f"{name}.png")
        with open(files[name], "wb") as f:
            f.write(encode_png(arr))
    return [x for name, path in files.items() for x in (f"--{name}", path)]


@pytest.mark.parametrize("route", ["synthetic", "image"])
def test_inpaint_twin_routes(synth, tmp_path, route):
    """The synthetic route (injected parsing map, zero embedding) and the
    --image route (the photo parsed by the set's BiSeNet, embedded by its
    SCRFD and ArcFace) on the synthesized set."""
    argv = _set_args(synth)
    if route == "image":
        argv += ["--bisenet", synth["bisenet"], "--arcface",
                 synth["arcface"], "--scrfd", synth["scrfd"],
                 *_image_files(tmp_path)]
    img = _run("inpaint_demo_torch.py", argv, tmp_path)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert img.std() > 1.0


@pytest.mark.parametrize("drop, named", [
    ("--bisenet", "--bisenet"), ("--mask-image", "--mask-image"),
    ("--image", "--init-image")])
def test_inpaint_twin_refuses_an_incomplete_image_route(synth, tmp_path,
                                                        capsys, drop, named):
    """--image needs --bisenet, --init-image and --mask-image; and those
    two need --image. Refused through the parser, before any load."""
    argv = ["--bisenet", synth["bisenet"], *_image_files(tmp_path)]
    i = argv.index(drop)
    del argv[i:i + 2]
    with pytest.raises(SystemExit) as e:
        _run("inpaint_demo_torch.py", argv, tmp_path)
    assert e.value.code == 2
    assert named in capsys.readouterr().err
