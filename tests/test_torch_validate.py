"""The port's checkpoint validation (`apps.validate`) and evaluation sweep
(`apps.eval_sweep`) CLIs against the JAX package's, on the CPU: both
packages' `validate_file` give the same report on the set the port's
`synthesize` writes (held to the JAX package's set in
test_torch_loading.py), entry by entry, and both turn `ok` false on an
added key, a zeroed kernel or a NaN; the CLIs run every stage and mode on
it; `synthesize_protocol` writes JAX's pixels and CSV. Reports and files
are held exactly."""
import csv
import json
import os

import numpy as np
import pytest
from PIL import Image

from consistentid_tpu.apps import eval_sweep as jax_eval_sweep
from consistentid_tpu.apps import validate as jax_validate
from consistentid_tpu.core import cache as jax_cache
from consistentid_tpu.io.convert_backbones import \
    clip_vision_from_hf as jax_clip_vision_from_hf
from consistentid_tpu.pipelines import SD15Bundle as JaxSD15Bundle
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_torch.apps import eval_sweep, validate
from consistentid_torch.io.convert_backbones import clip_vision_from_hf
from consistentid_torch.io.from_jax import tree_from_module
from consistentid_torch.io.safetensors_reader import (read_checkpoint,
                                                      write_safetensors)
from consistentid_torch.pipelines import loading
from consistentid_torch.testing import tiny_bundle
from consistentid_torch.utils.png import decode_png
from test_torch_loading import one_torch_thread  # noqa: F401

STAGES = ["unet", "vae", "text_encoder", "sdxl_unet", "sdxl_vae",
          "sdxl_text_encoder", "sdxl_text_encoder_2", "image_encoder",
          "consistentid", "bisenet", "arcface", "scrfd", "arcface_onnx",
          "safety_checker"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return validate.synthesize(str(tmp_path_factory.mktemp("port_synth")))


def _file_args(paths):
    return ["--base", paths["base"], "--sdxl-base", paths["sdxl_base"],
            "--consistentid", paths["consistentid"],
            "--image-encoder", paths["image_encoder"],
            "--bisenet", paths["bisenet"], "--arcface", paths["arcface"],
            "--scrfd", paths["scrfd"], "--arcface-onnx", paths["arcface_onnx"],
            "--safety-checker", paths["safety_checker"], "--tiny",
            "--skip-generate"]


@pytest.fixture(scope="module")
def reports(synth, tmp_path_factory):
    """Both CLIs' stage-1 reports on the port's set. The JAX ConsistentID
    stage merges the checkpoint into its bundle's init tree; it is given
    the port tiny bundle's tree in place of a JAX init (untraced, so
    seconds cheaper), and the JAX CLI's compilation cache stays off. That
    tree has the JAX init's leaves, paths, shapes and dtypes: test_torch_
    loading.py's test_tiny_tree_shapes_equal_jax_init_tree holds it."""
    out = tmp_path_factory.mktemp("reports")
    port_path, jax_path = str(out / "port.json"), str(out / "jax.json")
    assert validate.main(_file_args(synth) + [
        "--device", "cpu", "--out", port_path]) == 0
    tree = tree_from_module(tiny_bundle(device="cpu"))[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cache, "enable_compilation_cache", lambda: None)
        mp.setattr(JaxSD15Bundle, "init_params", lambda self, key: tree)
        assert jax_validate.main(_file_args(synth) + ["--out",
                                                      jax_path]) == 0
    with open(port_path) as f, open(jax_path) as g:
        return json.load(f), json.load(g)


@pytest.mark.parametrize("name", STAGES)
def test_validate_report_equals_jax(reports, name):
    """Source keys, unconsumed keys, leaves, parameters, non-finite leaves,
    zero kernels and ok, all equal and all ok."""
    port, jax_report = reports
    assert set(port["files"]) == set(STAGES)
    assert port["files"][name] == jax_report["files"][name]
    assert port["files"][name]["ok"] and port["ok"]


@pytest.mark.parametrize("fault", ["added_key", "zeroed_kernel", "nan"])
def test_validate_file_catches_faults_as_jax(synth, tmp_path, fault):
    sd = read_checkpoint(synth["image_encoder"])
    if fault == "added_key":
        sd["vision_model.extra_layer.weight"] = np.ones((2, 2), np.float32)
    elif fault == "zeroed_kernel":
        key = "vision_model.encoder.layers.0.mlp.fc1.weight"
        sd[key] = np.zeros_like(sd[key])
    else:
        key = "vision_model.encoder.layers.1.self_attn.v_proj.weight"
        sd[key] = sd[key].copy()
        sd[key][3, 1] = np.nan
    path = str(tmp_path / "image_encoder.safetensors")
    write_safetensors(path, sd)
    vision = tiny_bundle(device="cpu").vision_config
    got = validate.validate_file(
        path, lambda s: clip_vision_from_hf(s, vision),
        ignore_unconsumed=("position_ids",))
    want = jax_validate.validate_file(
        path, lambda s: jax_clip_vision_from_hf(
            s, jax_tiny_bundle().vision_config),
        ignore_unconsumed=("position_ids",))
    assert got == want and not got["ok"]
    assert {"added_key": got["unconsumed_source_keys"],
            "zeroed_kernel": got["zero_kernels"],
            "nan": got["nonfinite"]}[fault]


def test_validate_cli_runs_every_stage_and_mode(tmp_path, monkeypatch):
    """--synthesize DIR --tiny --device cpu --sweep 2 --mode-sweep 2: every
    converter, the three pipelines, FaceSim and CLIP-T, the sweep and the
    seven serving modes of SD1.5 and SDXL in the report. The pipelines'
    face hooks are the eval CLI's fixed label map and pixel embedder: the
    loaded BiSeNet and SCRFD + ArcFace run about a second a request here,
    and the loader tests hold them."""
    labels = np.zeros((64, 64), np.uint8)
    labels[16:48, 16:48] = 1
    labels[20:28, 20:30] = 4
    labels[34:42, 26:40] = 10
    monkeypatch.setattr(loading, "load_face_stack", lambda *a, **kw: (
        lambda img: labels,
        lambda img: np.asarray(img, np.float32).reshape(1, -1)[:, :16]
        / 255.0))
    out = str(tmp_path / "report.json")
    assert validate.main([
        "--synthesize", str(tmp_path / "set"), "--tiny", "--device", "cpu",
        "--sweep", "2", "--mode-sweep", "2", "--height", "32", "--width",
        "32", "--steps", "2", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["ok"] and set(report["files"]) == set(STAGES)
    assert set(report["pipelines"]) == {"sd15", "inpaint", "sdxl"}
    assert all(p["ok"] and p["shape"] == [32, 32, 3]
               for p in report["pipelines"].values())
    metrics = report["metrics"]
    assert {"face_sim", "clip_t", "sweep", "sweep_rows", "mode_sweep",
            "mode_sweep_xl"} <= set(metrics)
    assert metrics["sweep_rows"] == 2
    for key, scores in (("mode_sweep", {"face_sim", "clip_t"}),
                        ("mode_sweep_xl", {"face_sim"})):
        assert list(metrics[key]) == [m for m, _, _ in
                                      validate.SERVING_MODES]
        for mode, rec in metrics[key].items():
            assert rec["img_per_min"] > 0 and scores <= set(rec), mode


def test_eval_sweep_cli_and_protocol(tmp_path):
    """synthesize_protocol writes JAX's faces (pixels) and CSV; the tiny
    CLI on 4 of its rows writes its summary."""
    ours = eval_sweep.synthesize_protocol(str(tmp_path / "port"))
    theirs = jax_eval_sweep.synthesize_protocol(str(tmp_path / "jax"))
    with open(ours) as f, open(theirs) as g:
        rows = list(csv.reader(f))
        assert rows == list(csv.reader(g)) and len(rows) == 1 + 15 * 45
    for name in sorted({r[0] for r in rows[1:]}):
        with open(tmp_path / "port" / name, "rb") as f:
            np.testing.assert_array_equal(
                decode_png(f.read()),
                np.asarray(Image.open(tmp_path / "jax" / name)))
    out = tmp_path / "sweep"
    assert eval_sweep.main(["--tiny", "--synthesize-protocol", "--limit",
                            "4", "--device", "cpu", "--output-dir",
                            str(out)]) == 0
    with open(out / "sweep_summary_shard0.json") as f:
        summary = json.load(f)
    assert summary["rows_total"] == summary["rows_this_shard"] == 4
    assert summary["batch_size"] == 4 and summary["rows_per_min"] > 0
    assert {"mean_latency_s", "mean_face_sim"} <= set(summary)
    assert len([n for n in os.listdir(out) if n.endswith(".png")]) == 4
