"""The port's eval package (styles, the sweep CSV and runner, FaceSim,
CLIP-T, the PhotoMaker baseline encoder) and its augmentations against the
JAX package's, on the CPU at tiny sizes: parameters drawn with numpy in
the JAX modules' shapes and carried across with `params_from_jax`; each
JAX reference jitted once.

Tolerances: styles, CSV rows, sweep records (but their latency), written
pixels and augmentations exactly; face_similarity 1e-7 (both fp32 numpy);
FaceSim over the tiny iresnet, CLIP-T and the PhotoMaker fused embeds 1e-5
(fp32 networks, XLA's and torch's CPU kernels summing in other orders)."""
import csv
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu import eval as jax_eval
from consistentid_tpu.core import CLIPVisionConfig as JaxVisionConfig
from consistentid_tpu.eval import baselines as jax_baselines
from consistentid_tpu.models import arcface as jax_arcface
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_tpu.utils import augment as jax_augment
from consistentid_torch import eval as port_eval
from consistentid_torch.conditioning import SimpleTokenizer
from consistentid_torch.core import CLIPVisionConfig
from consistentid_torch.eval import baselines
from consistentid_torch.io import params_from_jax, state_from_jax
from consistentid_torch.models import arcface
from consistentid_torch.testing import tiny_bundle
from consistentid_torch.utils import augment
from consistentid_torch.utils.png import decode_png
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_perception import (IRESNET_TINY, TINY_VISION,
                                   draw_variables)
from test_torch_sdxl import _draw_params

# the reference's evaluation CSV (evaluation/EvaluationIMGs_stars_prompts.csv
# of its checkout), where the environment names one
REFERENCE_CSV = os.environ.get("CONSISTENTID_REFERENCE_CSV", "")


# ------------------------------------------------------------------ styles

def test_styles_equal_jax():
    assert port_eval.STYLES == jax_eval.STYLES
    assert port_eval.DEFAULT_STYLE == jax_eval.DEFAULT_STYLE
    for name in [*jax_eval.STYLES, "no such style"]:
        for negative in ("", "ugly, blurry"):
            assert port_eval.apply_style(name, "a man in a hat", negative) \
                == jax_eval.apply_style(name, "a man in a hat", negative)


@pytest.mark.parametrize("styles", [None, ["Cinematic", "(No style)"]])
def test_load_sweep_csv_equals_jax(tmp_path, styles):
    path = tmp_path / "sweep.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image_Name", "Prompt"])
        w.writerows([["a.png", "a man, smiling"], ["b.png", 'a "woman"'],
                     ["c.png", "a child"]])
    got = port_eval.load_sweep_csv(str(path), styles=styles)
    want = jax_eval.load_sweep_csv(str(path), styles=styles)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert len(got) == 3 * len(styles or [None])


def test_reference_sweep_csv_equals_jax():
    if not os.path.isfile(REFERENCE_CSV):
        pytest.skip("reference csv absent (CONSISTENTID_REFERENCE_CSV)")
    got = port_eval.load_sweep_csv(REFERENCE_CSV)
    assert len(got) == 675  # 15 identities x 45 prompts
    assert [vars(r) for r in got] == [
        vars(r) for r in jax_eval.load_sweep_csv(REFERENCE_CSV)]


# ----------------------------------------------------------------- metrics

def test_face_similarity_equals_jax():
    rng = np.random.RandomState(0)
    pairs = [(rng.randn(1, 512), rng.randn(1, 512)),
             (rng.randn(1, 16).astype(np.float32), rng.randn(16)),
             (np.ones((1, 8)), -np.ones((1, 8))),
             (np.zeros((1, 8)), rng.randn(1, 8))]
    for a, b in pairs:
        np.testing.assert_allclose(port_eval.face_similarity(a, b),
                                   jax_eval.face_similarity(a, b),
                                   rtol=0, atol=1e-7)


def test_face_sim_scorer_matches_jax():
    """FaceSimScorer over the tiny iresnet embedder (center crop), the JAX
    one on PIL images, the port's on arrays."""
    model = jax_arcface.IResNet(**IRESNET_TINY)
    variables = draw_variables(model, (1, 32, 32, 3), 5)
    jax_embed = jax_arcface.make_face_embedder(
        variables["params"], variables["batch_stats"],
        allow_center_crop=True)
    port_embed = arcface.make_face_embedder(
        state_from_jax(variables, flatten_nhwc={"fc": 512}),
        allow_center_crop=True, device="cpu")
    rng = np.random.RandomState(6)
    ref = rng.randint(0, 255, (48, 40, 3), np.uint8)
    for gen in (rng.randint(0, 255, (64, 64, 3), np.uint8),
                np.clip(ref.astype(int) + rng.randint(-20, 20, ref.shape),
                        0, 255).astype(np.uint8)):
        got = port_eval.FaceSimScorer(port_embed)(ref, gen)
        want = jax_eval.FaceSimScorer(jax_embed)(Image.fromarray(ref),
                                                 Image.fromarray(gen))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def clip_towers():
    """The JAX tiny bundle's text and vision towers on numpy parameters,
    and the port's tiny bundle holding the same."""
    jbundle = jax_tiny_bundle()
    params = {
        "text_encoder": _draw_params(jax.eval_shape(
            jbundle.text_encoder.init, jax.random.PRNGKey(0),
            jnp.zeros((1, 77), jnp.int32))["params"], 7),
        "image_encoder": _draw_params(jax.eval_shape(
            jbundle.image_encoder.init, jax.random.PRNGKey(0),
            jnp.zeros((1, 28, 28, 3)))["params"], 8)}
    pbundle = tiny_bundle(device="cpu")
    for name, tree in params.items():
        getattr(pbundle, name).load_state_dict(params_from_jax(tree),
                                               strict=True)
    return jbundle, params, pbundle


@pytest.mark.parametrize("projections", ["both", "visual_only"])
def test_clip_t_scorer_matches_jax(clip_towers, projections):
    """With both projection heads (into 16 dims), and with the vision one
    alone (into the text tower's 64): pooled EOS text output against the
    post-layernorm CLS, L2-normalised, dotted."""
    jbundle, params, pbundle = clip_towers
    rng = np.random.RandomState(1)
    width = 16 if projections == "both" else 64
    tp = (rng.randn(64, width).astype(np.float32) if projections == "both"
          else None)
    vp = rng.randn(32, width).astype(np.float32)
    jax_scorer = jax_eval.CLIPTScorer(jbundle, params, SimpleTokenizer(),
                                      text_projection=tp,
                                      visual_projection=vp)
    port_scorer = port_eval.CLIPTScorer(pbundle, SimpleTokenizer(),
                                        text_projection=tp,
                                        visual_projection=vp)
    img = np.random.RandomState(0).randint(0, 255, (64, 48, 3), np.uint8)
    for prompt in ("a man with a face", "a red hat " * 40):
        got = port_scorer(prompt, img)
        want = jax_scorer(prompt, Image.fromarray(img))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert -1.0 <= got <= 1.0


def test_clip_t_scorer_refuses_unshared_widths(clip_towers):
    jbundle, params, pbundle = clip_towers
    with pytest.raises(ValueError, match="shared embedding space"):
        jax_eval.CLIPTScorer(jbundle, params, SimpleTokenizer())
    with pytest.raises(ValueError, match="shared embedding space"):
        port_eval.CLIPTScorer(pbundle, SimpleTokenizer())


def test_photomaker_id_encoder_matches_jax():
    """The tiny vision tower through both projections (8 + 8), fused at the
    trigger positions; padded slots point at indices no valid slot uses
    (the port scatters valid slots only)."""
    jax_model = jax_baselines.PhotoMakerIDEncoder(
        vision_config=JaxVisionConfig(**TINY_VISION), projection_dim=8,
        projection_dim_2=8)
    rng = np.random.RandomState(2)
    pixels = rng.randn(2, 3, 28, 28, 3).astype(np.float32)
    prompt = rng.randn(2, 12, 16).astype(np.float32)
    idx = np.array([[2, 5, 9], [1, 3, 0]], np.int32)
    mask = np.array([[True, True, True], [True, True, False]])
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), pixels,
                            prompt, idx, mask)
    params = _draw_params(shapes["params"], 9)
    want = jax.jit(jax_model.apply)({"params": params}, pixels, prompt, idx,
                                    mask)
    port = baselines.PhotoMakerIDEncoder(CLIPVisionConfig(**TINY_VISION),
                                         projection_dim=8,
                                         projection_dim_2=8)
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (pixels, prompt, idx,
                                                   mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert baselines.photomaker_vision_config() == CLIPVisionConfig(
        **vars(jax_baselines.photomaker_vision_config()))


# ----------------------------------------------------------------- augment

@pytest.mark.parametrize("seed", range(4))
def test_augment_bit_equal_to_jax(seed):
    """Each augmentation and the composed transform, from RandomStates in
    one state: the same draws and PIL's BILINEAR bits."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(8, 90, 2)
    img = rng.randint(0, 255, (h, w, 3), np.uint8)
    np.testing.assert_array_equal(augment.pad_to_square(img, fill=seed),
                                  jax_augment.pad_to_square(img, fill=seed))
    for name, kw in (("random_flip", {}), ("random_zoom_in", {}),
                     ("random_zoom_out", {"fill": 7})):
        for _ in range(3):
            got = getattr(augment, name)(img, np.random.RandomState(seed),
                                         **kw)
            want = getattr(jax_augment, name)(
                img, np.random.RandomState(seed), **kw)
            np.testing.assert_array_equal(got, want, err_msg=name)
            seed += 100
    for flag in (True, False):
        port_rng, jax_rng = (np.random.RandomState(seed) for _ in range(2))
        for _ in range(3):
            np.testing.assert_array_equal(
                augment.object_transforms(img, port_rng, size=40,
                                          augment=flag),
                jax_augment.object_transforms(img, jax_rng, size=40,
                                              augment=flag))


# ------------------------------------------------------------------ runner

class StubPipe:
    """Images drawn from each row's prompt and seed, the same in both
    packages (the JAX runner hands it PIL faces, the port's arrays)."""

    @staticmethod
    def _image(prompt, face, seed):
        rng = np.random.RandomState([seed, len(prompt), sum(map(ord,
                                                               prompt))])
        img = rng.randint(0, 255, (16, 12, 3), np.uint8)
        img[0, 0] = np.asarray(face)[0, 0]
        return img

    def generate(self, prompt, face, negative_prompt="", seed=0, **kw):
        assert kw == {"cache_interval": 2}
        return self._image(prompt + negative_prompt, face, seed)[None]

    def generate_batch(self, prompts, faces, negative_prompts=None, seed=0,
                       **kw):
        assert kw == {"cache_interval": 2}
        return np.stack([self._image(p + n, f, seed)
                         for p, f, n in zip(prompts, faces,
                                            negative_prompts)])


def _face_score(ref, gen):
    return float(np.asarray(ref, np.float32).mean()
                 - np.asarray(gen, np.float32).mean())


def _clip_score(prompt, image):
    return float(len(prompt) / (1.0 + np.asarray(image, np.float32).std()))


@pytest.mark.parametrize("batch_size, num_shards", [(1, 1), (3, 1), (2, 3)])
def test_run_sweep_rows_equal_jax(tmp_path, batch_size, num_shards):
    """The same records but latency_s, shard by shard; the shards partition
    the rows; the written PNGs decode to the same pixels as JAX's."""
    root = tmp_path / "ids"
    root.mkdir()
    for i in range(2):
        Image.fromarray(np.random.RandomState(i).randint(
            0, 255, (20, 24, 3), np.uint8)).save(root / f"id{i}.png")
    rows = [port_eval.SweepRow(f"id{i % 2}.png", f"a person, pose {i}",
                               style=list(port_eval.STYLES)[i % 3])
            for i in range(7)]
    jax_rows = [jax_eval.SweepRow(**vars(r)) for r in rows]
    seen = []
    for shard in range(num_shards):
        kw = dict(face_sim_scorer=_face_score, clip_t_scorer=_clip_score,
                  seed=11, shard_index=shard, num_shards=num_shards,
                  batch_size=batch_size, cache_interval=2)
        outs = [tmp_path / f"port{shard}", tmp_path / f"jax{shard}"]
        got = port_eval.run_sweep(StubPipe(), rows, str(root),
                                  output_dir=str(outs[0]), **kw)
        want = jax_eval.run_sweep(StubPipe(), jax_rows, str(root),
                                  output_dir=str(outs[1]), **kw)

        def strip(recs):
            return [{k: v for k, v in r.items() if k != "latency_s"}
                    for r in recs]
        assert strip(got.rows) == strip(want.rows)
        assert set(got.summary()) == set(want.summary())
        seen += [r["prompt"] for r in got.rows]
        names = sorted(os.listdir(outs[1]))
        assert sorted(os.listdir(outs[0])) == names
        assert f"results_shard{shard}.json" in names
        for name in names:
            if name.endswith(".png"):
                with open(outs[0] / name, "rb") as f:
                    np.testing.assert_array_equal(
                        decode_png(f.read()),
                        np.asarray(Image.open(outs[1] / name)))
    assert sorted(seen) == sorted(r.prompt for r in rows)
