"""The perception frontend of the port (BiSeNet, ArcFace's IResNet, SCRFD,
the detection post-processing, the safety checker and the image
preparations) against the JAX package on the CPU, fp32, at tiny sizes.

Parameters are drawn with numpy in the JAX modules' shapes (from
`jax.eval_shape`, so no JAX forward runs to make them), with BatchNorm
statistics perturbed (mean N(0, 0.3^2), var U(0.5, 1.5)), and carried into
the port by `state_from_jax`. Each JAX network runs once, jitted, per
module fixture; so does JAX's `detect_and_align`, on its own (the jitted
`make_face_detector` graph, network and post-processing together, takes
tens of seconds to compile on a CPU and is never built).

Tolerances: whole networks 1e-4 of the output's largest magnitude
(`assert_close_scaled`: XLA's and torch's CPU convolutions sum in other
orders, compounded over up to 20 layers of He-scaled random weights);
single fp32 steps 1e-5 or tighter; the keep mask of the NMS, label
maps and flags exactly; the image preparations exactly (the port's
BILINEAR resize is PIL's fixed-point resample, as the JAX package's PIL
call).
"""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.core import CLIPVisionConfig as JaxVisionConfig
from consistentid_tpu.models import arcface as jax_arcface
from consistentid_tpu.models import bisenet as jax_bisenet
from consistentid_tpu.models import detection as jax_det
from consistentid_tpu.models import safety_checker as jax_safety
from consistentid_tpu.models import scrfd as jax_scrfd
from consistentid_tpu.utils import image as jax_image
from consistentid_torch.core import CLIPVisionConfig
from consistentid_torch.io import state_from_jax
from consistentid_torch.models import arcface, bisenet, detection, scrfd
from consistentid_torch.models import safety_checker
from consistentid_torch.utils import image as port_image
from test_torch_loading import one_torch_thread  # noqa: F401

TINY_VISION = dict(image_size=28, patch_size=14, hidden_size=32,
                   intermediate_size=64, num_layers=2, num_heads=2)
IRESNET_TINY = dict(layers=(1, 1, 1, 1), embedding_dim=32, input_size=32)


def draw_variables(model, x_shape, seed):
    """Numpy variables in the shapes of `model.init` (no forward run)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_in = int(np.prod(x.shape[:-1]))
            gain = 2.0 if len(x.shape) == 4 else 1.0
            return rng.standard_normal(x.shape, np.float32) * np.sqrt(
                gain / fan_in, dtype=np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "'mean'" in name:
            return 0.3 * rng.standard_normal(x.shape, np.float32)
        if "alpha" in name:
            return 0.25 + 0.05 * rng.standard_normal(x.shape, np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * rng.standard_normal(x.shape, np.float32)
        return 0.1 * rng.standard_normal(x.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def assert_close_scaled(got, want, tol=1e-4, err_msg=""):
    """max |got - want| <= tol * max(max |want|, 1)."""
    want = np.asarray(want)
    bound = tol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound,
                               err_msg=err_msg)


def load_port(module, variables, **kw):
    module.load_state_dict(state_from_jax(variables, **kw), strict=True)
    return module.eval()


# ------------------------------------------------------------------ BiSeNet

@pytest.fixture(scope="module")
def bisenet_run():
    model = jax_bisenet.BiSeNet()
    variables = draw_variables(model, (1, 64, 64, 3), 0)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    return variables, x, [np.asarray(w) for w in want]


def test_bisenet_matches_jax(bisenet_run):
    variables, x, want = bisenet_run
    port = load_port(bisenet.BiSeNet(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 64, 64, 19)
        assert_close_scaled(g.numpy(), w)


def test_resize_bilinear_align_corners_matches_jax():
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    for size in ((9, 13), (3, 4)):
        want = jax.jit(jax_bisenet.resize_bilinear_align_corners,
                       static_argnums=1)(jnp.asarray(x), size)
        got = bisenet.resize_bilinear_align_corners(
            torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


# ------------------------------------------------------------------ ArcFace

def test_iresnet_matches_jax():
    """The fc kernel, flattened NHWC in JAX, is permuted to the port's NCHW
    flatten by state_from_jax."""
    model = jax_arcface.IResNet(**IRESNET_TINY)
    variables = draw_variables(model, (1, 32, 32, 3), 1)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = load_port(arcface.IResNet(**IRESNET_TINY), variables,
                     flatten_nhwc={"fc": 512})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close_scaled(got.numpy(), want)
    np.testing.assert_allclose(
        arcface.normalized_embedding(got).numpy(),
        np.asarray(jax_arcface.normalized_embedding(jnp.asarray(want))),
        rtol=0, atol=1e-6)
    assert arcface.iresnet_arch_from_params(port.state_dict()) == \
        jax_arcface.iresnet_arch_from_params(variables["params"])


def test_face_embedder_behaviour():
    """As tests/test_scrfd.py: no detector and no opt-in is an error; a
    detected face gives JAX's unit-norm embedding, a score <= 0 the zero
    embedding; the center-crop opt-in gives a unit-norm embedding."""
    model = jax_arcface.IResNet(**IRESNET_TINY)
    variables = draw_variables(model, (1, 32, 32, 3), 1)
    state = state_from_jax(variables, flatten_nhwc={"fc": 512})
    with pytest.raises(ValueError):
        arcface.make_face_embedder(state, device="cpu")
    face = np.random.RandomState(3).randint(0, 255, (48, 40, 3), np.uint8)
    scores = iter([0.9, 0.0, 0.9])

    def fake_detector(image):
        return np.asarray(image)[4:36, 4:36].astype(np.float32), \
            next(scores), np.zeros(4)

    embed = arcface.make_face_embedder(state, detector=fake_detector,
                                       device="cpu")
    got = embed(face)
    assert got.shape == (1, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(embed(face), np.zeros((1, 32), np.float32))
    want = jax_arcface.make_face_embedder(
        variables["params"], variables["batch_stats"],
        detector=fake_detector)(Image.fromarray(face))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-5)
    crop = arcface.make_face_embedder(state, allow_center_crop=True,
                                      device="cpu")(face)
    np.testing.assert_allclose(np.linalg.norm(crop), 1.0, atol=1e-5)


# -------------------------------------------------------- SCRFD + detection

# JAX's post-processing alone, jitted: one small compile, where running it
# op by op compiles every op on first use, several times slower; the whole
# make_face_detector graph, the network with it, is never built
jax_detect_and_align = jax.jit(jax_det.detect_and_align, static_argnums=2)

@pytest.fixture(scope="module")
def scrfd_run():
    cfg = jax_scrfd.SCRFD_VARIANTS["tiny"]
    model = jax_scrfd.SCRFD(cfg)
    variables = draw_variables(model, (1, 64, 64, 3), 2)
    apply = jax.jit(lambda x: model.apply(variables, x))
    x = np.random.RandomState(4).randn(1, 64, 64, 3).astype(np.float32)
    port = load_port(scrfd.SCRFD(scrfd.SCRFD_VARIANTS["tiny"]), variables)
    return variables, apply, port, x


def test_scrfd_head_outputs_match_jax(scrfd_run):
    _, apply, port, x = scrfd_run
    want = apply(jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want) == {8, 16, 32}
    for stride in want:
        for name in ("scores", "bbox", "kps"):
            w = np.asarray(want[stride][name])
            assert got[stride][name].shape == w.shape
            assert_close_scaled(got[stride][name].numpy(), w,
                                err_msg=f"{stride} {name}")


def test_scrfd_groupnorm_unshared_head_matches_jax():
    """The configuration branches no shipped variant takes: GroupNorm, one
    head tower per stride and a separate box tower."""
    kw = dict(norm="gn", strides_share=False, cls_reg_share=False)
    model = jax_scrfd.SCRFD(dataclasses.replace(
        jax_scrfd.SCRFD_VARIANTS["tiny"], **kw))
    variables = draw_variables(model, (1, 64, 64, 3), 7)
    x = np.random.RandomState(12).randn(1, 64, 64, 3).astype(np.float32)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = load_port(scrfd.SCRFD(dataclasses.replace(
        scrfd.SCRFD_VARIANTS["tiny"], **kw)), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for stride in want:
        for name in ("scores", "bbox", "kps"):
            assert_close_scaled(got[stride][name].numpy(),
                                want[stride][name], err_msg=f"{stride} {name}")


def test_decode_level_matches_jax():
    rng = np.random.RandomState(5)
    h, w, stride = 3, 5, 16
    n = h * w * 2
    s, b, k = (rng.randn(*shape).astype(np.float32)
               for shape in ((n,), (n, 4), (n, 10)))
    want = jax.jit(jax_det.decode_level, static_argnums=(3, 4, 5))(
        jnp.asarray(s), jnp.asarray(b), jnp.asarray(k), stride, h, w)
    got = detection.decode_level(torch.from_numpy(s), torch.from_numpy(b),
                                 torch.from_numpy(k), stride, h, w)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=0,
                                   atol=1e-6)


def test_topk_nms_keep_is_exact_with_ties():
    """Scores quantized to 0.05 (many ties, broken by index), clusters of
    boxes that overlap, and pairs whose IoU is exactly the threshold (not
    suppressed): slots, scores, boxes, keypoints and keep mask exactly."""
    rng = np.random.RandomState(6)
    n = 300
    scores = np.round(rng.uniform(0.3, 1.0, n) * 20) / 20
    centers = rng.uniform(0, 60, (n, 2)).round()
    sizes = rng.choice([4.0, 10.0], (n, 2))
    boxes = np.concatenate([centers, centers + sizes], 1)
    # IoU(10x10, 10x4 inside it) = 40 / 100 = the threshold 0.4 exactly
    boxes[1] = [0, 0, 10, 10]
    boxes[2] = [0, 0, 10, 4]
    scores[1], scores[2] = 0.95, 0.9
    boxes = boxes.astype(np.float32)
    scores = scores.astype(np.float32)
    kps = rng.randn(n, 5, 2).astype(np.float32)
    want = jax_det.topk_nms(jnp.asarray(scores), jnp.asarray(boxes),
                            jnp.asarray(kps), top_k=128)
    got = detection.topk_nms(torch.from_numpy(scores),
                             torch.from_numpy(boxes), torch.from_numpy(kps),
                             top_k=128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[3].numpy()
    assert 0 < keep.sum() < (got[0].numpy() >= 0.5).sum()
    assert len(set(scores[:128].tolist())) < 128   # ties among the top 128


def _keypoints():
    """ArcFace's template scaled to 40 px, rotated by 20 degrees, moved and
    jittered: a face in a 64 x 64 image."""
    rng = np.random.RandomState(7)
    a = np.deg2rad(20.0)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    pts = detection.ARCFACE_DST / 112 * 40 @ rot.T + [12.0, 8.0]
    return (pts + rng.randn(5, 2) * 0.5).astype(np.float32)


def test_similarity_and_warp_match_jax():
    """The (2, 3) matrix (not u or vt: the SVD's signs may differ) within
    fp32 SVD noise; the warped pixels, in [0, 255], within 1e-2."""
    kp = _keypoints()
    dst = detection.ARCFACE_DST
    want_m = np.array(jax.jit(jax_det.estimate_similarity)(
        jnp.asarray(kp), jnp.asarray(dst)))
    got_m = detection.estimate_similarity(torch.from_numpy(kp),
                                          torch.from_numpy(dst)).numpy()
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-4)
    image = np.random.RandomState(8).uniform(0, 255, (64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jax_det.warp_affine, static_argnums=(2, 3))(
        jnp.asarray(image), jnp.asarray(want_m), 40, 36))
    got = detection.warp_affine(torch.from_numpy(image),
                                torch.from_numpy(want_m), 40, 36).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    want = np.asarray(jax.jit(jax_det.align_face)(jnp.asarray(image),
                                                  jnp.asarray(kp)))
    got = detection.align_face(torch.from_numpy(image),
                               torch.from_numpy(kp)).numpy()
    assert got.shape == (112, 112, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_detect_and_align_matches_jax(scrfd_run):
    """The tiny SCRFD's head outputs at 64 px through flatten_level_outputs
    and detect_and_align: the same chosen slot, its score and box, and the
    aligned crop."""
    _, apply, port, x = scrfd_run
    want_levels = jax_scrfd.flatten_level_outputs(apply(jnp.asarray(x)))
    with torch.no_grad():
        levels = scrfd.flatten_level_outputs(port(torch.from_numpy(x)))
    for stride, (s, b, k) in levels.items():
        for g, w in zip((s, b, k), want_levels[stride]):
            assert_close_scaled(g.numpy(), w)
    want = jax_detect_and_align(want_levels, jnp.asarray(x[0]), (64, 64))
    got = detection.detect_and_align(levels, torch.from_numpy(x[0]),
                                     (64, 64))
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)


def test_face_detector_on_prepared_input(scrfd_run):
    """make_face_detector (letterbox, SCRFD, decode, NMS, align, back to
    [0, 255]) against JAX's own steps on the port's letterboxed array."""
    variables, apply, port, _ = scrfd_run
    image = np.random.RandomState(9).randint(0, 255, (48, 40, 3), np.uint8)
    detect = scrfd.make_face_detector(port.state_dict(),
                                      scrfd.SCRFD_VARIANTS["tiny"],
                                      input_size=64, device="cpu")
    aligned, score, box = detect(image)
    x, scale = port_image.detector_letterbox(image, 64)
    w_aligned, w_score, w_box = jax_detect_and_align(
        jax_scrfd.flatten_level_outputs(apply(jnp.asarray(x))),
        jnp.asarray(x[0]), (64, 64))
    assert aligned.shape == (112, 112, 3) and box.shape == (4,)
    np.testing.assert_allclose(score, float(w_score), rtol=0, atol=1e-5)
    np.testing.assert_allclose(box, np.asarray(w_box) / scale, rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(aligned, np.asarray(w_aligned) * 128 + 127.5,
                               rtol=0, atol=0.2)


# ------------------------------------------------------------ preparations

def test_image_preparations_within_one_grey_level():
    """The BiSeNet input, the detector's letterbox and the embedder's
    bilinear resize against the JAX package's PIL steps: equal, now that
    the port's BILINEAR is PIL's fixed-point resample."""
    img = np.random.RandomState(10).randint(0, 255, (80, 60, 3), np.uint8)
    np.testing.assert_array_equal(
        port_image.imagenet_preprocess(img, 64),
        jax_image.imagenet_preprocess(Image.fromarray(img), 64))
    x, scale = port_image.detector_letterbox(img, 64)
    # the JAX package's letterbox (models/scrfd.py make_face_detector)
    nw, nh = int(round(60 * scale)), int(round(80 * scale))
    canvas = np.zeros((64, 64, 3), np.float32)
    canvas[:nh, :nw] = np.asarray(Image.fromarray(img).resize(
        (nw, nh), Image.BILINEAR), np.float32)
    assert x.shape == (1, 64, 64, 3) and scale == 64 / 80
    np.testing.assert_array_equal(x[0], (canvas - 127.5) / 128.0)
    pil = np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR))
    np.testing.assert_array_equal(
        port_image.resize_bilinear_uint8(img, 32, 32), pil)


@pytest.mark.parametrize("seed", range(4))
def test_resize_bilinear_is_pil(seed):
    """Random sizes, bit for bit with PIL's BILINEAR: down by more than 4,
    up, one axis only, the identity, RGB and grey (H, W) images."""
    rng = np.random.RandomState(seed)
    for _ in range(12):
        h, w = rng.randint(1, 300, 2)
        oh, ow = rng.choice([rng.randint(1, 80), rng.randint(80, 400), h]), \
            rng.choice([rng.randint(1, 80), rng.randint(80, 400), w])
        shape = (h, w, 3) if rng.rand() < 0.7 else (h, w)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            port_image.resize_bilinear_uint8(img, oh, ow),
            np.asarray(Image.fromarray(img).resize((ow, oh),
                                                   Image.BILINEAR)),
            err_msg=f"{shape} -> {(oh, ow)}")


# ------------------------------------------------------------ safety checker

def test_safety_checker_matches_jax():
    """Banks crafted as in tests/test_safety_checker.py: image 0's embedding
    is concept 0 (threshold 0.99), image 1 meets no concept; the flags of
    the forward on identical pixels and of both makers on uint8 images
    (blacked-out image 0, image 1 untouched) agree with JAX's."""
    jax_model = jax_safety.SafetyChecker(
        vision_config=JaxVisionConfig(**TINY_VISION), projection_dim=16,
        num_concepts=3, num_special=2)
    variables = draw_variables(jax_model, (1, 28, 28, 3), 3)
    port = load_port(safety_checker.SafetyChecker(
        CLIPVisionConfig(**TINY_VISION), projection_dim=16, num_concepts=3,
        num_special=2), variables)
    images = np.random.RandomState(11).randint(0, 255, (2, 40, 40, 3),
                                               np.uint8)
    pixels = np.stack([(port_image.resize_bicubic_uint8(i, 28, 28) / 255.0
                        - port_image.CLIP_MEAN) / port_image.CLIP_STD
                       for i in images]).astype(np.float32)
    with torch.no_grad():
        post, _ = port.vision_model(torch.from_numpy(pixels))
        emb = port.visual_projection(post[:, 0]).numpy()
    unit = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    p = variables["params"]
    p["concept_embeds"][0] = unit[0]
    p["concept_embeds"][1:] = np.roll(unit[1], 1)[None]
    p["concept_embeds_weights"][:] = 0.99
    p["special_care_embeds"][:] = np.roll(unit[0], 3)[None]
    p["special_care_embeds_weights"][:] = 2.0
    state = state_from_jax(variables)
    port.load_state_dict(state)

    want = np.asarray(jax.jit(jax_model.apply)(variables,
                                               jnp.asarray(pixels)))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [True, False]

    out, flags = safety_checker.make_safety_checker(
        state, CLIPVisionConfig(**TINY_VISION), device="cpu")(images)
    w_out, w_flags = jax_safety.make_safety_checker(
        p, vision_config=JaxVisionConfig(**TINY_VISION))(images)
    np.testing.assert_array_equal(flags, w_flags)
    np.testing.assert_array_equal(out, w_out)
    assert (out[0] == 0).all() and np.array_equal(out[1], images[1])


# ------------------------------------------------------------ state_from_jax

@pytest.mark.parametrize("name", ["bisenet", "iresnet", "scrfd",
                                  "safety_checker"])
def test_state_from_jax_fills_every_tensor(name):
    """Every parameter and buffer of the port's module is filled, with its
    shape, and no JAX leaf is left over (module construction only)."""
    jax_model, port_model, x_shape, kw = {
        "bisenet": (jax_bisenet.BiSeNet(), bisenet.BiSeNet(),
                    (1, 64, 64, 3), {}),
        "iresnet": (jax_arcface.IResNet(**IRESNET_TINY),
                    arcface.IResNet(**IRESNET_TINY), (1, 32, 32, 3),
                    {"flatten_nhwc": {"fc": 512}}),
        "scrfd": (jax_scrfd.SCRFD(jax_scrfd.SCRFD_VARIANTS["scrfd_2.5g"]),
                  scrfd.SCRFD(scrfd.SCRFD_VARIANTS["scrfd_2.5g"]),
                  (1, 64, 64, 3), {}),
        "safety_checker": (
            jax_safety.SafetyChecker(
                vision_config=JaxVisionConfig(**TINY_VISION)),
            safety_checker.SafetyChecker(CLIPVisionConfig(**TINY_VISION)),
            (1, 28, 28, 3), {}),
    }[name]
    variables = draw_variables(jax_model, x_shape, 4)
    state = state_from_jax(variables, **kw)
    want = port_model.state_dict()
    assert sorted(state) == sorted(want)
    for key, t in want.items():
        assert state[key].shape == t.shape, key
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == n_leaves + n_bn
    if kw:    # the permuted fc: the same columns in another order
        flat = state_from_jax(variables)
        assert not torch.equal(flat["fc.weight"], state["fc.weight"])
        np.testing.assert_array_equal(
            np.sort(flat["fc.weight"].numpy(), axis=1),
            np.sort(state["fc.weight"].numpy(), axis=1))
