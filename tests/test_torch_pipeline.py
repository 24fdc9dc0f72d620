"""The PyTorch port's SD1.5 slice end to end against the JAX pipeline on the
CPU: tiny bundle, 64 px, 3 DDIM steps, fp32, the same parameters (drawn
from a numpy seed, carried across with params_from_jax) and the same
injected latents. One JAX pipeline and its one jitted run are shared by the
module's fixtures."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.pipelines import ConsistentIDPipeline as JaxPipeline
from consistentid_tpu.testing import synthetic_clip_tokenizer as jax_tokenizer
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_torch.core import PipelineConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.ops import flash_attention as port_flash
from consistentid_torch.pipelines import ConsistentIDPipeline
from consistentid_torch.testing import synthetic_clip_tokenizer, tiny_bundle
from test_torch_loading import one_torch_thread  # noqa: F401

PROMPT = "portrait photo of a man with a strong face, blue eyes and a nose"
STEPS, MERGE, GUIDANCE = 3, 1, 5.0


def face_inputs():
    rng = np.random.RandomState(0)
    face = rng.randint(0, 255, (64, 64, 3), np.uint8)
    labels = np.zeros((64, 64), np.uint8)
    labels[10:40, 10:50] = 1    # Face
    labels[15:20, 15:25] = 4    # Left_Eye
    labels[15:20, 35:45] = 5    # Right_Eye
    labels[17, 18] = 1          # a hole in the left eye: filled by the mask
    labels[25:30, 28:34] = 10   # Nose
    labels[33:37, 24:38] = 12   # Upper_Lip
    faceid = rng.randn(1, 16).astype(np.float32)
    return face, labels, faceid


@pytest.fixture(scope="module")
def pipes():
    jbundle = jax_tiny_bundle()
    params = _bundle_params(jbundle)
    jpipe = JaxPipeline(jbundle, params, jax_tokenizer(),
                        pipeline_config=JaxPipelineConfig(
                            height=64, width=64, num_inference_steps=STEPS,
                            start_merge_step=MERGE))
    pbundle = tiny_bundle(device="cpu")
    pbundle.load_state_dict(params_from_jax(params), strict=True)
    ppipe = ConsistentIDPipeline(pbundle, synthetic_clip_tokenizer(),
                                 pipeline_config=PipelineConfig(
                                     height=64, width=64,
                                     num_inference_steps=STEPS,
                                     start_merge_step=MERGE))
    face, labels, faceid = face_inputs()
    jcond = jpipe.prepare_conditioning(PROMPT, Image.fromarray(face),
                                       parsing_labels=labels,
                                       faceid_embeds=faceid)
    return jpipe, params, ppipe, jcond


def _bundle_params(jbundle):
    """Numpy parameters for the whole JAX bundle, drawn per component as in
    the module tests."""
    shapes = jax.eval_shape(jbundle.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.standard_normal(x.shape, np.float32) / np.sqrt(fan_in)
        if "scale" in name:
            return 1.0 + 0.1 * rng.standard_normal(x.shape, np.float32)
        return 0.1 * rng.standard_normal(x.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_prepare_conditioning(pipes):
    """Token ids, trigger indices, region masks and CLIP pixels exact (the
    port's bicubic resize is PIL's fixed-point one in numpy)."""
    jpipe, _, ppipe, jcond = pipes
    face, labels, faceid = face_inputs()
    pcond = ppipe.prepare_conditioning(PROMPT, face, parsing_labels=labels,
                                       faceid_embeds=faceid)
    assert pcond.keys() == jcond.keys()
    for key in ("clean_ids", "text_only_ids", "negative_ids", "facial_idx",
                "facial_idx_mask", "region_masks", "faceid_embeds"):
        np.testing.assert_array_equal(pcond[key], jcond[key], err_msg=key)
    assert jcond["facial_idx_mask"].sum() == 4
    for key in ("face_pixels", "region_pixels"):
        assert pcond[key].shape == jcond[key].shape
        np.testing.assert_array_equal(pcond[key], jcond[key], err_msg=key)


@pytest.fixture(scope="module")
def jax_run(pipes):
    """JAX encode and the jitted encode+denoise+decode core, once."""
    jpipe, params, _, jcond = pipes
    dcond = jpipe._device_cond(jcond)
    latents = np.random.default_rng(7).standard_normal(
        (2, 32, 32, 4), np.float32)
    embeds = jax.jit(jpipe.encode_embeddings)(params, dcond)
    images = jpipe._core_jit(
        params, dcond, jnp.asarray(latents), jnp.float32(GUIDANCE),
        jnp.int32(MERGE), STEPS, "ddim", jnp.float32(1.0), jnp.float32(1.0),
        jax.random.PRNGKey(1), 1)
    return latents, [np.asarray(e) for e in embeds], np.asarray(images)


def test_encode_embeddings(pipes, jax_run):
    """Same host cond on both sides; fp32 towers: 1e-4 (as the module
    tests)."""
    _, _, ppipe, jcond = pipes
    _, want, _ = jax_run
    got = ppipe.encode_embeddings(ppipe.device_cond(jcond))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


def test_generate_core_same_latents(pipes, jax_run, monkeypatch):
    """Image to image with injected latents. Three UNet steps and the VAE
    compound the per-tower fp32 drift: 1e-3 on images in [-1, 1]. The level-0
    self-attention (32 x 32 latents -> 1024 tokens) crosses the flash
    cutover: 3 transformer blocks x 3 steps reach flash_attention, which on
    CPU tensors runs its plain version and launches nothing."""
    _, _, ppipe, jcond = pipes
    latents, _, want = jax_run
    calls = []
    real = port_flash.flash_attention

    def spy(q, k, v, sm_scale=None):
        calls.append(tuple(q.shape))
        return real(q, k, v, sm_scale)

    monkeypatch.setattr(port_flash, "flash_attention", spy)
    before = port_flash.flash_attention_fwd.launches
    got = ppipe._generate_core(ppipe.device_cond(jcond),
                               torch.from_numpy(latents), GUIDANCE, MERGE,
                               STEPS, "ddim", 1.0, 1.0)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    assert calls == [(4, 2, 1024, 16)] * 9
    assert port_flash.flash_attention_fwd.launches == before


@pytest.mark.parametrize("scheduler", ["euler", "dpmpp_2m"])
def test_generate_core_samplers_same_latents(pipes, jax_run, scheduler):
    """As test_generate_core_same_latents, with the Euler and
    DPM-Solver++(2M) samplers at 4 steps (their init scale, model-input
    scale and multistep history): 1e-3 on images in [-1, 1]."""
    jpipe, params, ppipe, jcond = pipes
    latents = jax_run[0]
    want = np.asarray(jpipe._core_jit(
        params, jpipe._device_cond(jcond), jnp.asarray(latents),
        jnp.float32(GUIDANCE), jnp.int32(MERGE), 4, scheduler,
        jnp.float32(1.0), jnp.float32(1.0), jax.random.PRNGKey(1), 1))
    got = ppipe._generate_core(ppipe.device_cond(jcond),
                               torch.from_numpy(latents), GUIDANCE, MERGE,
                               4, scheduler, 1.0, 1.0)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_generate_returns_uint8(pipes):
    _, _, ppipe, _ = pipes
    face, labels, faceid = face_inputs()
    img = ppipe.generate(PROMPT, face, parsing_labels=labels,
                         faceid_embeds=faceid, seed=3,
                         num_images_per_prompt=2)
    assert img.shape == (2, 64, 64, 3) and img.dtype == np.uint8


def test_host_steps_match_jax():
    """The port's numpy/scipy/torch host steps against the JAX package's
    PIL/cv2 ones: filled region masks exact (holes, a nested component and
    diagonal contact included), center-cropped masks and uint8
    postprocessing exact, CLIP pixels exact."""
    from consistentid_tpu.conditioning import masks as jax_masks
    from consistentid_tpu.utils import image as jax_image
    from consistentid_torch.conditioning import masks as port_masks
    from consistentid_torch.utils import image as port_image

    labels = np.zeros((40, 48), np.uint8)
    labels[5:30, 5:30] = 1          # face with a hole holding an eye
    labels[10:20, 10:20] = 0
    labels[12:16, 12:16] = 4
    labels[30, 30] = 1              # touches the face only diagonally
    labels[2:8, 35:45] = 10
    labels[4:6, 38:42] = 3          # enclosed by the nose
    labels[35:38, 0:48] = 12        # spans the map edge to edge
    want = jax_masks.masks_for_unique_values(labels)
    got = port_masks.masks_for_unique_values(labels)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
        for size in (32, 64):
            np.testing.assert_array_equal(
                port_image.center_crop_mask(got[key], size),
                jax_image.center_crop_mask(want[key], size))

    rng = np.random.RandomState(1)
    for shape in ((300, 200, 3), (50, 80, 3)):
        img = rng.randint(0, 255, shape, np.uint8)
        np.testing.assert_array_equal(
            port_image.clip_preprocess(img, 224),
            jax_image.clip_preprocess(Image.fromarray(img), 224))
    images = rng.uniform(-1.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        port_image.postprocess_to_uint8(torch.from_numpy(images)),
        jax_image.postprocess_to_uint8(images))


def test_prepare_conditioning_through_hooks(pipes, monkeypatch):
    """No injected labels or embedding: the port's face_parser and
    face_embedder hooks (BiSeNet, 19 classes at 64 px; a tiny 16-d IResNet
    behind a stand-in detector that returns a crop of the photo) against the
    JAX package's make_face_parser and make_face_embedder on the same
    weights, each pipeline calling its own. The same prepared arrays reach
    both networks, so the label maps agree exactly: ids, indices and masks
    exact, the embedding within 1e-5 (fp32 towers), pixels exact. Without labels or a parser the port raises; a safety
    checker's flags land in last_nsfw_flags."""
    from consistentid_tpu.models import arcface as jax_arcface
    from consistentid_tpu.models import bisenet as jax_bisenet
    from consistentid_torch.io import state_from_jax
    from consistentid_torch.models import arcface, bisenet
    from tests.test_torch_perception import draw_variables

    jpipe, _, ppipe, _ = pipes
    face, _, _ = face_inputs()
    bv = draw_variables(jax_bisenet.BiSeNet(), (1, 64, 64, 3), 5)
    tiny = dict(layers=(1, 1, 1, 1), embedding_dim=16, input_size=32)
    iv = draw_variables(jax_arcface.IResNet(**tiny), (1, 32, 32, 3), 6)

    def detector(image):
        return np.asarray(image)[16:48, 16:48].astype(np.float32), 0.9, \
            np.zeros(4)

    monkeypatch.setattr(jpipe, "face_parser", jax_bisenet.make_face_parser(
        bv["params"], bv["batch_stats"], size=64))
    monkeypatch.setattr(jpipe, "face_embedder", jax_arcface.make_face_embedder(
        iv["params"], iv["batch_stats"], detector=detector))
    hooked = ConsistentIDPipeline(
        ppipe.bundle, synthetic_clip_tokenizer(), ppipe.config,
        face_parser=bisenet.make_face_parser(state_from_jax(bv), size=64,
                                             device="cpu"),
        face_embedder=arcface.make_face_embedder(
            state_from_jax(iv, flatten_nhwc={"fc": 512}), detector=detector,
            device="cpu"),
        safety_checker=lambda images: (np.zeros_like(images),
                                       np.ones(len(images), bool)))
    jcond = jpipe.prepare_conditioning(PROMPT, Image.fromarray(face))
    pcond = hooked.prepare_conditioning(PROMPT, face)
    assert pcond.keys() == jcond.keys()
    for key in ("clean_ids", "text_only_ids", "negative_ids", "facial_idx",
                "facial_idx_mask", "region_masks"):
        np.testing.assert_array_equal(pcond[key], jcond[key], err_msg=key)
    assert jcond["facial_idx_mask"].sum() >= 1
    np.testing.assert_allclose(pcond["faceid_embeds"], jcond["faceid_embeds"],
                               rtol=0, atol=1e-5)
    assert np.linalg.norm(pcond["faceid_embeds"]) == pytest.approx(1, 1e-5)
    for key in ("face_pixels", "region_pixels"):
        np.testing.assert_array_equal(pcond[key], jcond[key], err_msg=key)

    with pytest.raises(ValueError):
        ppipe.prepare_conditioning(PROMPT, face)
    img = hooked.generate(PROMPT, face, num_inference_steps=2, seed=0)
    assert img.shape == (1, 64, 64, 3) and (img == 0).all()
    assert hooked.last_nsfw_flags.tolist() == [True]
    assert {"prepare", "encode", "denoise", "decode", "safety"} <= set(
        hooked.last_stage_ms)
