"""The port's img2img and 4-channel inpainting against the JAX pipelines on
the CPU: tiny bundle, 64 px, 4 steps, fp32, the same numpy-drawn
parameters (carried across with params_from_jax), the same host cond and
the same injected noise: the initial noise, the VAE posterior noise (JAX's
own draw from fold_in(PRNGKey(seed), 1)) and DDPM's per-step noise (from
fold_in(PRNGKey(seed), 2)). Each JAX core is jitted once per case; decoded
images agree within 1e-3 (as the text-to-image core's parity). Also: the
mask preprocessing bit for bit against PIL's, the blend's exact unmasked
latents, strength 1 against text to image, the async and refused paths."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.pipelines import \
    ConsistentIDImg2ImgPipeline as JaxImg2Img
from consistentid_tpu.pipelines import ConsistentIDInpaintPipeline as JaxInpaint
from consistentid_tpu.pipelines.inpaint import \
    preprocess_mask as jax_preprocess_mask
from consistentid_tpu.sampling import schedulers as jax_sched
from consistentid_tpu.testing import synthetic_clip_tokenizer as jax_tokenizer
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_tpu.utils.image import sd_image_preprocess as jax_image_pre
from consistentid_torch.core import PipelineConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.pipelines import (ConsistentIDImg2ImgPipeline,
                                          ConsistentIDInpaintPipeline,
                                          ConsistentIDPipeline,
                                          preprocess_mask)
from consistentid_torch.sampling import schedulers as port_sched
from consistentid_torch.testing import synthetic_clip_tokenizer, tiny_bundle
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_pipeline import _bundle_params, face_inputs

PROMPT = "portrait photo of a man with a strong face, blue eyes and a nose"
STEPS, MERGE, GUIDANCE, SEED = 4, 1, 5.0, 11
SIZE, LATENT = 64, 32
STATIC = ("num_steps", "scheduler", "strength")


def init_and_mask():
    """An init image of another size than the request's (so it is resized)
    and a centre mask, white = regenerate."""
    init = np.random.RandomState(3).randint(0, 255, (80, 72, 3), np.uint8)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[16:48, 20:44] = 255
    return init, mask


def jax_draws(schedule, scheduler: str, strength: float):
    """The initial noise, JAX's posterior draw and, for DDPM, its per-step
    noise over the truncated plan, as numpy; and the two keys."""
    rng = jax.random.PRNGKey(SEED)
    vae_rng, sampler_rng = (jax.random.fold_in(rng, 1),
                            jax.random.fold_in(rng, 2))
    shape = (1, LATENT, LATENT, 4)
    noise = np.random.default_rng(SEED).standard_normal(shape, np.float32)
    posterior = np.array(jax.random.normal(vae_rng, shape, jnp.float32))
    steps = None
    if scheduler == "ddpm":
        plan = jax_sched.plan_tail(jax_sched.make_plan(schedule, "ddpm",
                                                       STEPS), strength)
        steps = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                          for k in jax.random.split(sampler_rng,
                                                    plan.num_steps)])
    return noise, posterior, steps, vae_rng, sampler_rng


@pytest.fixture(scope="module")
def pipes():
    jbundle = jax_tiny_bundle()
    params = _bundle_params(jbundle)
    cfg = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
               start_merge_step=MERGE)
    jax_pipes = {name: cls(jbundle, params, jax_tokenizer(),
                           pipeline_config=JaxPipelineConfig(**cfg))
                 for name, cls in (("img2img", JaxImg2Img),
                                   ("inpaint", JaxInpaint))}
    pbundle = tiny_bundle(device="cpu")
    pbundle.load_state_dict(params_from_jax(params), strict=True)
    port_pipes = {name: cls(pbundle, synthetic_clip_tokenizer(),
                            pipeline_config=PipelineConfig(**cfg))
                  for name, cls in (("img2img", ConsistentIDImg2ImgPipeline),
                                    ("inpaint", ConsistentIDInpaintPipeline),
                                    ("t2i", ConsistentIDPipeline))}
    face, labels, faceid = face_inputs()
    init, mask = init_and_mask()
    jcond = jax_pipes["img2img"].prepare_conditioning(
        PROMPT, Image.fromarray(face), parsing_labels=labels,
        faceid_embeds=faceid)
    jcond["init_image"] = jax_image_pre(Image.fromarray(init), SIZE, SIZE)
    jcond["pixel_mask"], jcond["latent_mask"] = jax_preprocess_mask(
        Image.fromarray(mask), SIZE, SIZE, LATENT, LATENT)
    return jax_pipes, params, port_pipes, jcond


def _run_both(pipes, name, scheduler, strength):
    jax_pipes, params, port_pipes, jcond = pipes
    jpipe, ppipe = jax_pipes[name], port_pipes[name]
    noise, posterior, steps, vae_rng, sampler_rng = jax_draws(
        jpipe.schedule, scheduler, strength)
    core = "_img2img_core" if name == "img2img" else "_inpaint_core"
    want = np.asarray(jax.jit(getattr(jpipe, core), static_argnames=STATIC)(
        params, jpipe._device_cond(jcond), jnp.asarray(noise),
        jnp.float32(GUIDANCE), jnp.int32(MERGE), STEPS, scheduler,
        jnp.float32(1.0), jnp.float32(1.0), strength, vae_rng, sampler_rng))
    got = getattr(ppipe, core)(
        ppipe.device_cond(jcond), torch.from_numpy(noise), GUIDANCE, MERGE,
        STEPS, scheduler, 1.0, 1.0, strength,
        posterior_noise=torch.from_numpy(posterior),
        sampler_noise=None if steps is None else torch.from_numpy(steps))
    return got.numpy(), want


@pytest.mark.parametrize("scheduler, strength", [("ddim", 0.5),
                                                 ("euler", 1.0)])
def test_img2img_core_matches_jax(pipes, scheduler, strength):
    """Strength 0.5: the encoded init latents noised to the first of 2 kept
    steps, init scale 1. Strength 1 under Euler: no encode, the noise at
    the plan's init scale (sigma_max)."""
    got, want = _run_both(pipes, "img2img", scheduler, strength)
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("scheduler, strength", [("dpmpp_2m", 0.5),
                                                 ("ddpm", 1.0)])
def test_inpaint_core_matches_jax(pipes, scheduler, strength):
    """4-channel inpainting, the blend after each step: DPM-Solver++(2M)
    on the truncated plan (its first kept step has no previous x0: rr[0]
    is 0 on both sides) and DDPM over all 4 steps with JAX's per-step
    noise."""
    if scheduler == "dpmpp_2m":
        plans = [m.plan_tail(m.make_plan(p["inpaint"].schedule, scheduler,
                                         STEPS), strength)
                 for m, p in ((jax_sched, pipes[0]), (port_sched, pipes[2]))]
        assert plans[0].rr[0] == plans[1].rr[0] == 0.0
        np.testing.assert_array_equal(plans[0].rr, plans[1].rr)
    got, want = _run_both(pipes, "inpaint", scheduler, strength)
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_inpaint_final_latents_outside_mask_are_the_image_latents(
        pipes, strength, monkeypatch):
    """The last blend target is 1.0 x0 + 0.0 noise, so outside the latent
    mask the final latents are the init image's latents bit for bit, and
    inside they are the denoiser's."""
    _, _, port_pipes, jcond = pipes
    ppipe = port_pipes["inpaint"]
    noise, posterior, _, _, _ = jax_draws(None, "ddim", strength)
    cond = ppipe.device_cond(jcond)
    seen = []
    monkeypatch.setattr(ppipe, "_decode", seen.append)   # the final latents
    ppipe._inpaint_core(cond, torch.from_numpy(noise), GUIDANCE, MERGE,
                        STEPS, "ddim", 1.0, 1.0, strength,
                        posterior_noise=torch.from_numpy(posterior))
    final = seen[0]
    image = ppipe.bundle.vae.encode(cond["init_image"],
                                    noise=torch.from_numpy(posterior))
    keep = cond["latent_mask"].expand_as(final) == 0
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(final[keep], image[keep])
    assert not torch.equal(final[~keep], image[~keep])


def test_img2img_full_strength_is_text_to_image(pipes):
    """Strength 1 draws the same latents from the same seed, encodes
    nothing and runs the whole plan: text to image's uint8 bits."""
    _, _, port_pipes, _ = pipes
    face, labels, faceid = face_inputs()
    init, _ = init_and_mask()
    kw = dict(parsing_labels=labels, faceid_embeds=faceid, seed=SEED)
    a = port_pipes["img2img"].generate(PROMPT, face, init, strength=1.0,
                                       **kw)
    b = port_pipes["t2i"].generate(PROMPT, face, **kw)
    assert a.shape == (1, SIZE, SIZE, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["img2img", "inpaint"])
def test_generate_async_matches_generate(pipes, name):
    _, _, port_pipes, _ = pipes
    face, labels, faceid = face_inputs()
    init, mask = init_and_mask()
    args = (PROMPT, face, init) + ((mask,) if name == "inpaint" else ())
    kw = dict(parsing_labels=labels, faceid_embeds=faceid, seed=3,
              strength=0.7, scheduler="ddpm")
    pipe = port_pipes[name]
    sync = pipe.generate(*args, **kw)
    assert sync.shape == (1, SIZE, SIZE, 3) and sync.dtype == np.uint8
    np.testing.assert_array_equal(sync, pipe.generate_async(*args, **kw)())


@pytest.mark.parametrize("name", ["img2img", "inpaint"])
def test_unknown_kwargs_and_batches_are_refused(pipes, name):
    _, _, port_pipes, _ = pipes
    face, labels, faceid = face_inputs()
    init, mask = init_and_mask()
    args = (PROMPT, face, init) + ((mask,) if name == "inpaint" else ())
    pipe = port_pipes[name]
    with pytest.raises(TypeError, match="unknown generate"):
        pipe.generate(*args, parsing_labels=labels, faceid_embeds=faceid,
                      not_a_real_kwarg=1)
    for method in (pipe.generate_batch, pipe.generate_batch_async):
        with pytest.raises(NotImplementedError, match="init image"):
            method([PROMPT], [face])


def _mask_cases():
    rng = np.random.RandomState(5)
    grey = (rng.rand(37, 53) > 0.5).astype(np.uint8) * 255
    soft = rng.randint(0, 256, (37, 53), np.uint8)       # thresholded at 128
    rgb = rng.randint(0, 256, (53, 37, 3), np.uint8)
    rgba = rng.randint(0, 256, (64, 48, 4), np.uint8)
    la = rng.randint(0, 256, (30, 31, 2), np.uint8)
    return [("grey", grey, 512, 512, 64, 64), ("soft_grey", soft, 512, 512,
                                               64, 64),
            ("rgb", rgb, 96, 80, 12, 10), ("rgba", rgba, 64, 48, 8, 6),
            ("grey_alpha", la, 100, 60, 13, 7)]


@pytest.mark.parametrize("case", _mask_cases(), ids=lambda c: c[0])
def test_preprocess_mask_matches_pil(case):
    """PIL's convert("L") and NEAREST resizes in numpy: the pixel and
    latent masks equal the JAX package's PIL ones bit for bit, at odd sizes
    (37x53 -> 512x512 -> 64x64) and for grey, grey + alpha, RGB and RGBA
    masks."""
    _, arr, h, w, lh, lw = case
    want = jax_preprocess_mask(Image.fromarray(arr), h, w, lh, lw)
    got = preprocess_mask(arr, h, w, lh, lw)
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
