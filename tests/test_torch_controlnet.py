"""The inpaint family's second models against the JAX package on the CPU:
the ControlNet (SD1.5 and text_time tiny configs; its residuals, the UNet
taking them, the ControlNet-inpaint core with guess mode and a keep window)
and the 9-channel inpainting UNet's core. fp32, numpy-drawn parameters
carried across with params_from_jax, JAX's NHWC tensors against the port's
NCHW residuals permuted; the same injected noise as
test_torch_img2img_inpaint.py."""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.models.controlnet import ControlNet as JaxControlNet
from consistentid_tpu.pipelines import \
    ConsistentIDControlNetInpaintPipeline as JaxControlNetInpaint
from consistentid_tpu.pipelines import ConsistentIDInpaintPipeline as JaxInpaint
from consistentid_tpu.testing import synthetic_clip_tokenizer as jax_tokenizer
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_tpu.testing import tiny_sdxl_bundle as jax_tiny_sdxl_bundle
from consistentid_tpu.utils.image import sd_image_preprocess as jax_image_pre
from consistentid_torch.core import PipelineConfig, UNetConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.pipelines import (
    ConsistentIDControlNetInpaintPipeline, ConsistentIDInpaintPipeline)
from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                        tiny_bundle, tiny_controlnet)
from test_torch_img2img_inpaint import (GUIDANCE, LATENT, MERGE, PROMPT, SIZE,
                                        STATIC, STEPS, init_and_mask,
                                        jax_draws)
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_pipeline import _bundle_params, face_inputs

CN_PYRAMID = (16, 32)     # the tiny VAE halves the image once


def draw(shapes, seed: int):
    """Numpy parameters in a flax tree's shapes, drawn as _bundle_params
    draws them."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.standard_normal(x.shape, np.float32) / np.sqrt(fan_in)
        if "scale" in name:
            return 1.0 + 0.1 * rng.standard_normal(x.shape, np.float32)
        return 0.1 * rng.standard_normal(x.shape, np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def port_config(jax_config) -> UNetConfig:
    fields = {f.name for f in dataclasses.fields(UNetConfig)}
    return UNetConfig(**{k: v for k, v in dataclasses.asdict(jax_config)
                         .items() if k in fields})


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def controlnet_inputs(cfg, seed: int = 0):
    """(x, t, context, control image, added) for a batch of 2 at 16x16
    latents, numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = (cfg.projection_class_embeddings_input_dim
                  - 6 * cfg.addition_time_embed_dim)
        added = {"text_embeds": f(2, pooled),
                 "time_ids": np.tile(np.float32([[32, 32, 0, 0, 32, 32]]),
                                     (2, 1))}
    return (f(2, 16, 16, 4), np.float32([500.0, 20.0]),
            f(2, 81, cfg.cross_attention_dim),
            rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32), added)


def jax_controlnet(cfg, seed: int = 1):
    net = JaxControlNet(cfg, cond_embed_channels=CN_PYRAMID)
    x, t, ctx, cond, added = controlnet_inputs(cfg)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), x, t, ctx, cond, added_cond=added))["params"]
    return net, draw(shapes, seed)


@pytest.mark.parametrize("bundle", [jax_tiny_bundle, jax_tiny_sdxl_bundle],
                         ids=["sd15", "sdxl_text_time"])
def test_controlnet_matches_jax(bundle):
    """Every residual (one per UNet skip, then the mid block's) at
    conditioning scale 0.7: fp32 within 1e-5; the state dict is exactly
    the JAX tree's leaves (a strict load)."""
    cfg = bundle().unet_config
    net, params = jax_controlnet(cfg)
    x, t, ctx, cond, added = controlnet_inputs(cfg)
    want_down, want_mid = jax.jit(lambda p: net.apply(
        {"params": p}, x, t, ctx, cond, conditioning_scale=0.7,
        added_cond=added))(params)
    port = tiny_controlnet(port_config(cfg), device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    tt = torch.from_numpy
    with torch.no_grad():
        down, mid = port(tt(x), tt(t), tt(ctx), tt(cond),
                         conditioning_scale=0.7,
                         added_cond=None if added is None else
                         {k: tt(v) for k, v in added.items()})
    n = len(cfg.block_out_channels)     # conv_in, the resnets, downsamples
    assert len(down) == len(want_down) == 1 + n * cfg.layers_per_block + n - 1
    for g, w in zip((*down, mid), (*want_down, want_mid)):
        assert nhwc(g).shape == w.shape
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-5)


def test_unet_with_residuals_matches_jax(pipes):
    """The UNet adding a ControlNet's residuals to its skips and mid block
    (given in its inner NCHW layout), against the JAX UNet given the same
    NHWC residuals: fp32 within 1e-4, as the UNet's module parity; and the
    residuals move the output."""
    unet, params, port = (pipes[0].bundle.unet, pipes[1]["unet"],
                          pipes[2].bundle.unet)
    cfg = port.config
    x, t, ctx, _, _ = controlnet_inputs(cfg, seed=2)
    tt = torch.from_numpy
    with torch.no_grad():     # the skips' shapes, from a fresh ControlNet
        shapes = tiny_controlnet(port_config(cfg), device="cpu")(
            *map(tt, controlnet_inputs(cfg)[:4]))
    rng = np.random.default_rng(4)
    down = [rng.standard_normal(nhwc(s).shape).astype(np.float32)
            for s in shapes[0]]
    mid = rng.standard_normal(nhwc(shapes[1]).shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, d, m: unet.apply(
        {"params": p}, x, t, ctx, down_block_residuals=d,
        mid_residual=m))(params, down, mid))

    def nchw(a):
        return tt(a).permute(0, 3, 1, 2)

    with torch.no_grad():
        got = port(tt(x), tt(t), tt(ctx),
                   down_block_residuals=[nchw(d) for d in down],
                   mid_residual=nchw(mid)).numpy()
        plain = port(tt(x), tt(t), tt(ctx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got - plain).max() > 1e-2


# ------------------------------------------------------------ pipelines

@pytest.fixture(scope="module")
def pipes():
    jb = jax_tiny_bundle()
    params = _bundle_params(jb)
    net, params["controlnet"] = jax_controlnet(jb.unet_config, seed=5)
    cfg = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
               start_merge_step=MERGE)
    jpipe = JaxControlNetInpaint(
        jb, params, jax_tokenizer(), pipeline_config=JaxPipelineConfig(**cfg),
        controlnet=net)
    pbundle = tiny_bundle(device="cpu")
    pbundle.load_state_dict(params_from_jax(
        {k: v for k, v in params.items() if k != "controlnet"}), strict=True)
    port_net = tiny_controlnet(pbundle.unet_config, device="cpu")
    port_net.load_state_dict(params_from_jax(params["controlnet"]),
                             strict=True)
    ppipe = ConsistentIDControlNetInpaintPipeline(
        pbundle, synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(**cfg), controlnet=port_net)

    face, labels, faceid = face_inputs()
    init, mask = init_and_mask()
    control = np.random.RandomState(8).randint(0, 255, (SIZE, SIZE, 3),
                                               np.uint8)
    from consistentid_tpu.pipelines.inpaint import preprocess_mask
    jcond = jpipe.prepare_conditioning(
        PROMPT, Image.fromarray(face), parsing_labels=labels,
        faceid_embeds=faceid)
    jcond["init_image"] = jax_image_pre(Image.fromarray(init), SIZE, SIZE)
    jcond["pixel_mask"], jcond["latent_mask"] = preprocess_mask(
        Image.fromarray(mask), SIZE, SIZE, LATENT, LATENT)
    jcond["control_image"] = jax_image_pre(Image.fromarray(control), SIZE,
                                           SIZE) * 0.5 + 0.5
    return jpipe, params, ppipe, jcond, control


def _cores(jpipe, params, ppipe, jcond, scheduler, strength):
    noise, posterior, steps, vae_rng, sampler_rng = jax_draws(
        jpipe.schedule, scheduler, strength)
    want = np.asarray(jax.jit(jpipe._inpaint_core, static_argnames=STATIC)(
        params, jpipe._device_cond(jcond), jnp.asarray(noise),
        jnp.float32(GUIDANCE), jnp.int32(MERGE), STEPS, scheduler,
        jnp.float32(1.0), jnp.float32(1.0), strength, vae_rng, sampler_rng))
    got = ppipe._inpaint_core(
        ppipe.device_cond(jcond), torch.from_numpy(noise), GUIDANCE, MERGE,
        STEPS, scheduler, 1.0, 1.0, strength,
        posterior_noise=torch.from_numpy(posterior),
        sampler_noise=None if steps is None else torch.from_numpy(steps))
    return got.numpy(), want


@pytest.mark.parametrize("scheduler, strength, guess_mode, window", [
    ("ddim", 0.5, False, (0.0, 0.6)), ("euler", 1.0, True, (0.2, 1.0))])
def test_controlnet_inpaint_core_matches_jax(pipes, scheduler, strength,
                                             guess_mode, window):
    """ControlNet inpainting at controlnet_scale 0.8 with a keep window over
    the truncated plan's progress, with and without guess mode (the uncond
    half's residuals zeroed): decoded images within 1e-3."""
    jpipe, params, ppipe, jcond, _ = pipes
    for pipe in (jpipe, ppipe):
        pipe.controlnet_scale = 0.8
        pipe.control_guidance_start, pipe.control_guidance_end = window
        pipe.guess_mode = guess_mode
    kept = ppipe.scale_table(max(int(STEPS * strength), 1))
    assert 0 < np.count_nonzero(kept) < kept.size
    got, want = _cores(jpipe, params, ppipe, jcond, scheduler, strength)
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_fresh_controlnet_adds_nothing(pipes):
    """A fresh ControlNet's output convolutions are zero, so ControlNet
    inpainting gives plain inpainting's bits; control_image is required and
    unknown arguments are refused."""
    _, _, ppipe, _, control = pipes
    face, labels, faceid = face_inputs()
    init, mask = init_and_mask()
    kw = dict(parsing_labels=labels, faceid_embeds=faceid, seed=2,
              strength=0.75)
    cn = ConsistentIDControlNetInpaintPipeline(
        ppipe.bundle, synthetic_clip_tokenizer(),
        pipeline_config=ppipe.config, controlnet_scale=0.8,
        controlnet=tiny_controlnet(ppipe.bundle.unet_config, device="cpu"))
    plain = ConsistentIDInpaintPipeline(ppipe.bundle,
                                        synthetic_clip_tokenizer(),
                                        pipeline_config=ppipe.config)
    a = cn.generate(PROMPT, face, init, mask, control_image=control, **kw)
    np.testing.assert_array_equal(
        a, plain.generate(PROMPT, face, init, mask, **kw))
    with pytest.raises(TypeError, match="control_image"):
        cn.generate(PROMPT, face, init, mask, **kw)
    with pytest.raises(TypeError, match="unknown generate"):
        cn.generate(PROMPT, face, init, mask, control_image=control,
                    not_a_real_kwarg=1, **kw)


# ---------------------------------------------------- 9-channel inpainting

def test_nine_channel_inpaint_core_matches_jax(pipes):
    """The inpainting UNet's path (sample_channels 9: latents, latent mask
    and the masked image's latents, encoded with the same posterior draw),
    PNDM on the truncated plan, no blend: decoded images within 1e-3. The
    noise has the VAE's 4 channels. A ControlNet pipeline over this UNet is
    refused."""
    jb = pipes[0].bundle
    jb = dataclasses.replace(jb, unet_config=dataclasses.replace(
        jb.unet_config, sample_channels=9))
    # the SD1.5 parameters, but for conv_in's kernel over 9 channels
    params = {k: v for k, v in pipes[1].items() if k != "controlnet"}
    conv_in = params["unet"]["conv_in"]
    params["unet"] = {**params["unet"], "conv_in": {
        **conv_in, "kernel": draw({"kernel": jax.ShapeDtypeStruct(
            (3, 3, 9, conv_in["kernel"].shape[-1]), jnp.float32)}, 6)[
                "kernel"]}}
    cfg = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
               start_merge_step=MERGE)
    jpipe = JaxInpaint(jb, params, jax_tokenizer(),
                       pipeline_config=JaxPipelineConfig(**cfg))
    pbundle = tiny_bundle(device="cpu", sample_channels=9)
    pbundle.load_state_dict(params_from_jax(params), strict=True)
    ppipe = ConsistentIDInpaintPipeline(pbundle, synthetic_clip_tokenizer(),
                                        pipeline_config=PipelineConfig(**cfg))
    face, labels, faceid = face_inputs()
    init, mask = init_and_mask()
    from consistentid_tpu.pipelines.inpaint import preprocess_mask
    jcond = jpipe.prepare_conditioning(
        PROMPT, Image.fromarray(face), parsing_labels=labels,
        faceid_embeds=faceid)
    jcond["init_image"] = jax_image_pre(Image.fromarray(init), SIZE, SIZE)
    jcond["pixel_mask"], jcond["latent_mask"] = preprocess_mask(
        Image.fromarray(mask), SIZE, SIZE, LATENT, LATENT)
    got, want = _cores(jpipe, params, ppipe, jcond, "pndm", 0.5)
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert ppipe._noise(0, SIZE, SIZE)[1].shape == (1, LATENT, LATENT, 4)
    with pytest.raises(ValueError, match="4-channel UNet"):
        ConsistentIDControlNetInpaintPipeline(
            pbundle, synthetic_clip_tokenizer(),
            controlnet=tiny_controlnet(pbundle.unet_config, device="cpu"))
