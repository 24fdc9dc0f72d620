"""DeepCache in the port against the JAX package on the CPU: the UNet's
split (return_deep, deep_feature; SD1.5 and the SDXL layout, whose level 0
has no attention), its guards, `denoise`'s cadence and inpaint blend on a
tiny UNet, and the SD1.5 generate core with cache_interval 3. fp32,
numpy-drawn parameters carried across with params_from_jax; JAX's NHWC deep
feature against the port's NCHW one permuted."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.pipelines import ConsistentIDPipeline as JaxPipeline
from consistentid_tpu.sampling import CondBranch as JaxBranch
from consistentid_tpu.sampling import denoise as jax_denoise
from consistentid_tpu.sampling import schedulers as jax_sched
from consistentid_tpu.testing import synthetic_clip_tokenizer as jax_tokenizer
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_tpu.testing import tiny_sdxl_bundle as jax_tiny_sdxl_bundle
from consistentid_torch.core import PipelineConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.models import UNet
from consistentid_torch.pipelines import ConsistentIDPipeline
from consistentid_torch.sampling import CondBranch, denoise
from consistentid_torch.sampling import schedulers as port_sched
from consistentid_torch.testing import synthetic_clip_tokenizer, tiny_bundle
from test_torch_controlnet import draw, nhwc, port_config
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_pipeline import PROMPT, _bundle_params, face_inputs

T = torch.from_numpy


def unet_inputs(cfg, hw: int = 16, seed: int = 1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = (cfg.projection_class_embeddings_input_dim
                  - 6 * cfg.addition_time_embed_dim)
        added = {"text_embeds": f(2, pooled),
                 "time_ids": np.tile(np.float32([[32, 32, 0, 0, 32, 32]]),
                                     (2, 1))}
    return f(2, hw, hw, 4), np.float32([500.0, 20.0]), \
        f(2, 81, cfg.cross_attention_dim), added


@pytest.fixture(scope="module")
def unets():
    """The tiny SD1.5 bundle's parameters (numpy), the JAX inference UNet
    (LoRA folded) with its parameters, and the port bundle."""
    jb = jax_tiny_bundle()
    params = _bundle_params(jb)
    junet, jparams = jb.infer_unet(params["unet"], 1.0)
    pb = tiny_bundle(device="cpu")
    pb.load_state_dict(params_from_jax(params), strict=True)
    return jb, params, junet, jparams, pb


def sdxl_unet():
    from consistentid_tpu.models.unet import UNet as JaxUNet
    cfg = jax_tiny_sdxl_bundle().unet_config
    unet = JaxUNet(cfg)
    x, t, ctx, added = unet_inputs(cfg)
    params = draw(jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), x, t, ctx, added_cond=added))["params"], 7)
    port = UNet(port_config(cfg))
    port.load_state_dict(params_from_jax(params), strict=True)
    return unet, params, port


@pytest.mark.parametrize("layout", ["sd15", "sdxl_text_time"])
def test_unet_split_matches_jax(unets, layout):
    """return_deep: the output and the deep feature (the last up block's
    input) against JAX's; deep_feature: the shallow path on JAX's own deep
    feature against JAX's shallow path; fp32 within 1e-4. The port's split
    invariant: the shallow path on the full path's deep feature gives the
    full output (within 1e-5), and return_deep leaves the output's bits
    as they are."""
    if layout == "sd15":
        _, _, unet, params, pb = unets
        port = pb.infer_unet(1.0)
    else:
        unet, params, port = sdxl_unet()
    cfg = port.config
    x, t, ctx, added = unet_inputs(cfg)

    def split(p):
        out, deep = unet.apply({"params": p}, x, t, ctx, added_cond=added,
                               return_deep=True)
        return out, deep, unet.apply({"params": p}, x, t, ctx,
                                     added_cond=added, deep_feature=deep)

    want_out, want_deep, want_shallow = map(np.array,
                                            jax.jit(split)(params))
    kw = dict(added_cond=None if added is None
              else {k: T(v) for k, v in added.items()})
    with torch.no_grad():
        out, deep = port(T(x), T(t), T(ctx), return_deep=True, **kw)
        plain = port(T(x), T(t), T(ctx), **kw)
        shallow = port(T(x), T(t), T(ctx),
                       deep_feature=T(want_deep).permute(0, 3, 1, 2), **kw)
        own = port(T(x), T(t), T(ctx), deep_feature=deep, **kw)
    assert deep.shape[1] == cfg.block_out_channels[1]
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-4)
    np.testing.assert_allclose(nhwc(deep), want_deep, rtol=0, atol=1e-4)
    np.testing.assert_allclose(shallow.numpy(), want_shallow, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(own.numpy(), out.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(out, plain)


@pytest.fixture(scope="module")
def tiny_unet():
    bundle = tiny_bundle(device="cpu")
    return bundle.infer_unet(1.0), bundle.unet_config


@pytest.mark.parametrize("guard", ["down_residuals", "mid_residual",
                                   "capture_layers", "return_deep"])
def test_deep_feature_guards(tiny_unet, guard):
    """The JAX UNet's guards: no deep feature together with ControlNet
    residuals, attention capture or return_deep."""
    unet, cfg = tiny_unet
    x, t, ctx, _ = (T(a) if a is not None else None
                    for a in unet_inputs(cfg))
    deep = torch.zeros((2, cfg.block_out_channels[1], 16, 16))
    kw = {"down_residuals": dict(down_block_residuals=[deep]),
          "mid_residual": dict(mid_residual=deep),
          "capture_layers": dict(capture_layers=("up_3",)),
          "return_deep": dict(return_deep=True)}[guard]
    with pytest.raises(ValueError):
        unet(x, t, ctx, deep_feature=deep, **kw)


# ------------------------------------------------------------- denoise

STEPS, MERGE, GUIDANCE = 7, 2, 5.0


@pytest.mark.parametrize("cache_interval, blend", [(2, True), (3, False)])
def test_denoise_cadence_matches_jax(unets, cache_interval, blend):
    """denoise over 7 DDIM steps on the tiny UNet: the full UNet at steps
    0, 2, 4, 6 (interval 2) or 0, 3, 6 (interval 3), the shallow path on
    the cached deep feature between; with interval 2 also the inpaint blend
    toward a (T, B, h, w, C) target table after each step. Relative L2
    within 1e-5 of JAX's (fp32)."""
    jb, _, junet, jparams, pb = unets
    rng = np.random.default_rng(cache_interval)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lat, text, aug, null = f(1, 16, 16, 4), f(1, 81, 64), f(1, 81, 64), \
        f(1, 81, 64)
    mask = targets = None
    if blend:
        mask = np.zeros((1, 16, 16, 1), np.float32)
        mask[:, 4:12, 3:10] = 1.0
        targets = f(STEPS, 1, 16, 16, 4)
    fns = JaxPipeline._unet_fns(None, junet, jparams, jnp.float32(1.0),
                                cache_interval)
    plan = jax_sched.make_plan(jax_sched.NoiseSchedule.create(
        jb_schedule_config()), "ddim", STEPS)
    want = np.asarray(jax.jit(lambda x, a, b, c, m, tg: jax_denoise(
        fns[0], x, JaxBranch(context=a, null=c), JaxBranch(context=b, null=c),
        plan, jnp.float32(GUIDANCE), jnp.int32(MERGE), inpaint_mask=m,
        inpaint_targets=tg, cache_interval=cache_interval,
        unet_cached_fn=fns[1]))(lat, text, aug, null, mask, targets))

    unet = pb.infer_unet(1.0)
    calls = []

    def count(fn, kind):
        def wrapped(*args):
            calls.append((kind, args[4]))
            return fn(*args)
        return wrapped

    full, cached = ConsistentIDPipeline._unet_fns(unet, 1.0, cache_interval)
    with torch.no_grad():
        got = denoise(count(full, "full"), T(lat), CondBranch(T(text),
                                                             T(null)),
                      CondBranch(T(aug), T(null)),
                      port_sched.make_plan(port_sched.NoiseSchedule.create(
                          port_schedule_config()), "ddim", STEPS),
                      GUIDANCE, MERGE,
                      inpaint_mask=None if mask is None else T(mask),
                      inpaint_targets=None if targets is None else T(targets),
                      cache_interval=cache_interval,
                      unet_cached_fn=count(cached, "cached")).numpy()
    assert calls == [("full" if i % cache_interval == 0 else "cached", i)
                     for i in range(STEPS)]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    if blend:
        np.testing.assert_array_equal(got[mask.repeat(4, -1) == 0],
                                      targets[-1][mask.repeat(4, -1) == 0])


def jb_schedule_config():
    from consistentid_tpu.core import SchedulerConfig
    return SchedulerConfig()


def port_schedule_config():
    from consistentid_torch.core import SchedulerConfig
    return SchedulerConfig()


def test_denoise_refuses_bad_cache_and_blend_arguments(tiny_unet):
    lat = torch.zeros((1, 4, 4, 4))
    ctx = torch.zeros((1, 3, 8))
    plan = port_sched.make_plan(port_sched.NoiseSchedule.create(
        port_schedule_config()), "ddim", 3)
    args = (lambda *a: a[0], lat, CondBranch(ctx, ctx), CondBranch(ctx, ctx),
            plan, GUIDANCE, MERGE)
    with pytest.raises(ValueError, match=">= 1"):
        denoise(*args, cache_interval=0)
    with pytest.raises(ValueError, match="unet_cached_fn"):
        denoise(*args, cache_interval=2)
    with pytest.raises(ValueError, match="go together"):
        denoise(*args, inpaint_mask=lat[..., :1])


def test_generate_core_cached_matches_jax(unets):
    """The SD1.5 generate core with cache_interval 3 (6 DDIM steps, 64 px,
    injected latents) against the JAX core: decoded images within 1e-3."""
    jb, params, _, _, pb = unets
    cfg = dict(height=64, width=64, num_inference_steps=6,
               start_merge_step=MERGE)
    jpipe = JaxPipeline(jb, params, jax_tokenizer(),
                        pipeline_config=JaxPipelineConfig(**cfg))
    ppipe = ConsistentIDPipeline(pb, synthetic_clip_tokenizer(),
                                 pipeline_config=PipelineConfig(**cfg))
    face, labels, faceid = face_inputs()
    from PIL import Image
    jcond = jpipe.prepare_conditioning(PROMPT, Image.fromarray(face),
                                       parsing_labels=labels,
                                       faceid_embeds=faceid)
    latents = np.random.default_rng(9).standard_normal((1, 32, 32, 4),
                                                       np.float32)
    want = np.asarray(jpipe._core_jit(
        params, jpipe._device_cond(jcond), jnp.asarray(latents),
        jnp.float32(GUIDANCE), jnp.int32(MERGE), 6, "ddim",
        jnp.float32(1.0), jnp.float32(1.0), jax.random.PRNGKey(1), 3))
    got = ppipe._generate_core(ppipe.device_cond(jcond), T(latents),
                               GUIDANCE, MERGE, 6, "ddim", 1.0, 1.0,
                               cache_interval=3).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_generate_batch_takes_cache_interval(unets):
    """The serving path: generate_batch_async under a PipelineConfig with
    cache_interval 2 gives the bits of generate_batch(cache_interval=2)
    under the default config, and other bits than interval 1."""
    pb = unets[4]
    face, labels, faceid = face_inputs()
    cfg = dict(height=64, width=64, num_inference_steps=4,
               start_merge_step=MERGE)
    kw = dict(seeds=[3, 4], parsing_labels_list=[labels, labels],
              faceid_embeds_list=[faceid, -faceid])
    args = ([PROMPT, "a woman"], [face, face])
    plain, cached = (ConsistentIDPipeline(
        pb, synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(**cfg, cache_interval=c))
        for c in (1, 2))
    want = plain.generate_batch(*args, cache_interval=2, **kw)
    np.testing.assert_array_equal(cached.generate_batch_async(*args, **kw)(),
                                  want)
    assert not np.array_equal(plain.generate_batch(*args, **kw), want)
