"""Module-by-module parity of the PyTorch port against the JAX package on
the CPU, at tiny widths, in fp32.

Parameters take the shapes of the JAX modules' own init and are drawn from
a numpy seed (the JAX init's LoRA up-projections are zero, which would leave
the LoRA paths untested), carried across with params_from_jax, and both
sides run the same numpy inputs. The JAX side runs jitted: one compile per
module instead of one per eager op.

Tolerance: both sides compute in fp32 but XLA's and torch's CPU kernels
sum in different orders; a few ulps per op accumulate
through the depth of each module, so single blocks are held to 2e-5 and
whole towers (UNet, VAE, CLIP, adapters) to 1e-4, relative to an output
scale of about 1.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistentid_tpu.adapter import modules as jax_adapter
from consistentid_tpu.core import config as jax_config
from consistentid_tpu.models import clip as jax_clip
from consistentid_tpu.models import layers as jax_layers
from consistentid_tpu.models import lora as jax_lora
from consistentid_tpu.models import unet as jax_unet
from consistentid_tpu.models import vae as jax_vae
from consistentid_tpu.sampling import schedulers as jax_sched
from consistentid_torch.adapter import FacialEncoder, ProjPlusModel
from consistentid_torch.core import config as port_config
from consistentid_torch.io import params_from_jax
from consistentid_torch.models import (AutoencoderKL, CLIPTextEncoder,
                                       CLIPVisionEncoder, UNet,
                                       fold_lora_params)
from consistentid_torch.models import layers as port_layers
from consistentid_torch.sampling import schedulers as port_sched
from test_torch_loading import one_torch_thread  # noqa: F401


def init_params(mod, seed, *args):
    """Numpy parameters in the shapes of `mod.init(*args)`: kernels ~
    N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1), the rest ~ N(0, 0.1)."""
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0),
                            *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path[-1:])
        shape = np.shape(x)
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape, np.float32) / np.sqrt(fan_in)
        if "scale" in name:
            return 1.0 + 0.1 * rng.standard_normal(shape, np.float32)
        return 0.1 * rng.standard_normal(shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_apply(mod, params, *args, **kw):
    return jax.jit(lambda p, *a: mod.apply({"params": p}, *a, **kw))(
        params, *args)


def port_of(module, params):
    module.load_state_dict(params_from_jax(params), strict=True)
    return module.eval().requires_grad_(False)


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def assert_close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def port_cfg(cls, jax_cfg):
    """The port's config dataclass with the JAX config's shared fields."""
    fields = cls.__dataclass_fields__
    return cls(**{k: getattr(jax_cfg, k) for k in fields})


TINY_UNET = jax_config.UNetConfig(
    block_out_channels=(32, 32, 64, 64), layers_per_block=1,
    num_attention_heads=(2, 2, 2, 2), cross_attention_dim=64,
    norm_num_groups=8, lora_rank=4, ip_num_tokens=4)


def test_resnet_block():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 16), np.float32)
    temb = rng.standard_normal((2, 24), np.float32)
    mod = jax_layers.ResnetBlock(32, groups=8)
    params = init_params(mod, 1, x, temb)
    want = jax_apply(mod, params, x, temb)
    port = port_of(port_layers.ResnetBlock(16, 32, 24, groups=8), params)
    got = port(nhwc_to_nchw(x), torch.from_numpy(temb)).permute(0, 2, 3, 1)
    assert_close(got, want, 2e-5)


def test_attention_lora_ip():
    """Cross-attention with LoRA on all four projections and the decoupled
    IP branch over the last 4 context tokens."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 32), np.float32)
    ctx = rng.standard_normal((2, 12 + 4, 48), np.float32)
    mod = jax_layers.Attention(32, 2, context_dim=48, lora_rank=4,
                               ip_num_tokens=4)
    params = init_params(mod, 2, x, ctx)
    want = jax_apply(mod, params, x, ctx, lora_scale=0.7,
                     ip_scale=0.6)
    port = port_of(port_layers.Attention(32, 2, context_dim=48, lora_rank=4,
                                         ip_num_tokens=4), params)
    got = port(torch.from_numpy(x), torch.from_numpy(ctx), lora_scale=0.7,
               ip_scale=0.6)
    assert_close(got, want, 2e-5)


def test_transformer2d():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 6, 32), np.float32)
    ctx = rng.standard_normal((2, 10, 48), np.float32)
    mod = jax_layers.Transformer2D(heads=2, context_dim=48, groups=8,
                                   lora_rank=4, ip_num_tokens=4)
    params = init_params(mod, 3, x, ctx)
    want = jax_apply(mod, params, x, ctx)
    port = port_of(port_layers.Transformer2D(32, 2, 48, groups=8,
                                             lora_rank=4, ip_num_tokens=4),
                   params)
    got = port(nhwc_to_nchw(x), torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    assert_close(got, want, 1e-4)


@pytest.fixture(scope="module")
def tiny_unet():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4), np.float32)
    t = np.array([801.0, 41.0], np.float32)
    ctx = rng.standard_normal((2, 9 + 4, 64), np.float32)
    mod = jax_unet.UNet(TINY_UNET)
    params = init_params(mod, 4, x, jnp.asarray(t), ctx)
    return mod, params, x, t, ctx


def test_unet(tiny_unet):
    mod, params, x, t, ctx = tiny_unet
    want = jax_apply(mod, params, x, jnp.asarray(t), ctx,
                     ip_scale=0.8, lora_scale=0.9)
    port = port_of(UNet(port_cfg(port_config.UNetConfig, TINY_UNET)), params)
    got = port(torch.from_numpy(x), torch.from_numpy(t),
               torch.from_numpy(ctx), ip_scale=0.8, lora_scale=0.9)
    assert got.shape == (2, 16, 16, 4)
    assert_close(got, want, 1e-4)


def test_fold_lora_params(tiny_unet):
    """The port's fold over its state dict equals the JAX fold carried
    across, and the folded LoRA-free UNet equals the live-LoRA UNet."""
    mod, params, x, t, ctx = tiny_unet
    port_state = params_from_jax(params)
    folded = fold_lora_params(port_state, 0.6)
    want = params_from_jax(jax.device_get(
        jax_lora.fold_lora_params(params, 0.6)))
    assert folded.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(folded[key], want[key], rtol=0, atol=1e-6)
    cfg = port_config.UNetConfig(**{
        **port_cfg(port_config.UNetConfig, TINY_UNET).__dict__,
        "lora_rank": 0})
    plain = UNet(cfg).eval()
    plain.load_state_dict(folded)
    live = port_of(UNet(port_cfg(port_config.UNetConfig, TINY_UNET)), params)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        torch.testing.assert_close(plain(*args), live(*args, lora_scale=0.6),
                                   rtol=0, atol=1e-4)


def test_vae_decode_and_encode():
    rng = np.random.default_rng(5)
    cfg = jax_config.VAEConfig(block_out_channels=(16, 32),
                               layers_per_block=1, norm_num_groups=8)
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 4), np.float32)
    mod = jax_vae.AutoencoderKL(cfg)
    params = init_params(mod, 6, img)
    port = port_of(AutoencoderKL(port_cfg(port_config.VAEConfig, cfg)),
                   params)
    want = jax_apply(mod, params, z, method=jax_vae.AutoencoderKL.decode)
    assert_close(port.decode(torch.from_numpy(z)), want, 1e-4)
    want_z = jax_apply(mod, params, img,
                       method=jax_vae.AutoencoderKL.encode)
    assert_close(port.encode(torch.from_numpy(img)), want_z, 1e-4)


def test_clip_text_and_vision():
    rng = np.random.default_rng(7)
    tcfg = jax_config.CLIPTextConfig(hidden_size=64, intermediate_size=128,
                                     num_layers=2, num_heads=2,
                                     vocab_size=300)
    ids = rng.integers(0, 299, (2, 77)).astype(np.int32)
    ids[:, 20] = 299
    tmod = jax_clip.CLIPTextEncoder(tcfg)
    tparams = init_params(tmod, 8, ids)
    want, want_pooled = jax_apply(tmod, tparams, ids, eos_token_id=299)
    tport = port_of(CLIPTextEncoder(port_cfg(port_config.CLIPTextConfig,
                                             tcfg)), tparams)
    got, got_pooled = tport(torch.from_numpy(ids).long(), eos_token_id=299)
    assert_close(got, want, 1e-4)
    assert_close(got_pooled, want_pooled, 1e-4)

    vcfg = jax_config.CLIPVisionConfig(image_size=28, patch_size=14,
                                       hidden_size=32, intermediate_size=64,
                                       num_layers=3, num_heads=2)
    px = rng.standard_normal((3, 28, 28, 3), np.float32)
    vmod = jax_clip.CLIPVisionEncoder(vcfg)
    vparams = init_params(vmod, 9, px)
    want_post, want_pen = jax_apply(vmod, vparams, px)
    vport = port_of(CLIPVisionEncoder(port_cfg(port_config.CLIPVisionConfig,
                                               vcfg)), vparams)
    got_post, got_pen = vport(torch.from_numpy(px))
    assert_close(got_post, want_post, 1e-4)
    assert_close(got_pen, want_pen, 1e-4)


def test_proj_plus_model():
    rng = np.random.default_rng(10)
    ids = rng.standard_normal((2, 16), np.float32)
    clip = rng.standard_normal((2, 5, 32), np.float32)
    mod = jax_adapter.ProjPlusModel(cross_attention_dim=64,
                                    id_embeddings_dim=16,
                                    clip_embeddings_dim=32, num_tokens=4)
    params = init_params(mod, 11, ids, clip)
    port = port_of(ProjPlusModel(64, 16, 32, 4), params)
    for shortcut in (False, True):
        want = jax_apply(mod, params, ids, clip, shortcut=shortcut,
                         scale=0.5)
        got = port(torch.from_numpy(ids), torch.from_numpy(clip),
                   shortcut=shortcut, scale=0.5)
        assert_close(got, want, 1e-4)


def test_facial_encoder():
    """Two valid slots and three padded ones (index 0, as the host prepare
    pads them): padded slots leave the prompt embedding as it was."""
    rng = np.random.default_rng(12)
    prompt = rng.standard_normal((2, 20, 64), np.float32)
    regions = rng.standard_normal((2, 5, 5, 32), np.float32)
    idx = np.array([[3, 7, 0, 0, 0], [5, 9, 0, 0, 0]], np.int32)
    mask = np.array([[1, 1, 0, 0, 0], [1, 1, 0, 0, 0]], bool)
    kw = dict(embedding_dim=32, output_dim=64, embed_dim=64, facial_dim=64,
              facial_depth=2, facial_heads=2, facial_dim_head=64)
    mod = jax_adapter.FacialEncoder(**kw)
    params = init_params(mod, 13, prompt, regions, idx,
                                mask)
    want = jax_apply(mod, params, prompt, regions, idx, mask)
    port = port_of(FacialEncoder(**kw), params)
    got = port(torch.from_numpy(prompt), torch.from_numpy(regions),
               torch.from_numpy(idx), torch.from_numpy(mask))
    assert_close(got, want, 1e-4)
    np.testing.assert_array_equal(got.numpy()[:, 0], prompt[:, 0])


@pytest.mark.parametrize("steps", [3, 50])
def test_ddim_plan(steps):
    cfg = jax_config.SchedulerConfig()
    want = jax_sched.ddim_plan(jax_sched.NoiseSchedule.create(cfg), steps)
    got = port_sched.make_plan(port_sched.NoiseSchedule.create(
        port_cfg(port_config.SchedulerConfig, cfg)), "ddim", steps)
    for field in ("timesteps", "c_in", "coef_x", "coef_e", "coef_n",
                  "noise_x", "noise_e"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.init_scale == want.init_scale
