"""The PyTorch port's SD1.5 training slice against the JAX package on the
CPU, in fp32: losses, the bilinear resize, the UNet's attention capture,
the trainable partition and IP warm start, AdamW against optax, and the
train step end to end on the tiny bundle (64 px, batch 2: the level-0
self-attention is 1024 x 1024 and reaches the flash Function).

The same parameters (numpy draws in the JAX modules' shapes, carried across
with params_from_jax) and the same batches (the numpy `synthetic_batch`)
go into both. jax.random and torch.Generator never agree, so the JAX
package's draws are reproduced with its own jax.random calls and handed to
the port as explicit Draws.

JAX's train step is compiled once (its compile dominates this file's time).
The gradient of its first step is read back from AdamW's first moment:
from a zero state, mu = (1 - b1) g in fp32, so g = mu / (1 - b1) to one
ulp. Gradient accumulation is held against JAX's own definition of it (the
mean of the micro-batches' gradients, each with the key
fold_in(rng, i), then one AdamW update), built from those same steps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from consistentid_tpu.core import config as jax_config
from consistentid_tpu.models import unet as jax_unet
from consistentid_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from consistentid_tpu.sampling import schedulers as jax_sched
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_tpu.training import losses as jax_losses
from consistentid_tpu.training import train_step as jax_ts
from consistentid_tpu.training.dataset import synthetic_batch as jax_batch
from consistentid_tpu.training.precompute import \
    synthetic_encoded_batch as jax_encoded_batch
from consistentid_torch.core import SchedulerConfig, TrainConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.models import localization_layer_names
from consistentid_torch.ops import flash_attention as port_flash
from consistentid_torch.sampling import NoiseSchedule
from consistentid_torch.testing import tiny_bundle
from consistentid_torch.training import (AdamW, Draws, consistentid_loss,
                                         consistentid_loss_encoded,
                                         create_train_state, losses,
                                         make_train_step, split_params,
                                         synthetic_batch,
                                         synthetic_encoded_batch,
                                         warm_start_ip_projections)
from consistentid_torch.training.train_step import batch_to_tensors
from test_torch_loading import one_torch_thread, tiny_tree_shapes  # noqa: F401

B1 = 0.9


def _t(a):
    return torch.from_numpy(np.array(a))


def _bundle_params(jbundle):
    """Numpy parameters for the whole JAX bundle: kernels ~ N(0, 1/fan_in),
    norm scales ~ 1 + N(0, 0.1), the rest (LoRA up-projections included)
    ~ N(0, 0.1)."""
    shapes = tiny_tree_shapes(jbundle)
    rng = np.random.default_rng(0)

    def draw(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_in = int(np.prod(x.shape[:-1]))
            return rng.standard_normal(x.shape, np.float32) / np.sqrt(fan_in)
        if "scale" in name:
            return 1.0 + 0.1 * rng.standard_normal(x.shape, np.float32)
        return 0.1 * rng.standard_normal(x.shape, np.float32)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), shapes)


def _jax_draws(rng, latent_shape):
    """The draws JAX's consistentid_loss makes from `rng`, as port Draws."""
    r_noise, r_t, r_vae, r_mask = jax.random.split(rng, 4)
    return Draws(
        noise=_t(jax.random.normal(r_noise, latent_shape, jnp.float32)),
        timesteps=_t(jax.random.randint(r_t, (latent_shape[0],), 0, 1000)),
        vae_noise=_t(jax.random.normal(r_vae, latent_shape, jnp.float32)),
        mask_coin=_t(jax.random.uniform(r_mask, ())))


def _key_with_coin(below: bool):
    """A PRNG key whose mask coin fires (below 0.5) or not."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if (float(jax.random.uniform(jax.random.split(key, 4)[3], ()))
                < 0.5) == below:
            return key
    raise AssertionError("no key found")


def _trainable_tree(tree):
    """A JAX tree of trainable leaves -> {port name: tensor}."""
    return params_from_jax({k: v for k, v in tree.items()})


def _first_grads(state):
    """The gradient of a step taken from a zero AdamW state."""
    mu = state.opt_state[0].mu
    return _trainable_tree(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / np.float32(1 - B1), mu))


def _assert_grads(got, want, tol=1e-4):
    """Leaf by leaf, relative to each leaf's largest |grad|: fp32 on both
    sides through the VAE, ViT, CLIP, the adapters and the UNet, summed in
    other orders (the forwards agree to ~1e-5 relative), so 1e-4."""
    assert got.keys() == want.keys()
    for name in want:
        w = want[name].float()
        scale = max(w.abs().max().item(), 1e-12)
        err = (got[name].float() - w).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


def _assert_metrics(got, want):
    """Loss and its terms, relative 1e-5 (fp32 sums in other orders)."""
    for key in ("loss", "predict_loss", "facial_loss", "background_loss"):
        g, w = float(got[key]), float(want[key])
        assert abs(g - w) <= 1e-5 * abs(w) + 1e-9, (key, g, w)


def _assert_params(got, want, grads):
    """Parameters after AdamW steps (lr 1e-4). Where a gradient element is
    at the level of fp32 noise (< 1e-4 of its leaf's largest, where the two
    packages' gradients differ in sign or size), Adam's normalised step
    u = m / (sqrt(v) + eps) turns that noise into a step of up to lr in
    either direction, so those elements are held to 2.5 lr per step; every
    other element to 1e-5 absolute (a tenth of one step)."""
    for name, w in want.items():
        g = got[name].detach()
        gw = grads[name].abs()
        noisy = gw < 1e-4 * gw.max()
        diff = (g - w).abs()
        assert diff[~noisy].max().item() <= 1e-5, (name, "clean")
        if noisy.any():
            assert diff[noisy].max().item() <= 2.5 * 2e-4, (name, "noisy")


@pytest.fixture(scope="module")
def world():
    """Both bundles with the same parameters, and JAX's compiled step."""
    jb = jax_tiny_bundle()
    params = _bundle_params(jb)
    cfg = jax_config.TrainConfig()
    sched = jax_sched.NoiseSchedule.create(jax_config.SchedulerConfig())
    step = jax_ts.make_train_step(jb, sched, cfg)
    state0 = jax_ts.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), cfg)
    return dict(jb=jb, params=params, cfg=cfg, sched=sched, step=step,
                state0=state0)


def _port(world):
    bundle = tiny_bundle(device="cpu")
    bundle.load_state_dict(params_from_jax(world["params"]), strict=True)
    return bundle


PORT_SCHED = NoiseSchedule.create(SchedulerConfig())


def test_losses_match_jax():
    """balanced_l1_loss, localization_loss (gathered here and pregathered)
    and masked_mse on the same arrays: fp32, 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 2, 256, 12), np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    segmaps = (rng.random((2, 5, 64, 64)) > 0.5).astype(np.float32)
    idx = np.array([[3, 7, 11, 0, 0], [1, 2, 4, 9, 0]], np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], bool)
    maps = rng.random((2, 1, 256, 12)).astype(np.float32)
    np.testing.assert_allclose(
        losses.balanced_l1_loss(_t(probs), _t(maps)).numpy(),
        np.asarray(jax_losses.balanced_l1_loss(probs, maps)), rtol=0,
        atol=1e-6)
    gathered = np.take_along_axis(
        probs, np.broadcast_to(idx[:, None, None, :], (2, 2, 256, 5)), 3)
    for arr, pre in ((probs, False), (gathered, True)):
        want = jax_losses.localization_loss(
            [arr, arr * 0.5], segmaps, idx, mask, pregathered=pre)
        got = losses.localization_loss(
            [_t(arr), _t(arr) * 0.5], _t(segmaps), _t(idx), _t(mask),
            pregathered=pre)
        np.testing.assert_allclose(got.item(), float(want), rtol=0,
                                   atol=1e-6)
    pred, target = (rng.standard_normal((2, 8, 8, 4), np.float32)
                    for _ in range(2))
    bg = rng.random((2, 8, 8, 1)).astype(np.float32)
    for m in (None, bg):
        np.testing.assert_allclose(
            losses.masked_mse(_t(pred), _t(target),
                              None if m is None else _t(m)).item(),
            float(jax_losses.masked_mse(pred, target, m)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [(512, 64), (512, 32), (512, 8),
                                     (64, 32), (64, 16), (64, 4)])
def test_resize_matches_jax_image_resize(src, dst):
    """jax.image.resize bilinear antialiases when it downsamples; so does
    the port's resize: 1e-6 on masks in [0, 1]."""
    x = (np.random.default_rng(src + dst).random((2, 3, src, src)) > 0.5
         ).astype(np.float32)
    want = jax.image.resize(x, (2, 3, dst, dst), method="bilinear")
    got = losses.resize_bilinear(_t(x), (dst, dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_unet_capture_matches_jax(world):
    """Column-gathered attn2 probabilities of the five localization blocks,
    in JAX's order, and the UNet output: fp32 through the tiny UNet, 1e-5."""
    jb, params = world["jb"], world["params"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4), np.float32)
    t = np.array([10, 700], np.int32)
    ctx = rng.standard_normal((2, 81, 64), np.float32)
    idx = np.array([[3, 7, 11, 0, 0]] * 2, np.int32)
    names = localization_layer_names(5)
    assert names == jax_unet.localization_layer_names(5)
    want, inter = jax.jit(lambda p: jb.unet.apply(
        {"params": p}, x, t, ctx, capture_layers=names, capture_cols=idx,
        mutable=["intermediates"]))(params["unet"])
    want_probs = jax_losses.collect_attn_probs(inter["intermediates"])
    bundle = _port(world)
    with torch.no_grad():
        got, captured = bundle.unet(_t(x), _t(t), _t(ctx),
                                    capture_layers=names,
                                    capture_cols=_t(idx))
    got_probs = losses.collect_attn_probs(captured)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert len(got_probs) == len(want_probs) == 7
    for g, w in zip(got_probs, want_probs):
        assert g.shape == w.shape and g.shape[-1] == 5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_partition_and_warm_start(world):
    jax_trainable, _ = jax_ts.split_params(world["params"])
    bundle = _port(world)
    trainable, frozen = split_params(bundle)
    assert set(trainable) == set(_trainable_tree(jax_trainable))
    assert not set(trainable) & set(frozen)
    assert any("to_k_ip" in n for n in trainable)
    assert not any("to_k." in n for n in trainable)

    warm = jax_ts.warm_start_ip_projections(world["params"]["unet"])
    warm_start_ip_projections(bundle.unet)
    got = dict(bundle.unet.named_parameters())
    want = params_from_jax(warm)
    pairs = 0
    for name, p in got.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[name].numpy(), err_msg=name)
        if ".to_k_ip." in name or ".to_v_ip." in name:
            src = got[name.replace("_ip.", ".")]
            assert torch.equal(p, src)
            assert p.data_ptr() != src.data_ptr()       # copied, not aliased
            pairs += 1
    assert pairs == 2 * 10   # every attn2: 3 down, 1 mid, 6 up blocks
    before = got["mid_attn.blocks_0.attn2.to_k.weight"].clone()
    with torch.no_grad():
        got["mid_attn.blocks_0.attn2.to_k_ip.weight"].add_(1.0)
    assert torch.equal(got["mid_attn.blocks_0.attn2.to_k.weight"], before)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(mu_dtype):
    """Three steps on a (64, 32) tensor: the same fp32 ops in the same
    order, and mu rounded to mu_dtype at the same place; within 1e-7
    absolute against 3e-4 of movement (fp32 rounding only)."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((64, 32), np.float32)
    grads = [rng.standard_normal((64, 32), np.float32) * 10.0 ** -i
             for i in range(3)]
    opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2,
                      mu_dtype=jnp.dtype(mu_dtype))
    jp, st = jnp.asarray(p0), None
    st = opt.init(jp)
    p = _t(p0)
    port = AdamW([p], 1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2,
                 mu_dtype=getattr(torch, mu_dtype))
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        port.step([_t(g)])
    assert port.mu[0].dtype == getattr(torch, mu_dtype)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        port.mu[0].float().numpy(), np.asarray(st[0].mu.astype(jnp.float32)))
    assert np.abs(p.numpy() - p0).max() > 2e-4


@pytest.fixture(scope="module")
def jax_two_steps(world):
    """JAX, from the initial state: one step with the mask coin firing and
    one without (the loss and gradient of each branch), and two steps in a
    row (the first branch, then the second)."""
    batch = {k: jnp.asarray(v)
             for k, v in jax_batch(2, 64, 28, 16).items()}
    keys = (_key_with_coin(True), _key_with_coin(False))
    first = [world["step"](world["state0"], batch, key) for key in keys]
    s2, m2 = world["step"](first[0][0], batch, keys[1])
    return dict(keys=keys, metrics=[m for _, m in first],
                grads=[_first_grads(s) for s, _ in first],
                first_params=_trainable_tree(jax.tree_util.tree_map(
                    np.asarray, first[0][0].trainable)),
                step_metrics=(first[0][1], m2),
                params=_trainable_tree(jax.tree_util.tree_map(
                    np.asarray, s2.trainable)))


def test_loss_and_grads_match_jax(world, jax_two_steps):
    """consistentid_loss with JAX's draws, both mask branches: the loss, its
    three terms and the gradient of every trainable leaf. The level-0
    self-attention of the port goes through the flash Function (3 calls a
    loss: down_0 and both up_3 blocks)."""
    bundle = _port(world)
    state = create_train_state(bundle, TrainConfig())
    batch = batch_to_tensors(synthetic_batch(2, 64, 28, 16), bundle.device)
    calls = []
    real = port_flash.FlashAttentionFunction.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    port_flash.FlashAttentionFunction.apply = spy
    try:
        for i, key in enumerate(jax_two_steps["keys"]):
            draws = _jax_draws(key, (2, 32, 32, 4))
            loss, metrics = consistentid_loss(
                bundle, batch, draws, schedule=PORT_SCHED,
                config=TrainConfig())
            _assert_metrics(metrics, jax_two_steps["metrics"][i])
            grads = torch.autograd.grad(loss, list(state.trainable.values()))
            _assert_grads(dict(zip(state.trainable, grads)),
                          jax_two_steps["grads"][i])
    finally:
        port_flash.FlashAttentionFunction.apply = real
    assert calls == [(2, 2, 1024, 16)] * 6


def test_two_train_steps_match_jax(world, jax_two_steps):
    bundle = _port(world)
    state = create_train_state(bundle, TrainConfig())
    step = make_train_step(bundle, PORT_SCHED, TrainConfig())
    batch = synthetic_batch(2, 64, 28, 16)
    for i, key in enumerate(jax_two_steps["keys"]):
        state, metrics = step(state, batch, _jax_draws(key, (2, 32, 32, 4)))
        _assert_metrics(metrics, jax_two_steps["step_metrics"][i])
    assert state.step == 2
    _assert_params(state.trainable, jax_two_steps["params"],
                   jax_two_steps["grads"][0])
    frozen = params_from_jax(world["params"])
    for name, p in state.frozen.items():
        assert torch.equal(p, frozen[name]), name


def test_grad_accum_step_matches_jax(world):
    """grad_accum_steps=2 over two different micro-batches: JAX's
    accumulation (mean of the micro-batch gradients with keys
    fold_in(rng, i), then AdamW) against the port's step."""
    micro = [jax_batch(2, 64, 28, 16, seed=s) for s in (0, 1)]
    rng = _key_with_coin(True)
    keys = [jax.random.fold_in(rng, i) for i in range(2)]
    grads, metrics = [], []
    for mb, key in zip(micro, keys):
        s1, m = world["step"](world["state0"],
                              {k: jnp.asarray(v) for k, v in mb.items()},
                              key)
        # fp32 arithmetic in numpy, the same IEEE operations as JAX's: each
        # eager JAX op over the ~300 leaves would compile on its own
        grads.append(jax.tree_util.tree_map(
            lambda x: np.asarray(x) / np.float32(1 - B1),
            s1.opt_state[0].mu))
        metrics.append(m)
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / np.float32(2),
                                  *grads)
    state0 = world["state0"]
    opt = jax_ts.make_optimizer(world["cfg"])
    updated = jax.jit(lambda g, s, p: optax.apply_updates(
        p, opt.update(g, s, p)[0]))(mean, state0.opt_state,
                                    state0.trainable)
    want = _trainable_tree(jax.tree_util.tree_map(np.asarray, updated))
    want_metrics = {k: (np.float32(metrics[0][k]) + np.float32(
        metrics[1][k])) / np.float32(2) for k in metrics[0]}

    cfg = TrainConfig(grad_accum_steps=2)
    bundle = _port(world)
    state = create_train_state(bundle, cfg)
    stacked = {k: np.stack([mb[k] for mb in micro]) for k in micro[0]}
    state, got_metrics = make_train_step(bundle, PORT_SCHED, cfg)(
        state, stacked, [_jax_draws(k, (2, 32, 32, 4)) for k in keys])
    _assert_metrics(got_metrics, want_metrics)
    _assert_params(state.trainable, want,
                   _trainable_tree(jax.tree_util.tree_map(np.asarray, mean)))


def test_synthetic_batches_match_jax(world):
    """The port's copies of synthetic_batch and synthetic_encoded_batch draw
    the JAX package's arrays from the same seed."""
    for seed in (0, 3):
        want = jax_batch(2, 64, 28, 16, seed=seed)
        got = synthetic_batch(2, 64, 28, 16, seed=seed)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = jax_encoded_batch(world["jb"], batch_size=2, latent_hw=32,
                             mask_hw=64)
    got = synthetic_encoded_batch(_port(world), batch_size=2, latent_hw=32,
                                  mask_hw=64)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_encoded_step_matches_jax(world, jax_two_steps):
    """consistentid_loss_encoded on the JAX package's own frozen-encoder
    outputs for the pixel batch. There the JAX package pins its encoded loss
    bitwise to its pixel loss (tests/test_precompute.py), so the port's
    encoded loss, gradients and one step are held against JAX's pixel-path
    results of the first branch."""
    jb, params = world["jb"], world["params"]
    pix = jax_batch(2, 64, 28, 16)

    @jax.jit
    def encode(p, b):
        mean, logvar = jb.vae.apply({"params": p["vae"]}, b["images"],
                                    method=JaxAutoencoderKL.encode_moments)
        vit_in = jnp.concatenate(
            [b["face_pixels"], b["region_pixels"].reshape(-1, 28, 28, 3)])
        _, penult = jb.image_encoder.apply({"params": p["image_encoder"]},
                                           vit_in)
        prompt, _ = jb.text_encoder.apply({"params": p["text_encoder"]},
                                          b["clean_ids"])
        return dict(latent_mean=mean, latent_logvar=logvar,
                    face_embeds=penult[:2],
                    region_embeds=penult[2:].reshape(2, 5, *penult.shape[1:]),
                    prompt_embeds=prompt)

    batch = {k: pix[k] for k in ("faceid_embeds", "facial_idx",
                                 "facial_idx_mask", "region_masks",
                                 "bg_masks")}
    batch.update({k: np.asarray(v) for k, v in encode(params, pix).items()})
    key = jax_two_steps["keys"][0]
    draws = _jax_draws(key, (2, 32, 32, 4))

    bundle = _port(world)
    state = create_train_state(bundle, TrainConfig())
    loss, metrics = consistentid_loss_encoded(
        bundle, batch_to_tensors(batch, bundle.device), draws,
        schedule=PORT_SCHED, config=TrainConfig())
    _assert_metrics(metrics, jax_two_steps["metrics"][0])
    grads = dict(zip(state.trainable, torch.autograd.grad(
        loss, list(state.trainable.values()))))
    _assert_grads(grads, jax_two_steps["grads"][0])
    step = make_train_step(bundle, PORT_SCHED, TrainConfig(),
                           loss_fn=consistentid_loss_encoded)
    state, _ = step(state, batch, draws)
    _assert_params(state.trainable, jax_two_steps["first_params"],
                   jax_two_steps["grads"][0])


def test_train_step_refuses_a_leaf_cut_off_from_the_loss():
    """A trainable leaf the loss does not reach raises instead of taking a
    zero gradient (and a weight-decay-only update); nothing is updated."""
    bundle = tiny_bundle(device="cpu", seed=1)
    state = create_train_state(bundle, TrainConfig())
    first = next(iter(state.trainable.values()))
    before = {n: p.detach().clone() for n, p in state.trainable.items()}

    def loss_fn(bundle, batch, draws, *, schedule, config):
        loss = first.square().sum()
        return loss, {"loss": loss.detach()}

    step = make_train_step(bundle, PORT_SCHED, TrainConfig(), loss_fn=loss_fn)
    draws = Draws(noise=torch.zeros(2, 32, 32, 4),
                  timesteps=torch.zeros(2, dtype=torch.long),
                  vae_noise=torch.zeros(2, 32, 32, 4),
                  mask_coin=torch.zeros(()))
    with pytest.raises(RuntimeError, match="not have been used"):
        step(state, synthetic_batch(2, 64, 28, 16), draws)
    assert state.step == 0
    for name, p in state.trainable.items():
        assert torch.equal(p, before[name]), name
