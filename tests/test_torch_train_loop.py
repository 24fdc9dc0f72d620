"""The PyTorch port's training loop on the CPU: the SDXL loss against the
JAX package's (the tiny SDXL bundle, fp32, numpy-drawn parameters carried
across with params_from_jax, JAX's draws handed over as Draws), UNet
rematerialisation against the step without it, make_multi_train_step
against sequential steps, checkpoint resume against an uninterrupted run,
export_adapter_numpy against JAX's keys and values, and the precompute and
train CLIs on a PNG corpus.

Limits: the SDXL loss and its terms relative 1e-5 and each trainable
gradient within 1e-4 of its leaf's largest element (the SD1.5 parity
test's, fp32 summed in other orders); remat the JAX package's own
(`test_remat_policy_matches_no_remat`: loss relative 1e-5, the updated
masters rtol 2e-4, atol 2e-6); everything the port does twice on the same
inputs (multi-step, resume) bit for bit. JAX's loss and gradient are
jitted once.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistentid_tpu.core import config as jax_config
from consistentid_tpu.io import checkpoint as jax_checkpoint
from consistentid_tpu.sampling import schedulers as jax_sched
from consistentid_tpu.testing import tiny_sdxl_bundle as jax_tiny_sdxl
from consistentid_tpu.training import sdxl_loss as jax_sdxl_loss
from consistentid_tpu.training import train_step as jax_ts
from consistentid_torch.apps import precompute as precompute_cli
from consistentid_torch.apps import train as train_cli
from consistentid_torch.core import SchedulerConfig, TrainConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.io.checkpoint import (CheckpointManager,
                                              export_adapter_numpy)
from consistentid_torch.io.from_jax import tree_from_module
from consistentid_torch.ops import flash_attention as port_flash
from consistentid_torch.sampling import NoiseSchedule
from consistentid_torch.testing import tiny_bundle, tiny_sdxl_bundle
from consistentid_torch.training import (create_train_state, make_draws,
                                         make_multi_train_step,
                                         make_train_step,
                                         sdxl_consistentid_loss,
                                         synthetic_batch)
from consistentid_torch.training.train_step import batch_to_tensors
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_sdxl import _draw_params
from test_torch_train_data import _write_corpus
from test_torch_training import (_assert_grads, _assert_metrics, _jax_draws,
                                 _key_with_coin, _trainable_tree)

SCHED = NoiseSchedule.create(SchedulerConfig())
SDXL_PX = 128        # level 1's self-attention: 32 x 32 = 1024 tokens


def _sdxl_batch():
    """The SD1.5 synthetic batch at 128 px with SDXL's fields: the second
    tower's ids and the time ids (original size, crop corner, target)."""
    batch = synthetic_batch(2, SDXL_PX, 28, 16, seed=4)
    batch["clean_ids2"] = np.roll(batch["clean_ids"], 3, axis=1)
    batch["time_ids"] = np.tile(np.array(
        [[SDXL_PX, SDXL_PX, 0, 0, SDXL_PX, SDXL_PX]], np.float32), (2, 1))
    return batch


@pytest.fixture(scope="module")
def sdxl_world():
    """The tiny SDXL bundles of both packages on one parameter set, and
    JAX's SDXL loss with its trainable gradient, jitted once."""
    jb = jax_tiny_sdxl()
    pb = tiny_sdxl_bundle(device="cpu")
    params = _draw_params(tree_from_module(pb)[0], 1)
    trainable, frozen = jax_ts.split_params(params)
    config = jax_config.TrainConfig(localization_layers=3)
    sched = jax_sched.NoiseSchedule.create(jax_config.SchedulerConfig())

    @jax.jit
    def loss_and_grad(tr, batch, rng):
        def loss(t):
            return jax_sdxl_loss.sdxl_consistentid_loss(
                jax_ts.merge_params(t, frozen), batch, rng, bundle=jb,
                schedule=sched, config=config)
        return jax.grad(loss, has_aux=True)(tr)

    return dict(params=params, trainable=trainable, fn=loss_and_grad)


@pytest.mark.parametrize("coin", [True, False])
def test_sdxl_loss_and_grads_match_jax(sdxl_world, coin):
    """sdxl_consistentid_loss with JAX's draws, both mask branches: the loss
    and its terms, and every trainable gradient; the level-1
    self-attentions (1024 tokens) go through the flash Function, 3 calls."""
    batch = _sdxl_batch()
    key = _key_with_coin(coin)
    grads, metrics = sdxl_world["fn"](
        sdxl_world["trainable"],
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    bundle = tiny_sdxl_bundle(device="cpu")
    bundle.load_state_dict(params_from_jax(sdxl_world["params"]),
                           strict=True)
    state = create_train_state(bundle, TrainConfig(localization_layers=3))
    calls = []
    real = port_flash.FlashAttentionFunction.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    port_flash.FlashAttentionFunction.apply = spy
    try:
        lat = SDXL_PX // bundle.vae_scale_factor
        loss, got = sdxl_consistentid_loss(
            bundle, batch_to_tensors(batch, bundle.device),
            _jax_draws(key, (2, lat, lat, 4)), schedule=SCHED,
            config=TrainConfig(localization_layers=3))
        g = torch.autograd.grad(loss, list(state.trainable.values()))
    finally:
        port_flash.FlashAttentionFunction.apply = real
    assert calls == [(2, 2, 1024, 32)] * 3
    _assert_metrics(got, metrics)
    _assert_grads(dict(zip(state.trainable, g)), _trainable_tree(
        jax.tree_util.tree_map(np.asarray, grads)))


def _one_step(remat, policy, sdxl=False):
    """One train step of a fresh tiny bundle (seed 0) on fixed draws: the
    loss, the updated masters and the K2 calls (the Function's forward)."""
    if sdxl:
        bundle = tiny_sdxl_bundle(device="cpu")
        batch, lat, loss_fn = _sdxl_batch(), SDXL_PX // 2, \
            sdxl_consistentid_loss
        config = TrainConfig(localization_layers=3)
    else:
        bundle = tiny_bundle(device="cpu")
        batch, lat, loss_fn = synthetic_batch(2, 64, 28, 16), 32, None
        config = TrainConfig()
    bundle.remat, bundle.remat_policy = remat, policy
    state = create_train_state(bundle, config)
    draws = make_draws(torch.Generator().manual_seed(3), (2, lat, lat, 4),
                       1000)
    k2 = []
    real = port_flash.flash_attention_lse

    def spy(*args):
        k2.append(tuple(args[0].shape))
        return real(*args)

    port_flash.flash_attention_lse = spy
    try:
        step = make_train_step(bundle, SCHED, config, loss_fn=loss_fn)
        state, metrics = step(state, batch, draws)
    finally:
        port_flash.flash_attention_lse = real
    return float(metrics["loss"]), state.trainable, len(k2)


@pytest.mark.parametrize("sdxl", [False, True], ids=["sd15", "sdxl"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy, sdxl):
    """Remat is memory for compute only: the loss and the updated masters
    of the JAX package's remat test's limits. The self-attentions of the
    blocks not captured run K2 twice (SD1.5: down_0 and both up_3 blocks of
    the tiny UNet, 3 -> 6 calls; SDXL: the tiny level 1's down_1 block and
    the two of up_1, which is captured, 3 -> 4)."""
    loss_ref, ref, k2_ref = _one_step(False, "full", sdxl)
    loss, got, k2 = _one_step(True, policy, sdxl)
    assert (k2_ref, k2) == ((3, 4) if sdxl else (3, 6))
    assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref)
    for name, w in ref.items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   w.detach().numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=name)


def test_train_config_remat_policy():
    assert TrainConfig(remat_unet=True, remat_policy="dots").remat_unet
    with pytest.raises(ValueError, match="remat_policy"):
        TrainConfig(remat_unet=True, remat_policy="everything")


def test_multi_train_step_matches_sequential():
    """Two steps in one call against two calls of make_train_step: with
    explicit draws and with draws from a generator, the same losses and
    masters bit for bit; the batches' leading dim must be n_steps."""
    batches = [synthetic_batch(2, 64, 28, 16, seed=s) for s in (1, 2)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    draws = [make_draws(torch.Generator().manual_seed(s), (2, 32, 32, 4),
                        1000) for s in (5, 6)]
    runs = []
    for multi in (False, True):
        for explicit in (True, False):
            bundle = tiny_bundle(device="cpu")
            state = create_train_state(bundle, TrainConfig())
            gen = torch.Generator().manual_seed(9)
            kw = ({"draws": draws} if explicit else {"generator": gen})
            if multi:
                fn = make_multi_train_step(bundle, SCHED, TrainConfig(), 2)
                state, m = fn(state, stacked, **kw)
                losses = m["loss"].tolist()
                assert m["loss"].shape == (2,)
            else:
                fn = make_train_step(bundle, SCHED, TrainConfig())
                losses = []
                for i, b in enumerate(batches):
                    state, m = fn(state, b, draws[i] if explicit else None,
                                  None if explicit else gen)
                    losses.append(float(m["loss"]))
            assert state.step == 2
            runs.append((explicit, losses, state))
    for explicit in (True, False):
        (_, l0, s0), (_, l1, s1) = [r for r in runs if r[0] == explicit]
        assert l0 == l1
        for name, p in s0.trainable.items():
            assert torch.equal(p, s1.trainable[name]), name
    with pytest.raises(ValueError, match="n_steps"):
        make_multi_train_step(tiny_bundle(device="cpu"), SCHED,
                              TrainConfig(), 3)(
            create_train_state(tiny_bundle(device="cpu"), TrainConfig()),
            stacked, generator=torch.Generator())


def test_checkpoint_resume_continues_exactly(tmp_path):
    """Steps 1-3 saved (bf16 first moments), a second state restored from
    step 2 and stepped on: its step 3 equals the uninterrupted run's, bit
    for bit (masters and AdamW's moments and count); max_to_keep drops the
    oldest; save_frozen carries the frozen parameters."""
    cfg = TrainConfig(mu_dtype="bfloat16")
    batch = synthetic_batch(2, 64, 28, 16)
    draws = [make_draws(torch.Generator().manual_seed(s), (2, 32, 32, 4),
                        1000) for s in range(3)]
    bundle = tiny_bundle(device="cpu")
    state = create_train_state(bundle, cfg)
    step = make_train_step(bundle, SCHED, cfg)
    ckpt = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    assert ckpt.latest_step() is None
    for d in draws[:2]:
        state, _ = step(state, batch, d)
        ckpt.save(state)
    state, _ = step(state, batch, draws[2])
    ckpt.save(state)
    assert ckpt.all_steps() == [2, 3]

    # the same frozen towers (a run loads them from its base checkpoint),
    # trainable masters that the restore must overwrite
    other = tiny_bundle(device="cpu")
    fresh = create_train_state(other, cfg)
    with torch.no_grad():
        for p in fresh.trainable.values():
            p.add_(1.0)
    resumed = CheckpointManager(str(tmp_path / "run")).restore(fresh,
                                                               step=2)
    assert resumed.step == 2 and resumed.optimizer.count == 2
    assert resumed.optimizer.mu[0].dtype == torch.bfloat16
    resumed, _ = make_train_step(other, SCHED, cfg)(resumed, batch, draws[2])
    for name, p in state.trainable.items():
        assert torch.equal(resumed.trainable[name], p), name
    for a, b in zip(resumed.optimizer.mu + resumed.optimizer.nu,
                    state.optimizer.mu + state.optimizer.nu):
        assert torch.equal(a, b)

    frozen = CheckpointManager(str(tmp_path / "frozen"), save_frozen=True)
    frozen.save(state)
    third = create_train_state(tiny_bundle(device="cpu", seed=6), cfg)
    frozen.restore(third)
    for name, p in state.frozen.items():
        assert torch.equal(third.frozen[name], p), name


def test_export_adapter_numpy_matches_jax():
    """The trainable adapter as JAX's export writes it: the same "/" keys,
    the same arrays (kernels transposed back)."""
    bundle = tiny_sdxl_bundle(device="cpu")
    params = _draw_params(tree_from_module(bundle)[0], 2)
    bundle.load_state_dict(params_from_jax(params), strict=True)
    want = jax_checkpoint.export_adapter_numpy(
        jax_ts.split_params(params)[0])
    got = export_adapter_numpy(bundle)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("proj/") for k in got)
    assert any("to_k_ip" in k for k in got)
    for key, w in want.items():   # the draws are float64, the bundle fp32
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], w.astype(np.float32),
                                      err_msg=key)


def test_precompute_then_train_encoded_cli(tmp_path):
    """apps.precompute on a PNG corpus, then apps.train --encoded for 2
    steps on the CPU: the checkpoint restores at step 2."""
    manifest = _write_corpus(tmp_path, n=2)
    out = str(tmp_path / "enc")
    assert precompute_cli.main([
        "--tiny", "--device", "cpu", "--manifest", manifest,
        "--data-root", str(tmp_path), "--out", out, "--resolution", "32",
        "--batch-size", "4", "--dtype", "fp32"]) == 0
    run_dir = str(tmp_path / "runs")
    run = train_cli.main([
        "--tiny", "--device", "cpu", "--encoded",
        "--manifest", f"{out}/encoded_manifest.json",
        "--output-dir", run_dir, "--epochs", "1", "--batch-per-device", "1",
        "--max-steps", "2", "--save-steps", "2", "--localization-layers",
        "3", "--dtype", "fp32"])
    assert run["state"].step == 2 and run["restored_step"] is None
    assert all(np.isfinite(run["losses"]))
    state = create_train_state(tiny_bundle(device="cpu"), TrainConfig())
    assert CheckpointManager(run_dir).restore(state).step == 2
    assert (tmp_path / "runs" / "metrics.jsonl").is_file()


def test_train_cli_flushes_pending_multistep_batches(tmp_path):
    """3 loader batches with --steps-per-call 4: none fills a multi-step
    call, so all three are trained one step each and the checkpoint
    restores at step 3 (as the JAX CLI's test)."""
    manifest = _write_corpus(tmp_path, n=3)
    out = str(tmp_path / "run")
    run = train_cli.main([
        "--tiny", "--device", "cpu", "--manifest", manifest,
        "--data-root", str(tmp_path), "--output-dir", out,
        "--resolution", "32", "--batch-per-device", "1", "--epochs", "1",
        "--steps-per-call", "4", "--max-steps", "100", "--dtype", "fp32",
        "--save-steps", "1000"])
    assert run["steps_per_call"] == [1, 1, 1]
    state = create_train_state(tiny_bundle(device="cpu"), TrainConfig())
    assert CheckpointManager(out).restore(state).step == 3
