"""ConsistentID adapter training step (SD1.5; SDXL through
`make_train_step(loss_fn=sdxl_consistentid_loss)`, training/sdxl_loss.py),
on one device or data-parallel over a mesh.

Counterpart of the JAX package's training/train_step.py
(reference train.py:93-292): VAE encode, CLIP encodes and ViT-H under
no_grad, the adapters, the UNet with column-gathered attn2 capture, the
3-term loss, and AdamW (optax semantics, training/optim.py) on the trainable
subset only: proj, facial_encoder and the UNet's LoRA / IP projections.

Parameters live in the bundle's modules. `create_train_state` turns the
trainable subset into fp32 masters with requires_grad; the frozen towers
stay in the bundle's dtype. Every forward runs in the bundle's dtype
(`SD15Bundle.call` casts the masters at use), so gradients and AdamW
moments are fp32, as in the JAX package where flax casts each fp32 weight
at use. The optimizer updates the masters in place.

With `mesh` (parallel/mesh.py; JAX's shard_map over the data axis) each
rank passes its shard of the global batch (`parallel.shard_batch`) and
draws of its own (the CLI seeds them from seed, step and rank, JAX's
`fold_in(rng, axis_index)`); the gradients and the metrics are averaged
over the data group (JAX pmean, :347-349) before AdamW, so every rank keeps
the same masters. A DP step over shards b_0 .. b_{n-1} with draws d_r is
the single-device grad-accumulation step over the micro-batches b_r.

`make_multi_train_step` takes several optimizer steps per call over
stacked batches. `TrainState.state_dict` / `load_state_dict` carry what
resumes a run (io/checkpoint.py).

Random draws are explicit (`Draws`): the latent noise, the timesteps, the
VAE posterior noise and the mask coin. `jax.random` and `torch.Generator`
never agree, so the parity tests reproduce the JAX package's draws and pass
them in; without them a `torch.Generator` makes them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import TrainConfig
from ..models import localization_layer_names
from ..parallel.mesh import all_reduce_mean, data_axis_size
from ..sampling import NoiseSchedule
from .losses import (collect_attn_probs, localization_loss, masked_mse,
                     resize_bilinear)
from .optim import AdamW, make_optimizer

TRAINABLE_UNET_MARKERS = ("_lora", "to_k_ip", "to_v_ip")


def is_trainable_path(name: str) -> bool:
    """proj / facial_encoder fully trainable; in the UNet only LoRA and IP
    projections (reference train.py:182-185). `name` is a dotted state-dict
    name of the bundle."""
    path = name.split(".")
    if path[0] in ("proj", "facial_encoder"):
        return True
    if path[0] == "unet":
        return any(m in part for part in path for m in TRAINABLE_UNET_MARKERS)
    return False


def split_params(module: nn.Module) -> Tuple[List[str], List[str]]:
    """(trainable names, frozen names) of a bundle's parameters."""
    names = [n for n, _ in module.named_parameters()]
    return ([n for n in names if is_trainable_path(n)],
            [n for n in names if not is_trainable_path(n)])


@torch.no_grad()
def warm_start_ip_projections(module: nn.Module) -> None:
    """Initialise each cross-attention's to_k_ip / to_v_ip from its own
    to_k / to_v (reference train.py:168-174). The values are copied into the
    IP weights' own storage, never aliased: to_k_ip is trained in place
    while to_k stays frozen."""
    params = dict(module.named_parameters())
    for name, p in params.items():
        parts = name.split(".")
        if len(parts) < 2 or parts[-2] not in ("to_k_ip", "to_v_ip"):
            continue
        src = ".".join(parts[:-2] + [parts[-2][:-len("_ip")], parts[-1]])
        if src in params:
            p.copy_(params[src])


def merge_params(trainable: Mapping[str, torch.Tensor],
                 frozen: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One state dict of both partitions (a trainable name wins)."""
    return {**frozen, **trainable}


@dataclass
class TrainState:
    """The trainable fp32 masters and the frozen parameters of a bundle (by
    state-dict name; the tensors are the bundle's own), the optimizer and
    the step count."""
    trainable: Dict[str, nn.Parameter]
    frozen: Dict[str, nn.Parameter]
    optimizer: AdamW
    step: int = 0

    def state_dict(self, frozen: bool = False) -> Dict:
        """What resumes training: the masters, AdamW's moments (by the
        masters' names) and count, and the step; with `frozen`, the frozen
        parameters too. The tensors are the live ones, not copies."""
        names = list(self.trainable)
        opt = self.optimizer
        out = {"trainable": {n: p.detach() for n, p in
                             self.trainable.items()},
               "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)),
               "count": opt.count, "step": self.step}
        if frozen:
            out["frozen"] = {n: p.detach() for n, p in self.frozen.items()}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Copy a `state_dict` into this state in place (the bundle's own
        tensors keep their storage); every name must match."""
        names = list(self.trainable)
        for key in ("trainable", "mu", "nu"):
            if list(state[key]) != names:
                raise KeyError(f"{key}: the saved names differ from this "
                               "state's")
        for n, p in self.trainable.items():
            p.copy_(state["trainable"][n])
        opt = self.optimizer
        for i, n in enumerate(names):
            opt.mu[i] = state["mu"][n].to(opt.mu[i].device, opt.mu[i].dtype)
            opt.nu[i] = state["nu"][n].to(opt.nu[i].device, opt.nu[i].dtype)
        opt.count = int(state["count"])
        self.step = int(state["step"])
        if "frozen" in state:
            if set(state["frozen"]) != set(self.frozen):
                raise KeyError("frozen: the saved names differ from this "
                               "state's")
            for n, p in self.frozen.items():
                p.copy_(state["frozen"][n])


def create_train_state(bundle: nn.Module, config: TrainConfig) -> TrainState:
    trainable, frozen = {}, {}
    for name, p in bundle.named_parameters():
        if is_trainable_path(name):
            if p.dtype != torch.float32:
                p.data = p.data.float()
            p.requires_grad_(True)
            trainable[name] = p
        else:
            p.requires_grad_(False)
            frozen[name] = p
    return TrainState(trainable=trainable, frozen=frozen,
                      optimizer=make_optimizer(config,
                                               list(trainable.values())))


@dataclass
class Draws:
    """The random inputs of one (micro-)batch's loss."""
    noise: torch.Tensor       # latents' shape, standard normal
    timesteps: torch.Tensor   # (B,) int in [0, num_train_timesteps)
    vae_noise: torch.Tensor   # VAE posterior noise, latents' shape
    mask_coin: torch.Tensor   # () uniform in [0, 1)


def make_draws(generator: torch.Generator, latent_shape: Sequence[int],
               num_train_timesteps: int,
               dtype: torch.dtype = torch.float32) -> Draws:
    dev = generator.device
    kw = dict(generator=generator, device=dev)
    return Draws(
        noise=torch.randn(tuple(latent_shape), dtype=dtype, **kw),
        timesteps=torch.randint(0, num_train_timesteps,
                                (latent_shape[0],), **kw),
        vae_noise=torch.randn(tuple(latent_shape), dtype=dtype, **kw),
        mask_coin=torch.rand((), **kw))


def batch_to_tensors(batch: Mapping, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """numpy or tensor batch -> tensors on `device`; integer fields
    (token ids, facial indices) as int64."""
    out = {}
    for key, val in batch.items():
        t = (torch.from_numpy(np.ascontiguousarray(val))
             if isinstance(val, np.ndarray) else val)
        if not t.dtype.is_floating_point and t.dtype != torch.bool:
            t = t.long()
        out[key] = t.to(device)
    return out


def latent_shape(bundle, batch: Mapping) -> Tuple[int, ...]:
    """Shape of the latents a batch of either schema encodes to."""
    if "latent_mean" in batch:
        return tuple(batch["latent_mean"].shape)
    b, h, w, _ = batch["images"].shape
    sf = bundle.vae_scale_factor
    return (b, h // sf, w // sf, bundle.vae_config.latent_channels)


def consistentid_loss(bundle, batch: Mapping[str, torch.Tensor],
                      draws: Draws, *, schedule: NoiseSchedule,
                      config: TrainConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One batch's loss and metrics. batch fields (leading dim B):
      images (B, H, W, 3) in [-1, 1]; clean_ids (B, 77);
      face_pixels (B, S, S, 3); region_pixels (B, 5, S, S, 3);
      faceid_embeds (B, 512); facial_idx (B, 5) int, facial_idx_mask (B, 5)
      bool; region_masks (B, 5, Hm, Wm); bg_masks (B, Hm, Wm)."""
    b = batch["images"].shape[0]
    with torch.no_grad():       # frozen encoders
        latents = bundle.vae.encode(batch["images"], noise=draws.vae_noise)
        s = bundle.vision_config.image_size
        n_regions = batch["region_pixels"].shape[1]
        vit_in = torch.cat([batch["face_pixels"],
                            batch["region_pixels"].reshape(-1, s, s, 3)])
        _, penult = bundle.image_encoder(vit_in)
        image_embeds = penult[:b]
        region_embeds = penult[b:].reshape(b, n_regions, *penult.shape[1:])
        prompt_embeds, _ = bundle.text_encoder(batch["clean_ids"])
    return _adapter_losses(bundle, batch, latents, image_embeds,
                           region_embeds, prompt_embeds, draws,
                           schedule=schedule, config=config)


def consistentid_loss_encoded(bundle, batch: Mapping[str, torch.Tensor],
                              draws: Draws, *, schedule: NoiseSchedule,
                              config: TrainConfig
                              ) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """consistentid_loss on precomputed frozen-encoder outputs: batch fields
    latent_mean / latent_logvar (VAE posterior moments), face_embeds /
    region_embeds (ViT-H penultimate states), prompt_embeds, and the
    passthrough fields of consistentid_loss. The posterior is sampled here as
    AutoencoderKL.encode samples it, in the bundle's dtype."""
    dtype = bundle.dtype
    mean = batch["latent_mean"].to(dtype)
    logvar = batch["latent_logvar"].to(dtype)
    sample = mean + torch.exp(0.5 * logvar) * draws.vae_noise.to(dtype)
    latents = sample * bundle.vae_config.scaling_factor
    return _adapter_losses(bundle, batch, latents,
                           batch["face_embeds"].to(dtype),
                           batch["region_embeds"].to(dtype),
                           batch["prompt_embeds"].to(dtype), draws,
                           schedule=schedule, config=config)


def _adapter_losses(bundle, batch, latents, image_embeds, region_embeds,
                    prompt_embeds, draws: Draws, *, schedule: NoiseSchedule,
                    config: TrainConfig,
                    added_cond: Optional[Dict[str, torch.Tensor]] = None):
    """Shared tail of the SD1.5 and SDXL objectives (reference
    train.py:41-91, train_SDXL.py:36-132): q-sample, adapters (the ID
    projection with the adapter config's shortcut, off for SD1.5), UNet
    with column-gathered attention capture (and SDXL's `added_cond`), the
    3-term loss. background_loss is computed and logged, never added to the
    loss (as in the reference)."""
    dtype = bundle.dtype
    latents = latents.detach()
    noise = draws.noise.to(latents.dtype)
    timesteps = draws.timesteps
    noisy = schedule.add_noise(latents, noise, timesteps)

    a = bundle.adapter_config
    faceid_tokens = bundle.call(bundle.proj,
                                batch["faceid_embeds"].to(dtype),
                                image_embeds.detach(), shortcut=a.shortcut,
                                scale=a.shortcut_scale)
    fused = bundle.call(bundle.facial_encoder, prompt_embeds.detach(),
                        region_embeds.detach(), batch["facial_idx"],
                        batch["facial_idx_mask"])
    context = torch.cat([fused, faceid_tokens], dim=1)

    eps_pred, captured = bundle.call(
        bundle.unet, noisy, timesteps, context,
        capture_layers=localization_layer_names(config.localization_layers),
        capture_cols=batch["facial_idx"], added_cond=added_cond)

    # random foreground masking (p = mask_loss_prob): when it fires, the
    # predict loss itself is computed on masked pred / target
    lat_h, lat_w = latents.shape[1:3]
    bg = resize_bilinear(batch["bg_masks"].float(), (lat_h, lat_w))[..., None]
    apply_mask = (draws.mask_coin.to(bg.device) <
                  config.mask_loss_prob).float()
    mask = apply_mask * bg + (1.0 - apply_mask)
    predict_loss = masked_mse(eps_pred, noise, mask)
    background_loss = masked_mse(eps_pred * bg, noise * bg)  # logged only

    facial_loss = config.facial_weight * localization_loss(
        collect_attn_probs(captured), batch["region_masks"],
        batch["facial_idx"], batch["facial_idx_mask"], pregathered=True)
    loss = predict_loss + facial_loss
    metrics = {"loss": loss, "predict_loss": predict_loss,
               "facial_loss": facial_loss,
               "background_loss": background_loss}
    return loss, {k: v.detach() for k, v in metrics.items()}


LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(bundle, schedule: NoiseSchedule, config: TrainConfig,
                    loss_fn: Optional[LossFn] = None, mesh=None):
    """The train step: step(state, batch, draws=None, generator=None)
    -> (state, metrics).

    With config.grad_accum_steps = n > 1 every batch leaf has leading dims
    (n, B, ...), the gradients and metrics of the n micro-batches are
    averaged (the JAX package's lax.scan, accelerate.accumulate in the
    reference), and `draws` is a list of n Draws. Without draws, they are
    drawn from `generator`. The masters and the optimizer state are updated
    in place; state.step counts the steps. With `mesh` the batch is this
    rank's shard, and gradients and metrics are averaged over the data
    group (module docstring)."""
    loss_impl = loss_fn or consistentid_loss
    accum = config.grad_accum_steps
    t_train = schedule.config.num_train_timesteps

    def step(state: TrainState, batch: Mapping,
             draws=None, generator: Optional[torch.Generator] = None):
        batch = batch_to_tensors(batch, bundle.device)
        micros = ([batch] if accum == 1 else
                  [{k: v[i] for k, v in batch.items()} for i in range(accum)])
        if draws is None:
            if generator is None:
                raise ValueError("pass draws or a torch.Generator")
            draws = [make_draws(generator, latent_shape(bundle, m), t_train,
                                bundle.dtype) for m in micros]
        elif isinstance(draws, Draws):
            draws = [draws]
        if len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} micro-batches")

        params = list(state.trainable.values())
        grads, metrics = None, None
        for micro, d in zip(micros, draws):
            loss, m = loss_impl(bundle, micro, d, schedule=schedule,
                                config=config)
            # every trainable leaf must reach the loss: a leaf cut off from
            # it raises here instead of training on a zero gradient
            g = torch.autograd.grad(loss, params)
            if grads is None:
                grads, metrics = g, m
            else:
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
        if accum > 1:
            grads = [x / accum for x in grads]
            metrics = {k: v / accum for k, v in metrics.items()}
        if data_axis_size(mesh) > 1:
            grads = all_reduce_mean(list(grads), mesh.data_group)
            keys = list(metrics)
            metrics = dict(zip(keys, all_reduce_mean(
                [metrics[k].detach() for k in keys], mesh.data_group)))
        state.optimizer.step(grads)
        state.step += 1
        return state, metrics

    return step


def make_multi_train_step(bundle, schedule: NoiseSchedule,
                          config: TrainConfig, n_steps: int,
                          loss_fn: Optional[LossFn] = None, mesh=None):
    """N optimizer steps per call: multi(state, batches, draws=None,
    generator=None) -> (state, metrics stacked (n_steps,)).

    Every batch leaf has a leading n_steps dimension, (n_steps, B, ...) or
    (n_steps, accum, B, ...) under gradient accumulation. `draws` is a list
    of n_steps entries, each what `make_train_step`'s step takes (a Draws,
    or a list of accum Draws); without it they are drawn from `generator`
    in step order. So the N steps equal N calls of `make_train_step` on
    the same draws (the JAX package's lax.scan that folds one rng per
    step)."""
    step = make_train_step(bundle, schedule, config, loss_fn, mesh)

    def multi(state: TrainState, batches: Mapping, draws=None,
              generator: Optional[torch.Generator] = None):
        batches = batch_to_tensors(batches, bundle.device)
        for key, val in batches.items():
            if val.shape[0] != n_steps:
                raise ValueError(f"{key}: leading dim {val.shape[0]}, "
                                 f"expected n_steps = {n_steps}")
        if draws is not None and len(draws) != n_steps:
            raise ValueError(f"{len(draws)} draws for {n_steps} steps")
        metrics = []
        for i in range(n_steps):
            state, m = step(state, {k: v[i] for k, v in batches.items()},
                            None if draws is None else draws[i], generator)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    return multi
