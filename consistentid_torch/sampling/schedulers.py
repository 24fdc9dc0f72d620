"""Noise schedule and DDIM step plan (numpy), copied from the JAX package's
sampling/schedulers.py. Every sampler step is affine:
    x_{i+1} = coef_x[i] * x_i + coef_e[i] * eps_i + coef_n[i] * z_i,
    unet input = c_in[i] * x_i at table timestep[i].
Schedule math matches the diffusers configs SD ships with (scaled_linear
betas 0.00085..0.012, 1000 steps, leading spacing, steps_offset 1,
set_alpha_to_one False). Only DDIM (the default) is ported so far.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from ..core.config import SchedulerConfig


@dataclass(frozen=True)
class NoiseSchedule:
    """Training-time forward process: the fp32 numpy table and q-sampling
    on torch tensors."""

    alphas_cumprod: np.ndarray  # (num_train_timesteps,)
    config: SchedulerConfig

    @staticmethod
    def create(config: SchedulerConfig) -> "NoiseSchedule":
        n = config.num_train_timesteps
        if config.beta_schedule == "scaled_linear":
            betas = np.linspace(config.beta_start ** 0.5,
                                config.beta_end ** 0.5, n,
                                dtype=np.float64) ** 2
        elif config.beta_schedule == "linear":
            betas = np.linspace(config.beta_start, config.beta_end, n,
                                dtype=np.float64)
        else:
            raise ValueError(config.beta_schedule)
        acp = np.cumprod(1.0 - betas).astype(np.float32)
        return NoiseSchedule(alphas_cumprod=acp, config=config)

    def _coefs(self, x0: torch.Tensor, t: torch.Tensor):
        acp = torch.as_tensor(self.alphas_cumprod, device=x0.device)[
            t.long()].to(x0.dtype)
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return torch.sqrt(acp).reshape(shape), \
            torch.sqrt(1.0 - acp).reshape(shape)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1 - acp_t) eps, with the
        coefficients in x0's dtype."""
        a, s = self._coefs(x0, t)
        return a * x0 + s * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        """v-prediction target: sqrt(acp_t) eps - sqrt(1 - acp_t) x0."""
        a, s = self._coefs(x0, t)
        return a * noise - s * x0


@dataclass(frozen=True)
class SamplerPlan:
    """Per-step coefficients of an affine sampler."""

    timesteps: np.ndarray   # (T,) float32, unet conditioning timesteps
    c_in: np.ndarray        # (T,) model-input scale
    coef_x: np.ndarray      # (T,)
    coef_e: np.ndarray      # (T,)
    coef_n: np.ndarray      # (T,) ancestral-noise scale (0 for ODE samplers)
    init_scale: float       # initial latent multiplier
    noise_x: np.ndarray     # (T,) img2img noising: noise_x*x0 + noise_e*eps
    noise_e: np.ndarray     # (T,)

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


def _leading_timesteps(config: SchedulerConfig, num_steps: int) -> np.ndarray:
    ratio = config.num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
    return ts + config.steps_offset


def ddim_plan(schedule: NoiseSchedule, num_steps: int) -> SamplerPlan:
    """DDIM eta=0 (the reference SD1.5 default scheduler path)."""
    cfg = schedule.config
    acp = schedule.alphas_cumprod.astype(np.float64)
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(acp[0])
    ts = _leading_timesteps(cfg, num_steps)
    prev_ts = ts - cfg.num_train_timesteps // num_steps
    a_t = acp[ts]
    a_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)],
                      final_alpha)
    coef_x = np.sqrt(a_prev / a_t)
    coef_e = np.sqrt(1.0 - a_prev) - np.sqrt(a_prev * (1.0 - a_t) / a_t)
    return SamplerPlan(
        timesteps=ts.astype(np.float32),
        c_in=np.ones(num_steps, np.float32),
        coef_x=coef_x.astype(np.float32),
        coef_e=coef_e.astype(np.float32),
        coef_n=np.zeros(num_steps, np.float32),
        init_scale=1.0,
        noise_x=np.sqrt(a_t).astype(np.float32),
        noise_e=np.sqrt(1.0 - a_t).astype(np.float32),
    )


PLAN_BUILDERS = {"ddim": ddim_plan}


def make_plan(schedule: NoiseSchedule, name: str,
              num_steps: int) -> SamplerPlan:
    if name not in PLAN_BUILDERS:
        raise ValueError(f"sampler {name!r} is not ported; available: "
                         f"{sorted(PLAN_BUILDERS)}")
    return PLAN_BUILDERS[name](schedule, num_steps)
