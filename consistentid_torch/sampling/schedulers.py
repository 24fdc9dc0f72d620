"""Noise schedule and sampler step plans (numpy), copied from the JAX
package's sampling/schedulers.py with every constant computed the same way
(float64, then float32), so the plans are the same bits. Five samplers:
DDIM eta=0, Euler discrete and ancestral DDPM are affine,
    x_{i+1} = coef_x[i] * x_i + coef_e[i] * eps_i + coef_n[i] * z_i,
    unet input = c_in[i] * x_i at table timestep[i];
DPM-Solver++(2M) and PNDM (PLMS) add multistep tables (`SamplerPlan`).
Schedule math matches the diffusers configs SD ships with (scaled_linear
betas 0.00085..0.012, 1000 steps, leading spacing, steps_offset 1,
set_alpha_to_one False).
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
    """Per-step coefficients of a sampler (sampling/sampler.py `denoise`).

    kind="affine": x' = coef_x*x + coef_e*eps + coef_n*z.
    kind="dpmpp_2m": DPM-Solver++(2M) — x0 = (x - c_sigma*eps)/c_alpha,
      D = first step: x0; later: (1+1/(2r))*x0 - 1/(2r)*prev_x0,
      x' = ratio*x - gamma*D, with r = h_prev/h in lambda-space.
    """

    timesteps: np.ndarray   # (T,) float32, unet conditioning timesteps
    c_in: np.ndarray        # (T,) model-input scale
    coef_x: np.ndarray      # (T,)
    coef_e: np.ndarray      # (T,)
    coef_n: np.ndarray      # (T,) ancestral-noise scale (0 for ODE samplers)
    init_scale: float       # initial latent multiplier
    # img2img/inpaint noising tables, in the plan's OWN latent space:
    # "clean latents noised to table step i" = noise_x[i]*x0 + noise_e[i]*eps.
    # VP-space plans (ddim/ddpm/dpmpp): sqrt(acp_t), sqrt(1-acp_t);
    # sigma-space plans (euler): 1, sigma_t.
    noise_x: np.ndarray = None  # (T,)
    noise_e: np.ndarray = None  # (T,)
    kind: str = "affine"
    # dpmpp_2m extras (None for affine plans)
    c_alpha: np.ndarray | None = None   # (T,) sqrt(acp_t)
    c_sigma: np.ndarray | None = None   # (T,) sqrt(1-acp_t)
    ratio: np.ndarray | None = None     # (T,) sigma_{t+1}/sigma_t
    gamma: np.ndarray | None = None     # (T,) alpha_{t+1}*(exp(-h)-1)
    rr: np.ndarray | None = None        # (T,) 1/(2r), 0 at step 0
    # pndm (PLMS) extras: per-step linear-multistep weights over
    # [eps_new, hist[0], hist[1], hist[2]] and the counter-1 flag that
    # re-applies the first transfer from the held cur_sample
    plms_w: np.ndarray | None = None    # (T, 4)
    use_cur: np.ndarray | None = None   # (T,) 0/1

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


def euler_plan(schedule: NoiseSchedule, num_steps: int) -> SamplerPlan:
    """Euler discrete (the reference infer.py:33 swaps this in)."""
    cfg = schedule.config
    acp = schedule.alphas_cumprod.astype(np.float64)
    sigmas_full = np.sqrt((1.0 - acp) / acp)
    ts = _leading_timesteps(cfg, num_steps).astype(np.float64)
    sigmas = np.interp(ts, np.arange(cfg.num_train_timesteps), sigmas_full)
    sigmas_next = np.concatenate([sigmas[1:], [0.0]])
    return SamplerPlan(
        timesteps=ts.astype(np.float32),
        c_in=(1.0 / np.sqrt(sigmas ** 2 + 1.0)).astype(np.float32),
        coef_x=np.ones(num_steps, np.float32),
        coef_e=(sigmas_next - sigmas).astype(np.float32),
        coef_n=np.zeros(num_steps, np.float32),
        # leading spacing: init sigma is sqrt(sigma_max^2 + 1)
        init_scale=float(np.sqrt(sigmas[0] ** 2 + 1.0)),
        # euler latents live in sigma space: x = x0 + sigma*eps
        noise_x=np.ones(num_steps, np.float32),
        noise_e=sigmas.astype(np.float32),
    )


def ddpm_plan(schedule: NoiseSchedule, num_steps: int) -> SamplerPlan:
    """Ancestral DDPM sampling (variance type fixed_small)."""
    cfg = schedule.config
    acp = schedule.alphas_cumprod.astype(np.float64)
    ts = _leading_timesteps(cfg, num_steps)
    prev_ts = ts - cfg.num_train_timesteps // num_steps
    a_t = acp[ts]
    a_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)], 1.0)
    alpha_step = a_t / a_prev
    beta_step = 1.0 - alpha_step
    coef_x = 1.0 / np.sqrt(alpha_step)
    coef_e = -beta_step / (np.sqrt(1.0 - a_t) * np.sqrt(alpha_step))
    var = beta_step * (1.0 - a_prev) / (1.0 - a_t)
    coef_n = np.sqrt(np.maximum(var, 0.0))
    coef_n[-1] = 0.0
    return SamplerPlan(
        timesteps=ts.astype(np.float32),
        c_in=np.ones(num_steps, np.float32),
        coef_x=coef_x.astype(np.float32),
        coef_e=coef_e.astype(np.float32),
        coef_n=coef_n.astype(np.float32),
        init_scale=1.0,
        noise_x=np.sqrt(a_t).astype(np.float32),
        noise_e=np.sqrt(1.0 - a_t).astype(np.float32),
    )


def dpmpp_2m_plan(schedule: NoiseSchedule, num_steps: int) -> SamplerPlan:
    """DPM-Solver++(2M), deterministic multistep — matches 50-step DDIM
    quality at ~20-25 steps (data-prediction form; a throughput upgrade over
    the reference's DDIM/Euler set)."""
    cfg = schedule.config
    acp = schedule.alphas_cumprod.astype(np.float64)
    ts = _leading_timesteps(cfg, num_steps)
    alphas = np.sqrt(acp[ts])
    sigmas = np.sqrt(1.0 - acp[ts])
    lambdas = np.log(alphas / sigmas)
    # target (next) nodes; final node is the clean sample (lambda -> +inf)
    a_next = np.concatenate([alphas[1:], [1.0]])
    s_next = np.concatenate([sigmas[1:], [0.0]])
    with np.errstate(divide="ignore"):
        l_next = np.where(s_next > 0, np.log(a_next / np.maximum(s_next,
                                                                 1e-12)),
                          np.inf)
    h = l_next - lambdas                         # (T,)
    h_prev = np.concatenate([[h[0]], h[:-1]])
    with np.errstate(divide="ignore", invalid="ignore"):
        r = h_prev / h
        rr = np.where(np.arange(num_steps) == 0, 0.0, 1.0 / (2.0 * r))
    ratio = np.where(sigmas > 0, s_next / np.maximum(sigmas, 1e-12), 0.0)
    gamma = a_next * (np.exp(-h) - 1.0)
    # final step (h=inf): lower-order-final first-order update x' = x0
    gamma = np.where(np.isinf(h), -a_next, gamma)
    rr = np.where(np.isinf(h) | ~np.isfinite(rr), 0.0, rr)
    return SamplerPlan(
        timesteps=ts.astype(np.float32),
        c_in=np.ones(num_steps, np.float32),
        coef_x=np.zeros(num_steps, np.float32),
        coef_e=np.zeros(num_steps, np.float32),
        coef_n=np.zeros(num_steps, np.float32),
        init_scale=1.0,
        noise_x=alphas.astype(np.float32),
        noise_e=sigmas.astype(np.float32),
        kind="dpmpp_2m",
        c_alpha=alphas.astype(np.float32),
        c_sigma=sigmas.astype(np.float32),
        ratio=ratio.astype(np.float32),
        gamma=gamma.astype(np.float32),
        rr=rr.astype(np.float32),
    )


def pndm_plan(schedule: NoiseSchedule, num_steps: int) -> SamplerPlan:
    """PNDM with skip_prk_steps (= PLMS), the stock scheduler the reference
    SD1.5 base pipeline carries before infer.py:33 swaps Euler in.

    The diffusers PLMS loop makes num_steps+1 UNet evaluations: the first
    two (at t_max and t_max-step, the duplicated entry in its timestep
    array) jointly form one improved-Euler warmup step re-applied from the
    held cur_sample; afterwards each eval is a 2nd/3rd/4th-order
    Adams-Bashforth combination of the stored eps history. Expressed here
    as per-eval tables: the marginal-transfer coefficients
      x' = coef_x * base - |coef_e| * eps_used   (exact for true eps)
    plus a (T, 4) multistep weight matrix and the counter-1 flag."""
    cfg = schedule.config
    acp = schedule.alphas_cumprod.astype(np.float64)
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(acp[0])
    step = cfg.num_train_timesteps // num_steps
    ts = _leading_timesteps(cfg, num_steps)                  # descending
    n_evals = num_steps + 1
    t_eval = np.concatenate([[ts[0]], ts])                   # dup warmup
    # transfer pairs: evals 0 and 1 both apply (ts[0] -> ts[1]); eval i>=2
    # applies (ts[i-1] -> ts[i-1]-step)
    t_from = np.concatenate([[ts[0], ts[0]], ts[1:]])
    t_to = t_from - step
    a_t = acp[t_from]
    a_prev = np.where(t_to >= 0, acp[np.clip(t_to, 0, None)], final_alpha)
    sample_coeff = np.sqrt(a_prev / a_t)
    denom = a_t * np.sqrt(1.0 - a_prev) + np.sqrt(
        a_t * (1.0 - a_t) * a_prev)
    eps_coeff = (a_prev - a_t) / denom

    w = np.zeros((n_evals, 4))
    for i in range(n_evals):
        if i == 0:
            w[i] = [1.0, 0.0, 0.0, 0.0]
        elif i == 1:
            w[i] = [0.5, 0.5, 0.0, 0.0]
        elif i == 2:
            w[i] = [1.5, -0.5, 0.0, 0.0]
        elif i == 3:
            w[i] = [23 / 12, -16 / 12, 5 / 12, 0.0]
        else:
            w[i] = [55 / 24, -59 / 24, 37 / 24, -9 / 24]
    use_cur = (np.arange(n_evals) == 1).astype(np.float64)

    a_eval = acp[t_eval]
    return SamplerPlan(
        timesteps=t_eval.astype(np.float32),
        c_in=np.ones(n_evals, np.float32),
        coef_x=sample_coeff.astype(np.float32),
        coef_e=(-eps_coeff).astype(np.float32),
        coef_n=np.zeros(n_evals, np.float32),
        init_scale=1.0,
        noise_x=np.sqrt(a_eval).astype(np.float32),
        noise_e=np.sqrt(1.0 - a_eval).astype(np.float32),
        kind="pndm",
        plms_w=w.astype(np.float32),
        use_cur=use_cur.astype(np.float32),
    )


def plan_tail(plan: SamplerPlan, strength: float) -> SamplerPlan:
    """Keep the last int(T * strength) steps (img2img/inpaint truncation,
    reference StableDIffusionInpaint_ConsistentID.py:246-248).

    Slices EVERY per-step table (including the dpmpp_2m multistep extras) and
    zeroes the new first step's second-order weight `rr`, since the truncated
    trajectory has no previous x0 to extrapolate from.

    At least one step is always kept (diffusers get_timesteps semantics:
    `max(num_steps - init_timestep, 0)` keeps a non-empty tail).
    """
    import dataclasses as _dc

    kept = min(max(int(plan.num_steps * strength), 1), plan.num_steps)
    t_start = plan.num_steps - kept
    if t_start == 0:
        return plan
    updates = {}
    for f in _dc.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, np.ndarray) and v.shape[:1] == (plan.num_steps,):
            updates[f.name] = v[t_start:]
    if plan.rr is not None:
        rr = updates["rr"].copy()
        rr[0] = 0.0
        updates["rr"] = rr
    if plan.kind == "pndm":
        # multistep restart: the truncated trajectory has no eps history or
        # held cur_sample, so ramp the Adams-Bashforth order back up
        w = updates["plms_w"].copy()
        restart = np.array([[1.0, 0.0, 0.0, 0.0],
                            [1.5, -0.5, 0.0, 0.0],
                            [23 / 12, -16 / 12, 5 / 12, 0.0],
                            [55 / 24, -59 / 24, 37 / 24, -9 / 24]],
                           np.float32)
        for i in range(min(4, len(w))):
            w[i] = restart[i]
        updates["plms_w"] = w
        uc = updates["use_cur"].copy()
        uc[:] = 0.0
        updates["use_cur"] = uc
    return _dc.replace(plan, **updates)


PLAN_BUILDERS = {"ddim": ddim_plan, "euler": euler_plan, "ddpm": ddpm_plan,
                 "dpmpp_2m": dpmpp_2m_plan, "pndm": pndm_plan}


def make_plan(schedule: NoiseSchedule, name: str,
              num_steps: int) -> SamplerPlan:
    if name not in PLAN_BUILDERS:
        raise ValueError(f"unknown sampler {name!r}; available: "
                         f"{sorted(PLAN_BUILDERS)}")
    return PLAN_BUILDERS[name](schedule, num_steps)
