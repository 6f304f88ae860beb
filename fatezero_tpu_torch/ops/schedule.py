"""DDIM noise schedule: denoise steps, exact inversion and CFG (torch).

Counterpart of fatezero_tpu/ops/schedule.py. A schedule is a dataclass of
fp32 tables on an explicit device; every step function is pure and keeps the
diffusion carry in fp32. Timesteps may be Python ints or integer tensors
(scalar or one per batch row).

Stable-Diffusion 1.x defaults: scaled_linear betas in [0.00085, 0.012], 1000
train steps, steps_offset=1, set_alpha_to_one=False, epsilon prediction.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

Timestep = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed noise-schedule tables (fp32, length num_train_timesteps)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: torch.Tensor  # scalar: alpha at the "t = -1" boundary
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"
    clip_sample: bool = False


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    set_alpha_to_one: bool = False,
    prediction_type: str = "epsilon",
    clip_sample: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> DiffusionSchedule:
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
            ** 2
        )
    elif beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps
        f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.clip(1.0 - f[1:] / f[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])

    def table(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DiffusionSchedule(
        betas=table(betas),
        alphas_cumprod=table(alphas_cumprod),
        final_alpha_cumprod=table(final),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
        clip_sample=clip_sample,
    )


def ddim_timesteps(
    schedule: DiffusionSchedule, num_inference_steps: int, steps_offset: int = 1
) -> np.ndarray:
    """Descending inference timestep grid (leading spacing + offset, SD default)."""
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    ts = ts + steps_offset
    return np.minimum(ts, schedule.num_train_timesteps - 1)


def _alpha_at(schedule: DiffusionSchedule, t: Timestep) -> torch.Tensor:
    """alpha_cumprod[t], with t < 0 mapped to final_alpha_cumprod."""
    table = schedule.alphas_cumprod
    t = torch.as_tensor(t, device=table.device)
    safe_t = t.clamp(0, schedule.num_train_timesteps - 1).long()
    return torch.where(t >= 0, table[safe_t], schedule.final_alpha_cumprod)


def _bcast(alpha: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Right-pad alpha's shape so a per-batch (or scalar) t broadcasts over sample."""
    return alpha.reshape(alpha.shape + (1,) * (sample.dim() - alpha.dim()))


def pred_original_sample(
    schedule: DiffusionSchedule, model_output: torch.Tensor, t: Timestep, sample: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_x0, pred_epsilon) from a model output under the schedule's prediction type."""
    alpha = _bcast(_alpha_at(schedule, t).to(sample.dtype), sample)
    beta = 1.0 - alpha
    sqrt_alpha, sqrt_beta = alpha.sqrt(), beta.sqrt()
    if schedule.prediction_type == "epsilon":
        x0 = (sample - sqrt_beta * model_output) / sqrt_alpha
        eps = model_output
    elif schedule.prediction_type == "v_prediction":
        x0 = sqrt_alpha * sample - sqrt_beta * model_output
        eps = sqrt_alpha * model_output + sqrt_beta * sample
    elif schedule.prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_alpha * x0) / sqrt_beta
    else:
        raise ValueError(schedule.prediction_type)
    if schedule.clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    return x0, eps


def ddim_transfer(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    t_from: Timestep,
    t_to: Timestep,
    sample: torch.Tensor,
) -> torch.Tensor:
    """Deterministic (eta=0) DDIM move of `sample` from noise level t_from to t_to."""
    x0, eps = pred_original_sample(schedule, model_output, t_from, sample)
    alpha_to = _bcast(_alpha_at(schedule, t_to).to(sample.dtype), sample)
    return alpha_to.sqrt() * x0 + (1.0 - alpha_to).sqrt() * eps


def ddim_denoise_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    timestep: Timestep,
    sample: torch.Tensor,
    num_inference_steps: int,
) -> torch.Tensor:
    """One DDIM denoise step t -> t - T/S (eta=0)."""
    prev_t = timestep - schedule.num_train_timesteps // num_inference_steps
    return ddim_transfer(schedule, model_output, timestep, prev_t, sample)


def ddim_invert_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    timestep: Timestep,
    sample: torch.Tensor,
    num_inference_steps: int,
) -> torch.Tensor:
    """One exact-inversion step: latent at t - T/S -> latent at t (the target level)."""
    t_from = timestep - schedule.num_train_timesteps // num_inference_steps
    return ddim_transfer(schedule, model_output, t_from, timestep, sample)


def add_noise(
    schedule: DiffusionSchedule, sample: torch.Tensor, noise: torch.Tensor, t: Timestep
) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (diffusers `add_noise`). t broadcasts over batch."""
    alpha = _bcast(_alpha_at(schedule, t).to(sample.dtype), sample)
    return alpha.sqrt() * sample + (1.0 - alpha).sqrt() * noise


def get_velocity(
    schedule: DiffusionSchedule, sample: torch.Tensor, noise: torch.Tensor, t: Timestep
) -> torch.Tensor:
    """v-prediction target: v = sqrt(a) eps - sqrt(1-a) x0 (diffusers `get_velocity`)."""
    alpha = _bcast(_alpha_at(schedule, t).to(sample.dtype), sample)
    return alpha.sqrt() * noise - (1.0 - alpha).sqrt() * sample


def ddpm_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    timestep: Timestep,
    sample: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """One ancestral DDPM step (variance type: fixed_small), for sampling parity."""
    t = torch.as_tensor(timestep, device=schedule.betas.device)
    alpha_prod_t = _alpha_at(schedule, t)
    # diffusers DDPMScheduler uses `one` (exactly 1.0) for the t-1 < 0
    # boundary, unlike DDIM's final_alpha_cumprod
    one = torch.ones((), device=t.device)
    alpha_prod_prev = torch.where(t > 0, _alpha_at(schedule, t - 1), one)
    beta_t = schedule.betas[t.clamp(0, schedule.num_train_timesteps - 1).long()]
    alpha_t = 1.0 - beta_t
    x0, _ = pred_original_sample(schedule, model_output, t, sample)
    # mu(x_t, x0) coefficients, Ho et al. eq. 7
    coef_x0 = alpha_prod_prev.sqrt() * beta_t / (1.0 - alpha_prod_t)
    coef_xt = alpha_t.sqrt() * (1.0 - alpha_prod_prev) / (1.0 - alpha_prod_t)
    mean = coef_x0 * x0 + coef_xt * sample
    var = beta_t * (1.0 - alpha_prod_prev) / (1.0 - alpha_prod_t)
    sigma = var.clamp(min=1e-20).sqrt()
    return mean + torch.where(t > 0, sigma, torch.zeros_like(sigma)) * noise


def classifier_free_guidance(
    eps_uncond: torch.Tensor, eps_cond: torch.Tensor, guidance_scale
) -> torch.Tensor:
    """CFG combine: eps_u + g * (eps_c - eps_u)."""
    return eps_uncond + guidance_scale * (eps_cond - eps_uncond)
