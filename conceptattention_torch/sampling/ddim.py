"""DDIM scheduler for the video DiT (VP diffusion).

Counterpart of the JAX package's `sampling/ddim.py`: the CogVideoX
scheduler's scaled-linear betas with the SNR shift and the zero-terminal-SNR
rescale, v-prediction by default. The alpha-cumprod table is built in
float64 on the host, as in JAX, and kept as f32; each step runs in f32 and
returns the sample's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Precomputed tables and the selected timestep sequence."""

    timesteps: torch.Tensor  # [S] int64, descending, on the host
    alphas_cumprod: torch.Tensor  # [num_train_timesteps] f32
    final_alpha_cumprod: float
    prediction_type: str = "v_prediction"


def make_ddim_schedule(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    prediction_type: str = "v_prediction",
    set_alpha_to_one: bool = True,
    snr_shift_scale: float = 3.0,
    rescale_betas_zero_snr: bool = True,
) -> DDIMSchedule:
    """Defaults match the published CogVideoX scheduler configs
    (snr_shift_scale 3.0, zero terminal SNR). snr_shift_scale=1.0 with
    rescale_betas_zero_snr=False gives a plain DDIM table."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    else:
        raise ValueError(beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas)
    if snr_shift_scale != 1.0:  # a_c <- a_c / (s + (1 - s) a_c)
        alphas_cumprod = alphas_cumprod / (
            snr_shift_scale + (1.0 - snr_shift_scale) * alphas_cumprod
        )
    if rescale_betas_zero_snr:  # shift and scale sqrt(a_c) so the last step is pure noise
        s = np.sqrt(alphas_cumprod)
        s0, s_t = s[0], s[-1]
        alphas_cumprod = ((s - s_t) * (s0 / (s0 - s_t))) ** 2
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return DDIMSchedule(
        timesteps=torch.from_numpy(timesteps.copy()),
        alphas_cumprod=torch.from_numpy(alphas_cumprod.astype(np.float32)),
        final_alpha_cumprod=1.0 if set_alpha_to_one else float(alphas_cumprod[0]),
        prediction_type=prediction_type,
    )


def alpha_at(sched: DDIMSchedule, timestep: int) -> torch.Tensor:
    """alpha-cumprod at `timestep` (f32 scalar); the final value for t < 0."""
    if timestep >= 0:
        return sched.alphas_cumprod[timestep]
    return torch.tensor(sched.final_alpha_cumprod, dtype=torch.float32,
                        device=sched.alphas_cumprod.device)


def ddim_step(
    sched: DDIMSchedule,
    model_output: torch.Tensor,
    timestep: int,
    prev_timestep: int,
    sample: torch.Tensor,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One DDIM update. eta=0 is deterministic; eta>0 adds the stochastic
    variance term and needs an explicit `generator`."""
    a_t = alpha_at(sched, timestep)
    a_prev = alpha_at(sched, prev_timestep)
    sqrt_a_t, sqrt_1ma_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    x, out = sample.float(), model_output.float()
    if sched.prediction_type == "v_prediction":
        pred_x0 = sqrt_a_t * x - sqrt_1ma_t * out
        pred_eps = sqrt_a_t * out + sqrt_1ma_t * x
    elif sched.prediction_type == "epsilon":
        pred_x0 = (x - sqrt_1ma_t * out) / sqrt_a_t
        pred_eps = out
    else:
        raise ValueError(sched.prediction_type)

    if eta > 0.0:
        if generator is None:
            raise ValueError("ddim_step with eta > 0 needs a generator")
        # sigma_t^2 = eta^2 (1-a_prev)/(1-a_t) (1 - a_t/a_prev)
        var = (1.0 - a_prev) / torch.clamp(1.0 - a_t, min=1e-12) * (
            1.0 - a_t / torch.clamp(a_prev, min=1e-12)
        )
        sigma = eta * torch.sqrt(torch.clamp(var, min=0.0))
        dir_coef = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0))
        noise = torch.randn(sample.shape, generator=generator, dtype=torch.float32,
                            device=sample.device)
        prev = torch.sqrt(a_prev) * pred_x0 + dir_coef * pred_eps + sigma * noise
        return prev.to(sample.dtype)
    prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * pred_eps
    return prev.to(sample.dtype)


def add_noise(
    sched: DDIMSchedule, sample: torch.Tensor, noise: torch.Tensor, timestep: int
) -> torch.Tensor:
    a_t = sched.alphas_cumprod[timestep]
    return (torch.sqrt(a_t) * sample.float() + torch.sqrt(1.0 - a_t) * noise.float()).to(
        sample.dtype
    )
