"""DPM-Solver++ (2M) multistep scheduler for VP diffusion.

Counterpart of the JAX package's `sampling/dpm.py`: the data-prediction
multistep update in log-SNR space, first order on the first step and on
the final step (lower-order-final), with an explicit carried state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conceptattention_torch.sampling.ddim import DDIMSchedule, alpha_at, make_ddim_schedule


class DPMState(NamedTuple):
    sample: torch.Tensor
    prev_x0: torch.Tensor  # the previous step's data prediction, f32
    prev_lambda: torch.Tensor  # f32 scalar
    step_index: int


def make_dpm_schedule(num_inference_steps: int, **kwargs) -> DDIMSchedule:
    """The DDIM tables; the update rule differs."""
    return make_ddim_schedule(num_inference_steps, **kwargs)


def _coeffs(sched: DDIMSchedule, timestep: int):
    acp = alpha_at(sched, timestep)
    alpha = torch.sqrt(acp)
    # at t < 0 (the final boundary) sigma -> 0; the clamp keeps lambda finite
    sigma = torch.clamp(torch.sqrt(1.0 - acp), min=1e-6)
    return alpha, sigma, torch.log(alpha / sigma)


def _to_x0(sched: DDIMSchedule, model_output, sample, alpha, sigma):
    x, out = sample.float(), model_output.float()
    if sched.prediction_type == "v_prediction":
        return alpha * x - sigma * out
    if sched.prediction_type == "epsilon":
        return (x - sigma * out) / alpha
    raise ValueError(sched.prediction_type)


def dpm_init(sample: torch.Tensor) -> DPMState:
    return DPMState(
        sample=sample,
        prev_x0=torch.zeros_like(sample, dtype=torch.float32),
        prev_lambda=torch.zeros((), dtype=torch.float32, device=sample.device),
        step_index=0,
    )


def dpm_step(
    sched: DDIMSchedule,
    state: DPMState,
    model_output: torch.Tensor,
    timestep: int,
    prev_timestep: int,
) -> DPMState:
    """One DPM-Solver++(2M) update."""
    alpha_t, sigma_t, lam_t = _coeffs(sched, timestep)
    alpha_s, sigma_s, lam_s = _coeffs(sched, prev_timestep)
    x0 = _to_x0(sched, model_output, state.sample, alpha_t, sigma_t)
    h = lam_s - lam_t
    # Second order except on the first step and at the t < 0 boundary, where
    # the clamped sigma makes h ~ 10 and the 2M coefficient would extrapolate
    # the last two predictions.
    if state.step_index > 0 and prev_timestep >= 0:
        h_prev = lam_t - state.prev_lambda
        r = h_prev / torch.where(h == 0, torch.ones_like(h), h)
        coef = 1.0 / (2.0 * torch.clamp(r, min=1e-6))
        d = (1.0 + coef) * x0 - coef * state.prev_x0
    else:
        d = x0
    x_next = (sigma_s / sigma_t) * state.sample.float() - alpha_s * torch.expm1(-h) * d
    return DPMState(
        sample=x_next.to(state.sample.dtype),
        prev_x0=x0,
        prev_lambda=lam_t,
        step_index=state.step_index + 1,
    )
