"""Rectified-flow sampling schedule.

Counterpart of the JAX package's `ops/schedule.py`: linspace 1 -> 0 over
num_steps + 1 with an optional resolution-dependent sigmoid time shift,
computed on the host in float64 and returned as a plain list.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def time_shift(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def get_lin_function(x1: float = 256, y1: float = 0.5, x2: float = 4096, y2: float = 1.15):
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def get_schedule(
    num_steps: int,
    image_seq_len: int,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
    shift: bool = True,
) -> List[float]:
    timesteps = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    if shift:
        mu = get_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
        with np.errstate(divide="ignore"):
            timesteps = time_shift(mu, 1.0, timesteps)
        timesteps[-1] = 0.0  # 1/t diverges at t=0; the limit is 0
    return [float(t) for t in timesteps]


def get_shifted_schedule(num_steps: int, shift: float) -> List[float]:
    """linspace 1 -> 0 over num_steps + 1, each t shifted to
    shift t / (1 + (shift - 1) t): `time_shift` at mu = ln(shift), the
    flow-matching schedule of HunyuanVideo (shift 7.0) and SD3."""
    timesteps = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        timesteps = time_shift(math.log(shift), 1.0, timesteps)
    timesteps[-1] = 0.0  # 1/t diverges at t=0; the limit is 0
    return [float(t) for t in timesteps]
