"""Model configuration registry.

Counterpart of the JAX package's `config.py`: the Flux DiT and VAE
hyper-parameters and the `configs` registry. A spec's checkpoint paths come
from environment variables (`FLUX_SCHNELL`, `FLUX_DEV` and `AE`; `FLUX_TINY`
and `AE_TINY` for the tiny spec); the hub names beside them are metadata
only, nothing downloads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """Flux DiT architecture hyper-parameters."""

    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000
    qkv_bias: bool = True
    guidance_embed: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    def __post_init__(self):
        if self.hidden_size % self.num_heads != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by num_heads {self.num_heads}"
            )
        if sum(self.axes_dim) != self.head_dim:
            raise ValueError(f"axes_dim {self.axes_dim} must sum to head_dim {self.head_dim}")


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    """Flux VAE hyper-parameters."""

    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    params: FluxConfig
    ae_params: AutoEncoderConfig
    repo_id: Optional[str] = None
    repo_flow: Optional[str] = None
    repo_ae: Optional[str] = None
    ckpt_env_var: Optional[str] = None
    ae_env_var: str = "AE"
    t5_max_length: int = 256

    @property
    def ckpt_path(self) -> Optional[str]:
        """The DiT checkpoint (`.safetensors`) named by `ckpt_env_var`, if set."""
        return os.getenv(self.ckpt_env_var) if self.ckpt_env_var else None

    @property
    def ae_path(self) -> Optional[str]:
        """The VAE checkpoint named by `ae_env_var`, if set."""
        return os.getenv(self.ae_env_var) if self.ae_env_var else None


_AE = AutoEncoderConfig()

configs = {
    "flux-schnell": ModelSpec(
        name="flux-schnell",
        params=FluxConfig(guidance_embed=False),
        ae_params=_AE,
        repo_id="black-forest-labs/FLUX.1-schnell",
        repo_flow="flux1-schnell.safetensors",
        repo_ae="ae.safetensors",
        ckpt_env_var="FLUX_SCHNELL",
        t5_max_length=256,
    ),
    "flux-dev": ModelSpec(
        name="flux-dev",
        params=FluxConfig(guidance_embed=True),
        ae_params=_AE,
        repo_id="black-forest-labs/FLUX.1-dev",
        repo_flow="flux1-dev.safetensors",
        repo_ae="ae.safetensors",
        ckpt_env_var="FLUX_DEV",
        t5_max_length=512,
    ),
    # Tiny config for tests: same topology, small dims, head_dim 32.
    "flux-tiny": ModelSpec(
        name="flux-tiny",
        params=FluxConfig(
            in_channels=16,
            vec_in_dim=32,
            context_in_dim=64,
            hidden_size=128,
            mlp_ratio=4.0,
            num_heads=4,
            depth=2,
            depth_single_blocks=2,
            axes_dim=(8, 12, 12),
            theta=10_000,
            qkv_bias=True,
            guidance_embed=False,
        ),
        ae_params=AutoEncoderConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=4),
        t5_max_length=16,
        # its own variables: a full-size checkpoint cannot load into the tiny config
        ckpt_env_var="FLUX_TINY",
        ae_env_var="AE_TINY",
    ),
}
