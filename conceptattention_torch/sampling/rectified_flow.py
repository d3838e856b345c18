"""Rectified-flow Euler sampler.

Counterpart of the JAX package's `sampling/rectified_flow.py`: a Python
loop over the schedule around the DiT, f32 Euler accumulation, per-step
saliency maps stacked to [steps, depth, B, C, P], and the optional true
classifier-free guidance (a second forward on a negative prompt per step).
Noise comes from a `torch.Generator`: same distribution as the JAX package's
threefry draws, different bits, so parity tests inject the same noise into
both.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux.dit import flux_forward
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.ops.packing import latent_noise_shape, make_img_ids, pack_latents
from conceptattention_torch.utils.profiling import SAMPLER_DENOISE, span


def get_noise(
    generator: torch.Generator,
    num_samples: int,
    height: int,
    width: int,
    dtype: torch.dtype = torch.bfloat16,
    channels: int = 16,
    vae_factor: int = 8,
) -> torch.Tensor:
    """Seeded latent noise [B, C, 2 ceil(h/16), 2 ceil(w/16)] on the
    generator's device."""
    shape = latent_noise_shape(num_samples, height, width, channels, vae_factor)
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)


def get_noise_torch_parity(
    seed: int,
    num_samples: int,
    height: int,
    width: int,
    dtype: torch.dtype = torch.bfloat16,
    channels: int = 16,
    vae_factor: int = 8,
) -> torch.Tensor:
    """Latent noise from a CPU generator seeded `seed`, drawn in `dtype`
    (bf16 or f32): the bits of the reference implementation's `get_noise`
    for that seed, and of the JAX package's function of this name."""
    shape = latent_noise_shape(num_samples, height, width, channels, vae_factor)
    gen = torch.Generator("cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.bfloat16 if dtype == torch.bfloat16
                       else torch.float32).to(dtype)


def prepare_image_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, C, H, W] latents -> (packed [B, P, C*4] tokens, img_ids [B, P, 3])."""
    b, _, h, w = x.shape
    return pack_latents(x), make_img_ids(h // 2, w // 2, b, device=x.device)


def prepare(text_encoders, img: torch.Tensor, prompt) -> Dict[str, torch.Tensor]:
    """The DiT's inputs {img, img_ids, txt, txt_ids, vec} from latents and a
    prompt (or one per image); a batch of one broadcasts against the other.
    The text embeddings move to `img`'s device and dtype."""
    prompts = [prompt] if isinstance(prompt, str) else list(prompt)
    b = max(img.shape[0], len(prompts))
    packed, img_ids = prepare_image_tokens(img)
    txt = text_encoders.encode_t5(prompts).to(img.device)
    vec = text_encoders.encode_clip(prompts).to(img.device)

    def batch(a):
        return a.expand(b, *a.shape[1:]) if a.shape[0] == 1 and b > 1 else a

    return {
        "img": batch(packed).to(img.dtype),
        "img_ids": batch(img_ids),
        "txt": batch(txt).to(img.dtype),
        "txt_ids": torch.zeros((b, txt.shape[1], 3), dtype=torch.float32, device=img.device),
        "vec": batch(vec).to(img.dtype),
    }


def denoise(
    params: Dict[str, Any],
    cfg: FluxConfig,
    img: torch.Tensor,
    img_ids: torch.Tensor,
    txt: torch.Tensor,
    txt_ids: torch.Tensor,
    vec: torch.Tensor,
    timesteps: Sequence[float],
    guidance: float = 4.0,
    concepts: Optional[torch.Tensor] = None,
    concept_ids: Optional[torch.Tensor] = None,
    concept_vec: Optional[torch.Tensor] = None,
    spec: ConceptAttentionSpec = ConceptAttentionSpec(),
    neg_txt: Optional[torch.Tensor] = None,
    neg_vec: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    true_cfg: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Euler loop x_{t_prev} = x_t + (t_prev - t_curr) * v(x_t) over the
    descending schedule `timesteps` (S + 1 values, 1 -> 0). With `true_cfg`
    each step runs a second forward on the negative prompt (`neg_txt`,
    `neg_vec`; no concepts; on `spec`'s attention backend) and takes
    neg + guidance_scale * (pos - neg);
    `guidance` stays the embedded (distilled) guidance strength.

    Returns (final latents [B, P, C*4], saliency {tap: [S, depth, B, C, P]}).
    """
    with span(SAMPLER_DENOISE):
        b = img.shape[0]
        ts = torch.as_tensor(timesteps, dtype=torch.float32, device=img.device)
        guidance_vec = torch.full((b,), guidance, dtype=torch.float32, device=img.device)
        per_step = []
        x = img
        for i in range(len(timesteps) - 1):
            t_curr, t_prev = ts[i], ts[i + 1]
            pred, saliency = flux_forward(
                params, cfg, img=x, img_ids=img_ids, txt=txt, txt_ids=txt_ids,
                timesteps=t_curr.expand(b), y=vec,
                guidance=guidance_vec if cfg.guidance_embed else None,
                concepts=concepts, concept_ids=concept_ids, concept_vec=concept_vec,
                spec=spec,
            )
            if true_cfg:
                neg_pred, _ = flux_forward(
                    params, cfg, img=x, img_ids=img_ids, txt=neg_txt, txt_ids=txt_ids,
                    timesteps=t_curr.expand(b), y=neg_vec,
                    guidance=guidance_vec if cfg.guidance_embed else None, spec=spec,
                )
                pred = neg_pred + guidance_scale * (pred - neg_pred)
            x = euler_step(x, pred, t_prev - t_curr)
            if spec.stash_dtype == "bf16":
                saliency = {k: v.to(torch.bfloat16) for k, v in saliency.items()}
            per_step.append(saliency)
        stacked = ({k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
                   if per_step else {})
        return x, stacked


def euler_step(x: torch.Tensor, pred: torch.Tensor, dt) -> torch.Tensor:
    """One Euler step x + dt * v of the flow, in f32, back in x's dtype."""
    return (x.float() + dt * pred.float()).to(x.dtype)


def forward_noise(x: torch.Tensor, noise: torch.Tensor, t: float) -> torch.Tensor:
    """Rectified-flow forward noising x_t = t * eps + (1 - t) * x."""
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    return (t * noise.float() + (1.0 - t) * x.float()).to(noise.dtype)
