"""Video concept-attention pipeline: generate a video and per-frame heatmaps.

One class for two models, chosen by the config: CogVideoX (`CogVideoXConfig`)
and HunyuanVideo (`models/video/hunyuan.HunyuanVideoConfig`).

CogVideoX is the counterpart of the JAX package's `pipeline/video_pipeline.py`
(the reference's `ModifiedCogVideoXPipeline`):

  - `encode_concepts`: the first T5 token of each concept, zero-padded to
    `max_text_seq_length` (226) slots; the padding slots are real rows of
    the concept stream and take part in the concept softmax;
  - classifier-free guidance doubles the batch, and the concept maps come
    from the conditional half;
  - per step, the maps are reduced as soon as the forward returns (layer
    select, softmax over ALL padded slots, slice to the real concepts, mean
    over layers), so only `[steps, C, F*P]` is kept across steps; then the
    selected steps are averaged (with a second softmax on the cross maps).

The pipeline runs on one device, "cuda" unless the caller names another,
and never falls back to the CPU. `quantize` ("w8", "w8a8" or "w4")
quantizes the DiT's stacked blocks (`ops/quant.py`), whose linears all take
quantized cells; `lora=` merges LoRA adapters into the DiT first. The DiT
runs in `dtype` (bf16 by default) and the VAE in f32; f32 matmuls and
convolutions run in full f32 for the duration of `generate_video` and
`decode_latents`.

HunyuanVideo (no JAX counterpart) runs the flow-matching Euler loop over the
shifted schedule (`ops/schedule.get_shifted_schedule`, shift 7.0) with
embedded guidance at batch 1, no negative prompt: the text is cut to its
valid length (`encode_llm`), the concepts are each one's first text state,
unpadded, and each step's maps are reduced as CogVideoX's are (softmax over
the concepts, mean over the selected double blocks). Its 3D VAE, the
quantized and the LoRA paths are not ported and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from conceptattention_torch.models.text.encoders import StubTextEncoders, TextEncoders
from conceptattention_torch.models.video import vae as vvae
from conceptattention_torch.models.video.dit import (
    CogVideoXConfig,
    init_video_dit_params,
    video_dit_forward,
)
from conceptattention_torch.models.video.hunyuan import (
    HunyuanVideoConfig,
    hunyuan_video_forward,
    init_hunyuan_video_params,
)
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.ops.quant import (
    int8_gemm_layout,
    quantize_video_dit_params,
    resolve_quant_mode,
)
from conceptattention_torch.ops.schedule import get_shifted_schedule
from conceptattention_torch.pipeline.concept_pipeline import _full_f32
from conceptattention_torch.sampling.ddim import DDIMSchedule, ddim_step, make_ddim_schedule
from conceptattention_torch.sampling.dpm import dpm_init, dpm_step
from conceptattention_torch.sampling.rectified_flow import euler_step
from conceptattention_torch.utils.profiling import (
    CALL_GENERATE_VIDEO,
    PIPELINE_PREPARE,
    PIPELINE_REDUCE_MAPS,
    PIPELINE_TO_HOST,
    SAMPLER_DENOISE,
    VAE_DECODE,
    span,
)
from conceptattention_torch.weights.convert import load_safetensors
from conceptattention_torch.weights.lora import convert_cogvideox_lora_state_dict, merge_loras

SCHEDULERS = ("ddim", "dpm")  # "dpm" is DPM-Solver++ 2M
_VAE_INIT_SEED = 7


@dataclasses.dataclass
class VideoConceptPipelineOutput:
    video_latents: torch.Tensor  # [B, F, C, H, W]
    concept_heatmaps: np.ndarray  # [concepts, frames, h, w]
    cross_attention_maps: Optional[np.ndarray] = None
    video_frames: Optional[np.ndarray] = None  # uint8 [F_pix, H_pix, W_pix, 3]


def _reduce_step_maps(maps: torch.Tensor, layer_indices, n_concepts: int) -> torch.Tensor:
    """[L, B, C_pad, P] -> [C, P]: the conditional batch half (the last
    row), the selected layers, a softmax over ALL padded concept slots, the
    real concepts, the mean over layers."""
    sel = maps[:, -1][torch.as_tensor(list(layer_indices), device=maps.device)]
    return torch.softmax(sel, dim=-2)[:, :n_concepts].mean(dim=0)


def _cfg_denoise(
    params, cfg, latents, text_cond, text_uncond,
    concepts, timesteps_idx, sched_alphas, final_alpha,
    guidance_scale, spec, num_train_timesteps, scheduler,
    layer_indices, n_concepts,
):
    """The CFG sampling loop: one DiT forward on the [uncond; cond] batch per
    step, a DDIM or DPM-Solver++ 2M update, and the step's reduced maps.
    Returns (latents, {tap: [steps, C, P] f32})."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"scheduler must be one of {SCHEDULERS}, got {scheduler!r}")
    sched = DDIMSchedule(timesteps=timesteps_idx, alphas_cumprod=sched_alphas,
                         final_alpha_cumprod=final_alpha)
    text = torch.cat([text_uncond, text_cond], dim=0)
    concepts2 = torch.cat([concepts, concepts], dim=0)
    b = latents.shape[0]
    step_gap = num_train_timesteps // len(timesteps_idx)

    def guided_pred(x, t):
        t_vec = torch.full((2 * b,), float(t), dtype=torch.float32, device=x.device)
        pred, saliency = video_dit_forward(
            params, cfg, torch.cat([x, x], dim=0), text, t_vec, concepts=concepts2, spec=spec,
        )
        uncond, cond = pred.chunk(2, dim=0)
        reduced = {k: _reduce_step_maps(v, layer_indices, n_concepts) for k, v in saliency.items()}
        return uncond + guidance_scale * (cond - uncond), reduced

    with span(SAMPLER_DENOISE):
        per_step = []
        state = dpm_init(latents) if scheduler == "dpm" else None
        for t in (int(t) for t in timesteps_idx):
            if state is not None:
                guided, reduced = guided_pred(state.sample, t)
                state = dpm_step(sched, state, guided, t, t - step_gap)
            else:
                guided, reduced = guided_pred(latents, t)
                latents = ddim_step(sched, guided, t, t - step_gap, latents)
            per_step.append(reduced)
        if state is not None:
            latents = state.sample
        return latents, {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}


def _flow_denoise(params, cfg, latents, txt, y, guidance_scale, concepts, sigmas, spec,
                  layer_indices, n_concepts):
    """HunyuanVideo's sampling loop: one forward per step with embedded
    guidance, the Euler update x + (s_next - s) v over `sigmas` (steps + 1
    values, 1 -> 0), and the step's reduced maps.
    Returns (latents, {tap: [steps, C, P] f32})."""
    b, dev = latents.shape[0], latents.device
    with span(SAMPLER_DENOISE):
        guidance = torch.full((b,), guidance_scale, dtype=torch.float32, device=dev)
        per_step = []
        for s, s_next in zip(sigmas[:-1], sigmas[1:]):
            t_vec = torch.full((b,), s, dtype=torch.float32, device=dev)
            pred, saliency = hunyuan_video_forward(params, cfg, latents, txt, t_vec, y, guidance,
                                                   concepts=concepts, spec=spec)
            latents = euler_step(latents, pred, s_next - s)
            per_step.append({k: _reduce_step_maps(v, layer_indices, n_concepts)
                             for k, v in saliency.items()})
        return latents, {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}


class VideoConceptAttentionPipeline:
    """Generate video latents with per-frame concept saliency heatmaps."""

    def __init__(
        self,
        cfg: Optional[Union[CogVideoXConfig, HunyuanVideoConfig]] = None,
        params: Optional[Dict[str, Any]] = None,
        text_encoders: Optional[TextEncoders] = None,
        dtype: torch.dtype = torch.bfloat16,
        init_seed: int = 0,
        vae_params: Optional[Dict[str, Any]] = None,
        vae_cfg: Optional[vvae.CogVideoXVAEConfig] = None,
        quantize=False,
        lora: Optional[Any] = None,
        lora_strength=1.0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """`cfg` picks the model: CogVideoX (the default, the 2B config) or
        HunyuanVideo (`hunyuan.hunyuanvideo_config()`). `lora` is a LoRA
        `.safetensors` path in diffusers' CogVideoX naming, an adapter tree
        (`weights/lora.py`), or a list of either, merged at `lora_strength`
        (one value, or one per adapter) into the DiT on the device before
        `quantize` quantizes its blocks."""
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "VideoConceptAttentionPipeline runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU"
            )
        self.cfg = cfg or CogVideoXConfig()
        self.dtype = dtype
        self.hunyuan = isinstance(self.cfg, HunyuanVideoConfig)
        if self.hunyuan:
            if quantize or lora is not None:
                raise NotImplementedError("the quantized and LoRA paths are not ported for "
                                          "HunyuanVideo")
            self.params = params if params is not None else init_hunyuan_video_params(
                torch.Generator(self.device).manual_seed(init_seed), self.cfg, dtype)
            self.text_encoders = text_encoders or StubTextEncoders(
                t5_dim=self.cfg.context_in_dim, clip_dim=self.cfg.vec_in_dim,
                t5_max_length=self.cfg.text_len)
            return
        self.params = int8_gemm_layout(params) if params is not None else init_video_dit_params(
            torch.Generator(self.device).manual_seed(init_seed), self.cfg, dtype
        )
        if lora is not None:
            items = lora if isinstance(lora, (list, tuple)) else [lora]
            adapters = [convert_cogvideox_lora_state_dict(load_safetensors(it), self.cfg)
                        if isinstance(it, str) else it for it in items]
            strengths = (list(lora_strength) if isinstance(lora_strength, (list, tuple))
                         else [float(lora_strength)] * len(adapters))
            if len(strengths) != len(adapters):
                raise ValueError(f"{len(adapters)} LoRA adapter(s) but {len(strengths)} strengths")
            self.params = merge_loras(self.params, adapters, strengths)
        if quantize:  # False | True / "w8" | "w8a8" | "w4": the stacked blocks
            self.params = quantize_video_dit_params(self.params, mode=resolve_quant_mode(quantize))
        self.text_encoders = text_encoders or StubTextEncoders(
            t5_dim=self.cfg.text_embed_dim, clip_dim=768,
            t5_max_length=self.cfg.max_text_seq_length,
        )
        # The VAE (diffusers AutoencoderKLCogVideoX layout) is made at first
        # decode from a fixed seed unless parameters are passed in.
        self.vae_cfg = vae_cfg
        self.vae_params = vae_params

    def _vae(self):
        if self.hunyuan:
            raise NotImplementedError("HunyuanVideo's causal 3D VAE is not ported: its "
                                      "calls stop at the latents (decode=False)")
        if self.vae_cfg is None:
            self.vae_cfg = vvae.CogVideoXVAEConfig(latent_channels=self.cfg.in_channels)
        if self.vae_params is None:
            self.vae_params = vvae.init_video_vae_params(
                torch.Generator(self.device).manual_seed(_VAE_INIT_SEED), self.vae_cfg
            )
        return self.vae_cfg, self.vae_params

    @torch.inference_mode()
    @_full_f32()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """[B, F, C, h, w] DiT latents -> uint8 frames [F', h*8, w*8, 3] of
        the first clip through the 3D causal VAE in f32 (odd F gives
        F' = 1 + (F-1)*4, the first latent frame decoding to one frame)."""
        with span(VAE_DECODE):
            vae_cfg, vae_params = self._vae()
            z = latents.to(self.device, torch.float32).transpose(1, 2)
            pixels = vvae.decode(vae_params, vae_cfg, z)
            x = torch.clamp(pixels[0], -1.0, 1.0)
        with span(PIPELINE_TO_HOST):
            return ((x + 1.0) * 127.5).permute(1, 2, 3, 0).cpu().numpy().astype(np.uint8)

    def encode_concepts(self, concepts: List[str], seq_length: Optional[int] = None):
        """First T5 token per concept, zero-padded to seq_length -> [1, seq_length, D].
        HunyuanVideo: the first state of `encode_llm` per concept, unpadded
        -> [1, C, D]."""
        if self.hunyuan:
            emb = torch.stack([self.text_encoders.encode_llm([c])[0][0, 0] for c in concepts])
            return emb[None].to(self.device, self.dtype)
        seq_length = seq_length or self.cfg.max_text_seq_length
        if len(concepts) > seq_length:
            raise ValueError(
                f"{len(concepts)} concepts exceed max_text_seq_length={seq_length} "
                "(the concept stream shares the text slots)"
            )
        emb = torch.stack([self.text_encoders.encode_t5([c])[0, 0] for c in concepts])[None]
        emb = emb.to(self.device, self.dtype)
        pad = torch.zeros((1, seq_length - len(concepts), emb.shape[-1]), dtype=self.dtype,
                          device=self.device)
        return torch.cat([emb, pad], dim=1)

    def _encode_text(self, prompt: str) -> torch.Tensor:
        emb = self.text_encoders.encode_t5([prompt]).to(self.device, self.dtype)
        t = self.cfg.max_text_seq_length
        if emb.shape[1] < t:
            pad = torch.zeros((emb.shape[0], t - emb.shape[1], emb.shape[-1]), dtype=self.dtype,
                              device=self.device)
            emb = torch.cat([emb, pad], dim=1)
        return emb[:, :t]

    def _check_indices(self, layer_indices, concept_timesteps, num_inference_steps):
        """Tensor indexing would wrap -1 to the last entry; refuse instead,
        as the JAX package does (before the loop, not after it)."""
        n_layers = self._num_layers()
        bad = [int(i) for i in layer_indices if not 0 <= int(i) < n_layers]
        if bad:
            raise ValueError(f"layer_indices {bad} out of range for {n_layers} layers")
        if concept_timesteps is not None:
            bad = [int(t) for t in concept_timesteps if not 0 <= int(t) < num_inference_steps]
            if bad:
                raise ValueError(
                    f"concept_timesteps {bad} out of range for {num_inference_steps} inference steps"
                )

    def _num_layers(self) -> int:
        """The blocks whose maps a call can select: CogVideoX's layers,
        HunyuanVideo's double (dual-stream) blocks."""
        return self.cfg.depth if self.hunyuan else self.cfg.num_layers

    @torch.inference_mode()
    @_full_f32()
    def generate_video(
        self,
        prompt: str,
        concepts: List[str],
        negative_prompt: str = "",
        num_frames: int = 4,
        height: int = 32,
        width: int = 32,
        num_inference_steps: int = 10,
        guidance_scale: float = 6.0,
        concept_timesteps: Optional[Sequence[int]] = None,
        layer_indices: Optional[Sequence[int]] = None,
        return_cross_attention: bool = False,
        scheduler: Optional[str] = None,
        seed: int = 0,
        decode: bool = False,
    ) -> VideoConceptPipelineOutput:
        """CogVideoX: CFG DDIM (`scheduler` None or "ddim") or DPM-Solver++
        2M ("dpm") sampling. HunyuanVideo: the flow-matching Euler loop
        (`scheduler` None or "euler") with `guidance_scale` as its embedded
        guidance, no negative prompt and no decode. Returns the latents
        [1, F, C, H, W] and [C, F, h, w] maps. height/width are LATENT sizes
        (before patchify)."""
        with span(CALL_GENERATE_VIDEO):
            cfg = self.cfg
            if height % cfg.patch_size or width % cfg.patch_size:
                raise ValueError(
                    f"latent height/width ({height}x{width}) must be divisible by "
                    f"patch_size={cfg.patch_size}"
                )
            if layer_indices is None:
                layer_indices = list(range(self._num_layers()))
            self._check_indices(layer_indices, concept_timesteps, num_inference_steps)
            if self.hunyuan:
                if decode:
                    self._vae()  # raises: the VAE is not ported
                if negative_prompt or scheduler not in (None, "euler"):
                    raise ValueError("HunyuanVideo samples with the Euler scheduler and embedded "
                                     "guidance: no negative_prompt, scheduler None or 'euler'")

            f, h, w = num_frames, height, width
            with span(PIPELINE_PREPARE):
                if self.hunyuan:
                    states, lengths = self.text_encoders.encode_llm([prompt])
                    text_cond = states[:, :lengths[0]].to(self.device, self.dtype)
                    pooled = self.text_encoders.encode_clip([prompt]).to(self.device, self.dtype)
                else:
                    text_cond = self._encode_text(prompt)
                    text_uncond = self._encode_text(negative_prompt)
                concepts_emb = self.encode_concepts(concepts)
                channels = cfg.latent_channels if self.hunyuan else cfg.in_channels
                latents = torch.randn(
                    (1, f, channels, h, w),
                    generator=torch.Generator(self.device).manual_seed(seed),
                    device=self.device, dtype=torch.float32,
                ).to(self.dtype)

            taps = ("output", "cross_attention") if return_cross_attention else ("output",)
            spec = ConceptAttentionSpec(taps=taps)
            if self.hunyuan:
                latents, saliency = _flow_denoise(
                    self.params, cfg, latents, text_cond, pooled, guidance_scale, concepts_emb,
                    get_shifted_schedule(num_inference_steps, cfg.flow_shift), spec,
                    tuple(layer_indices), len(concepts),
                )
            else:
                sched = make_ddim_schedule(num_inference_steps)
                latents, saliency = _cfg_denoise(
                    self.params, cfg, latents, text_cond, text_uncond, concepts_emb,
                    sched.timesteps, sched.alphas_cumprod.to(self.device),
                    sched.final_alpha_cumprod, guidance_scale, spec, 1000, scheduler or "ddim",
                    tuple(layer_indices), len(concepts),
                )

            gh, gw = h // cfg.patch_size, w // cfg.patch_size

            def finalize(maps, extra_softmax):  # maps: [S, C, F*P], reduced per step
                with span(PIPELINE_REDUCE_MAPS):
                    if concept_timesteps is not None:
                        steps = torch.as_tensor(list(concept_timesteps), device=maps.device)
                        maps = maps[steps]
                    if extra_softmax:  # CogVideoX's reference re-softmaxes the sliced cross maps
                        maps = torch.softmax(maps, dim=-2)
                    maps = maps.mean(dim=0).reshape(len(concepts), f, gh, gw).float()
                with span(PIPELINE_TO_HOST):
                    return maps.cpu().numpy()

            return VideoConceptPipelineOutput(
                video_latents=latents,
                concept_heatmaps=finalize(saliency["output"], extra_softmax=False),
                cross_attention_maps=(finalize(saliency["cross_attention"],
                                               extra_softmax=not self.hunyuan)
                                      if return_cross_attention else None),
                video_frames=self.decode_latents(latents) if decode else None,
            )
