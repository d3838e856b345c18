"""Zero-shot segmentation: the interface and the Flux tap-point models.

Counterpart of the JAX package's `evals/segmentation.py`. A segmentation
model maps (image, concepts, caption) to per-concept coefficient maps, then
the shared tail optionally blurs them, thresholds them at their mean and
picks the target concept. The Flux models encode the real image with the
VAE, forward-noise it to a schedule step, run one DiT forward that stops
after the double blocks, and average the per-layer concept-by-patch maps of
one saliency tap ("output": the ConceptAttention method; "cross_attention":
the raw q space; "value": the raw value space) over noise samples and
layers. The DAAM baselines read cross-attention probabilities instead:
DAAMFlux those of the Flux double blocks, DAAM-SD and DAAM-SDXL those of one
Stable Diffusion UNet forward (`models/sd_unet.py`).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from conceptattention_torch import native
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.pipeline.concept_pipeline import (
    _full_f32,
    batched_images_saliency,
    batched_noise_saliency,
)
from conceptattention_torch.pipeline.heatmaps import apply_attention_norm

TAPS = ("output", "cross_attention", "value")


def gaussian_blur_3x3(x: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Separable 3x3 gaussian blur over the last two axes with reflect
    padding, in numpy: the plain version of `native.gaussian_blur3`."""
    coords = np.arange(3, dtype=np.float64) - 1.0
    k = np.exp(-(coords**2) / (2 * sigma**2))
    k /= k.sum()
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    xp = np.pad(x, pad, mode="reflect")
    out = k[0] * xp[..., 1:-1, :-2] + k[1] * xp[..., 1:-1, 1:-1] + k[2] * xp[..., 1:-1, 2:]
    outp = np.pad(out, pad[:-1] + [(0, 0)], mode="reflect")
    return k[0] * outp[..., :-2, :] + k[1] * outp[..., 1:-1, :] + k[2] * outp[..., 2:, :]


class SegmentationModel(abc.ABC):
    """Maps (image, concepts, caption) to per-concept coefficient maps, then
    thresholds them into binary masks."""

    @abc.abstractmethod
    def segment_individual_image(
        self, image, concepts: List[str], caption: str, **kwargs
    ) -> Tuple[np.ndarray, Optional[object]]:
        """-> (coefficients [C, h, w], reconstructed image or None)"""

    def __call__(
        self,
        images,
        target_concepts: Optional[List[str]],
        concepts: List[str],
        captions: List[str],
        mean_value_threshold: bool = True,
        apply_blur: bool = False,
        **kwargs,
    ):
        """-> (masks, coefficients, reconstructed), one of each per image."""
        if not isinstance(images, list):
            images = [images]
        all_masks, all_coefficients, reconstructed = [], [], []
        for index, image in enumerate(images):
            coefficients, recon = self.segment_individual_image(
                image, concepts, captions[index], **kwargs
            )
            mask, coeff = self._postprocess_coefficients(
                coefficients, None if target_concepts is None else target_concepts[index],
                concepts, mean_value_threshold, apply_blur,
            )
            all_masks.append(mask)
            all_coefficients.append(coeff)
            reconstructed.append(recon)
        return all_masks, all_coefficients, reconstructed

    @staticmethod
    def _postprocess_coefficients(
        coefficients, target_concept, concepts, mean_value_threshold: bool, apply_blur: bool,
    ):
        """The mask tail shared by the per-image and batched paths: f32 (the
        threshold is taken in f32 whatever the model's dtype), an optional
        blur, then without a target every concept's map against its own mean,
        else the target's map against its mean (or 0)."""
        coefficients = np.asarray(coefficients, dtype=np.float32)
        if apply_blur:
            coefficients = native.gaussian_blur3(coefficients)
        if target_concept is None:
            return coefficients > coefficients.mean(axis=(1, 2), keepdims=True), coefficients
        coeff = coefficients[concepts.index(target_concept)]
        threshold = coeff.mean() if mean_value_threshold else 0.0
        return coeff > threshold, coeff


class FluxTapSegmentationModel(SegmentationModel):
    """Real-image concept segmentation from one saliency tap of a Flux
    pipeline (`ConceptAttentionFluxPipeline` of this package), on its
    attention backend.

    tap="output" is the ConceptAttention method (RawOutputSpace);
    "cross_attention" the raw q-space baseline; "value" the raw value-space
    baseline."""

    def __init__(
        self,
        pipeline,
        tap: str = "output",
        num_steps: int = 4,
        noise_timestep: int = 2,
        num_samples: int = 1,
        layer_indices: Optional[Sequence[int]] = None,
        softmax: bool = False,
        seed: int = 4,
        width: int = 1024,
        height: int = 1024,
        concept_cross_attention: bool = True,
        concept_self_attention: bool = True,
        vae_sample: bool = True,
    ):
        """`concept_cross_attention` / `concept_self_attention` choose the
        keys the concept queries attend over (image keys, concept keys):
        the cross / self ablations. `vae_sample=False` encodes with the
        posterior mean."""
        if tap not in TAPS:
            raise ValueError(f"tap must be one of {TAPS}, got {tap!r}")
        depth = pipeline.cfg.depth
        self.layer_indices = list(range(depth)) if layer_indices is None else [
            int(i) for i in layer_indices]
        bad = [i for i in self.layer_indices if not 0 <= i < depth]
        if bad:
            raise ValueError(f"layer_indices {bad} out of range for depth {depth}")
        self.pipe = pipeline
        self.tap = tap
        self.num_steps = num_steps
        self.noise_timestep = noise_timestep
        self.num_samples = num_samples
        self.softmax = softmax
        self.seed = seed
        self.width = width
        self.height = height
        self.concept_cross_attention = concept_cross_attention
        self.concept_self_attention = concept_self_attention
        self.vae_sample = vae_sample

    def _spec(self):
        return dataclasses.replace(
            self.pipe.attention_spec, taps=(self.tap,), stash_dtype=None,
            cross_attention=self.concept_cross_attention,
            self_attention=self.concept_self_attention,
        )

    def _noise_step(self, z: torch.Tensor) -> float:
        _, _, lh, lw = z.shape
        schedule = get_schedule(self.num_steps, (lh // 2) * (lw // 2),
                                shift=not self.pipe.is_schnell)
        return schedule[self.noise_timestep]

    def _maps(self, image, concepts, caption) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """One image's tap maps [N, L, 1, C, P] (softmax over concepts when
        set) and the token grid. The streams are modulated with the zeroed
        concept vector, as `encode_image` does."""
        pipe = self.pipe
        z = pipe._encode_pixels(image, self.height, self.width, self.seed, sample=self.vae_sample)
        txt, txt_ids, _ = pipe._prepare_text(caption, 1, need_clip=False)
        c_emb, c_ids, c_vec = pipe._prepare_concepts(concepts, 1)
        maps = batched_noise_saliency(
            pipe, z, self._noise_step(z), self.num_samples, self.height, self.width, self.seed,
            txt, txt_ids, c_vec, c_emb, c_ids, c_vec, self._spec(),
        )[self.tap]
        if self.softmax:
            maps = apply_attention_norm(maps, "softmax", dim=-2)
        return maps, (z.shape[2] // 2, z.shape[3] // 2)

    def _layers(self, device) -> torch.Tensor:
        return torch.as_tensor(self.layer_indices, dtype=torch.long, device=device)

    @torch.inference_mode()
    @_full_f32()
    def segment_individual_image(self, image, concepts, caption, **kwargs):
        maps, grid = self._maps(image, concepts, caption)
        coeff = maps[:, self._layers(maps.device)].mean(dim=(0, 1))[0]  # [C, P]
        return coeff.reshape(len(concepts), *grid).float().cpu().numpy(), None

    @torch.inference_mode()
    @_full_f32()
    def segment_batch(
        self,
        images,
        target_concepts,
        concepts_list,
        captions,
        mean_value_threshold: bool = True,
        apply_blur: bool = False,
    ):
        """B images through one VAE-encode pass and ONE stopped forward; the
        outputs are those of B `__call__`s: every image draws the VAE and
        diffusion noise of its own call (the model's seed). Per-image
        concept lists may differ but must share a length. Returns (masks,
        coefficients, [None] * B)."""
        b = len(images)
        if len(concepts_list) != b or len(captions) != b:
            raise ValueError(f"{len(concepts_list)} concept lists and {len(captions)} captions "
                             f"for {b} images")
        c = len(concepts_list[0])
        if any(len(cl) != c for cl in concepts_list):
            raise ValueError("per-image concept lists must share a length in one batch")
        pipe = self.pipe
        zs = pipe._encode_pixels_batch(images, self.height, self.width, [self.seed] * b,
                                       sample=self.vae_sample)
        txts = pipe.text_encoders.encode_t5(list(captions)).to(pipe.device, pipe.dtype)
        txt_ids = torch.zeros((b, txts.shape[1], 3), dtype=torch.float32, device=pipe.device)
        c_embs, c_ids, c_vecs = (torch.cat(parts) for parts in zip(
            *(pipe._prepare_concepts(cl, 1) for cl in concepts_list)))
        maps = batched_images_saliency(
            pipe, zs, self._noise_step(zs), self.num_samples, self.height, self.width, self.seed,
            txts, txt_ids, c_vecs, c_embs, c_ids, c_vecs, self._spec(),
        )[self.tap]  # [B, N, L, C, P]
        if self.softmax:
            maps = apply_attention_norm(maps, "softmax", dim=-2)
        coeff = maps[:, :, self._layers(maps.device)].mean(dim=(1, 2))
        coeff = coeff.reshape(b, c, zs.shape[2] // 2, zs.shape[3] // 2).float().cpu().numpy()
        masks, coefficients = [], []
        for i in range(b):
            mask, cf = self._postprocess_coefficients(
                coeff[i], None if target_concepts is None else target_concepts[i],
                concepts_list[i], mean_value_threshold, apply_blur,
            )
            masks.append(mask)
            coefficients.append(cf)
        return masks, coefficients, [None] * b

    @torch.inference_mode()
    @_full_f32()
    def per_layer_coefficients(self, image, concepts, caption) -> np.ndarray:
        """[depth, C, h, w] coefficient maps, one per double block, from ONE
        forward (averaged over noise samples only)."""
        maps, grid = self._maps(image, concepts, caption)
        coeff = maps.mean(dim=(0, 2))  # [L, C, P]
        return coeff.reshape(-1, len(concepts), *grid).float().cpu().numpy()


def RawOutputSpaceSegmentationModel(pipeline, **kw):
    """The ConceptAttention method (the output tap) as a segmentation model."""
    return FluxTapSegmentationModel(pipeline, tap="output", **kw)


def RawCrossAttentionSegmentationModel(pipeline, **kw):
    """The raw q-space cross-attention baseline."""
    return FluxTapSegmentationModel(pipeline, tap="cross_attention", **kw)


def RawValueSpaceSegmentationModel(pipeline, **kw):
    """The raw value-space baseline."""
    return FluxTapSegmentationModel(pipeline, tap="value", **kw)


def _norm_word(w: str) -> str:
    return "".join(ch for ch in w.lower() if ch.isalnum())


def _same_word(a: str, b: str) -> bool:
    """Word equality up to a plural "s" or "es"."""
    return a == b or a == b + "s" or b == a + "s" or a == b + "es" or b == a + "es"


def match_concept_word_indices(concept: str, words: Sequence[str]) -> List[int]:
    """Indices of `words` that a DAAM concept map aggregates: whole words,
    case, punctuation and plural insensitive ("cat" does not match
    "category"); a multi-word concept matches consecutive words and returns
    every one of their indices."""
    cw = [_norm_word(w) for w in concept.split() if _norm_word(w)]
    ws = [_norm_word(w) for w in words]
    if not cw:
        return []
    idx: set = set()
    n = len(cw)
    for i in range(len(ws) - n + 1):
        if all(_same_word(ws[i + j], cw[j]) for j in range(n)):
            idx.update(range(i, i + n))
    return sorted(idx)


def word_maps_to_concepts(word_maps, concepts: Sequence[str], words: Sequence[str]) -> np.ndarray:
    """[W, h, w] per-word maps -> [C, h, w]: a concept's map is the max over
    the words it matches, else the mean over all words (DAAM's rule)."""
    maps = []
    for concept in concepts:
        hits = [word_maps[i] for i in match_concept_word_indices(concept, words)]
        maps.append(np.maximum.reduce(hits) if hits else np.mean(word_maps, axis=0))
    return np.stack(maps)


class DAAMFluxSegmentationModel(FluxTapSegmentationModel):
    """DAAM-style baseline: the caption's words are the concept set, their
    cross-attention maps (softmax over the words by default) the saliency;
    a requested concept's map is the max over the words it matches, else
    the mean over all words."""

    def __init__(self, pipeline, **kw):
        kw.setdefault("softmax", True)
        super().__init__(pipeline, tap="cross_attention", **kw)

    def segment_individual_image(self, image, concepts, caption, **kwargs):
        words = [w for w in caption.replace(",", " ").split() if w]
        coeff_words, recon = super().segment_individual_image(image, words, caption, **kwargs)
        return word_maps_to_concepts(coeff_words, concepts, words), recon


class DAAMStableDiffusionSegmentationModel(SegmentationModel):
    """DAAM over a Stable Diffusion UNet: encode the image, forward-noise it
    to a late DDIM timestep, run one UNet forward, and aggregate each
    caption word's cross-attention maps (mean over heads, each level
    upsampled nearest to the finest grid, mean over maps); a concept's map
    is the max over the words it matches, else the mean over all words.
    The UNet runs in its parameters' dtype on their device, TF32 off."""

    def __init__(
        self,
        unet_params,
        unet_cfg,
        text_encoders,
        vae_params=None,
        ae_cfg=None,
        latent_size: int = 32,
        timestep_idx: int = 49,  # timesteps[49] of 50: the last, least noisy step
        num_inference_steps: int = 50,
        seed: int = 0,
    ):
        self.params = unet_params
        self.cfg = unet_cfg
        self.text_encoders = text_encoders
        self.vae_params = vae_params
        self.ae_cfg = ae_cfg
        self.latent_size = latent_size
        self.timestep_idx = timestep_idx
        self.num_inference_steps = num_inference_steps
        self.seed = seed
        self.device = unet_params["conv_in"]["w"].device

    def _encode_latents(self, image) -> torch.Tensor:
        """Image -> latents [1, 4, latent, latent]: the VAE's posterior mean
        of the image in [-1, 1], or without VAE weights the RGB channels and
        their mean in [-1, 1] (the random-weight smoke configs)."""
        from conceptattention_torch.evals.baselines import resize_bilinear
        from conceptattention_torch.utils.images import as_float01_chw

        x = torch.from_numpy(as_float01_chw(image))[None].to(self.device)
        if self.vae_params is not None:
            from conceptattention_torch.models.flux.autoencoder import encode

            f = 2 ** (len(self.ae_cfg.ch_mult) - 1)
            return encode(self.vae_params, self.ae_cfg,
                          resize_bilinear(x, self.latent_size * f) * 2 - 1)
        x = resize_bilinear(x, self.latent_size)
        return torch.cat([x, x.mean(dim=1, keepdim=True)], dim=1) * 2 - 1

    def _noise(self, z: torch.Tensor) -> torch.Tensor:
        """The forward-noising draw, from a generator seeded with `seed`."""
        gen = torch.Generator(z.device).manual_seed(self.seed)
        return torch.randn(z.shape, generator=gen, device=z.device, dtype=z.dtype)

    def _context(self, words: List[str]) -> torch.Tensor:
        """[1, T, context_dim]: each word's first T5 embedding row, cut or
        zero-padded to the UNet's context width."""
        ctx = torch.stack([self.text_encoders.encode_t5([w])[0, 0] for w in words])[None]
        ctx = ctx[..., : self.cfg.context_dim].float()
        return F.pad(ctx, (0, self.cfg.context_dim - ctx.shape[-1])).to(self.device)

    @torch.inference_mode()
    @_full_f32()
    def segment_individual_image(self, image, concepts: List[str], caption: str, **kw):
        from conceptattention_torch.sampling.ddim import add_noise, make_ddim_schedule

        words = [w for w in caption.replace(",", " ").split() if w] or list(concepts)
        ctx = self._context(words)
        z = self._encode_latents(image)
        sched = make_ddim_schedule(self.num_inference_steps)
        if not 0 <= self.timestep_idx < self.num_inference_steps:
            raise ValueError(f"timestep_idx {self.timestep_idx} out of range for "
                             f"{self.num_inference_steps} inference steps")
        t = int(sched.timesteps[self.timestep_idx])
        z_t = add_noise(sched, z, self._noise(z), t)
        _, maps = self._unet_call(z_t.float(), torch.tensor([t], dtype=torch.float32,
                                                           device=self.device), ctx, caption)
        side = round(max(m.shape[2] for m in maps) ** 0.5)
        per_word = torch.zeros((len(words), side, side), dtype=torch.float32, device=self.device)
        for m in maps:
            mm = m.mean(dim=1)[0].float()  # [h*w, T]
            s = round(mm.shape[0] ** 0.5)
            reps = side // s
            grid = mm.reshape(s, s, -1).repeat_interleave(reps, 0).repeat_interleave(reps, 1)
            per_word += grid.permute(2, 0, 1) / len(maps)
        return word_maps_to_concepts(per_word.cpu().numpy(), concepts, words), None

    def _unet_call(self, z_t, t_vec, ctx, caption):
        from conceptattention_torch.models.sd_unet import unet_forward

        return unet_forward(self.params, self.cfg, z_t, t_vec, ctx)


class DAAMStableDiffusionXLSegmentationModel(DAAMStableDiffusionSegmentationModel):
    """DAAM over the SDXL UNet: the same flow with SDXL's added conditions,
    the caption's pooled CLIP embedding (cut or zero-padded to the config's
    pooled width) and the six time ids (height, width, crop 0, 0, height,
    width). Use with `SDXL_BASE_CONFIG` and `convert_sd_unet_state_dict`
    over an sd_xl_base checkpoint."""

    def __init__(self, *args, height: int = 512, width: int = 512, **kw):
        super().__init__(*args, **kw)
        self.height = height
        self.width = width

    def _unet_call(self, z_t, t_vec, ctx, caption):
        from conceptattention_torch.models.sd_unet import unet_forward

        pooled = self.text_encoders.encode_clip([caption]).float()
        want = self.cfg.pooled_text_dim
        pooled = F.pad(pooled[..., :want], (0, max(0, want - pooled.shape[-1])))
        time_ids = torch.tensor([[self.height, self.width, 0, 0, self.height, self.width]],
                                dtype=torch.float32, device=self.device)
        return unet_forward(self.params, self.cfg, z_t, t_vec, ctx,
                            text_embeds=pooled.to(self.device), time_ids=time_ids)


class FluxMultiClassSegmentationModel(FluxTapSegmentationModel):
    """Multi-class segmentation: the per-token argmax over the concepts."""

    def segment_multi_class(self, image, concepts: List[str], caption: str):
        coeff, _ = self.segment_individual_image(image, concepts, caption)
        return np.argmax(coeff, axis=0), coeff
