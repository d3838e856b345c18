"""Public pipeline: generate or encode an image and extract concept heatmaps.

Counterpart of the JAX package's `pipeline/concept_pipeline.py`:
`generate_image(prompt, concepts, ...)` (image-to-image with `init_image`),
the batched `generate_images(prompts, concepts, ...)`, `encode_image(image,
concepts, ...)` and the batched `encode_images(images, concepts, ...)`, each
returning `ConceptAttentionPipelineOutput(image, concept_heatmaps,
cross_attention_maps)` (one per prompt or image for the batched calls).

Weights come from the spec's checkpoints when its environment variables name
them (`FLUX_SCHNELL` / `FLUX_DEV` and `AE`, `.safetensors` in the official
key names, `weights/convert.py`), else they are randomly initialized from
`init_seed`, unless parameter trees are passed in (`weights/from_jax.py`).
`quantize="w8" | "w8a8" | "w4"` quantizes the layer stacks: a checkpoint is
converted and quantized on the host and only the quantized tree moves to the
device; without one the stacks are drawn already quantized (`ops/quant.py`).
`int8_qk=True` computes the attention scores of every DiT block from int8 q
and k (K1b). `lora=` merges LoRA adapters into the DiT weights as they are
built (`weights/lora.py`; before the host quantize on the checkpoint path),
and with `keep_base_for_swap=True` a host copy of the pre-merge weights lets
`swap_loras` replace the merged set at run time.

The pipeline runs on one device, "cuda" unless the caller names another; it
never falls back to the CPU. With `mesh=` (`parallel.make_mesh`) the
pipeline runs on the mesh's first device and the DiT over the mesh: a mesh
with `model` or `data` above 1 lays the parameters out by the tensor-
parallel rules (`parallel.sharding.shard_params`, at construction and in
`swap_loras`), so every block runs on each `model` rank's heads and hidden
units (one K1 launch a rank on the fused backend) and a batch that divides
over `data` runs one slice a data index; a ring `attention_backend` splits
the double blocks' attention over the `seq` ring of each (data, model)
slice. On a
card the DiT runs in `dtype` (bf16 by
default), the decode and the saliency stash in bf16, and f32 matmuls and
convolutions in full f32: `generate_image` and `encode_image` turn TF32 off
for their own duration and restore the caller's settings after. On the CPU
the decode and the stash stay f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from conceptattention_torch.config import ModelSpec, configs
from conceptattention_torch.models.flux import autoencoder as vae
from conceptattention_torch.models.flux.dit import flux_forward
from conceptattention_torch.models.flux.params import init_flux_params, tree_map
from conceptattention_torch.models.text.encoders import (
    StubTextEncoders,
    TextEncoders,
    embed_concepts,
)
from conceptattention_torch.ops.attention import RING_BACKENDS, ConceptAttentionSpec
from conceptattention_torch.ops.packing import make_img_ids, pack_latents, unpack_latents
from conceptattention_torch.ops.quant import (
    init_flux_params_quantized,
    int8_gemm_layout,
    quantize_flux_params,
    resolve_quant_mode,
)
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.parallel.mesh import AXES, Mesh
from conceptattention_torch.parallel.sharding import shard_params
from conceptattention_torch.pipeline.heatmaps import heatmaps_to_pil, reduce_maps
from conceptattention_torch.sampling.rectified_flow import denoise, forward_noise, get_noise
from conceptattention_torch.utils.images import as_float01_chw
from conceptattention_torch.utils.profiling import (
    CALL_ENCODE_IMAGES,
    CALL_GENERATE_IMAGES,
    PIPELINE_PREPARE,
    PIPELINE_TO_HOST,
    VAE_DECODE,
    VAE_ENCODE,
    span,
)
from conceptattention_torch.weights.lora import load_lora, merge_loras

# Salt of the VAE reparameterization draw's seed, kept apart from the
# diffusion-noise seeds (seed + i) so the two draws never coincide.
_VAE_SEED_SALT = 0x7AE << 32


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls and convolutions in full f32 for the scope, as the JAX
    package's `lax.conv` and einsums (cuBLAS and cuDNN could run them in
    TF32); the caller's settings come back on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


@dataclasses.dataclass
class ConceptAttentionPipelineOutput:
    image: Any  # PIL.Image.Image | np.ndarray
    concept_heatmaps: Union[List[Any], np.ndarray]
    cross_attention_maps: Union[List[Any], np.ndarray]


def _encode_forward(
    params, cfg, img, img_ids, txt, txt_ids, vec,
    concepts, concept_ids, concept_vec, t_vec, spec, stop_after=True,
) -> Dict[str, torch.Tensor]:
    _, saliency = flux_forward(
        params, cfg, img=img, img_ids=img_ids, txt=txt, txt_ids=txt_ids,
        timesteps=t_vec, y=vec,
        guidance=torch.zeros_like(t_vec) if cfg.guidance_embed else None,
        concepts=concepts, concept_ids=concept_ids, concept_vec=concept_vec,
        stop_after_multimodal_attentions=stop_after, spec=spec,
    )
    return saliency


def batched_noise_saliency(
    pipe, z, t, num_samples, height, width, seed,
    txt, txt_ids, vec, c_emb, c_ids, c_vec, spec, stop_after=True,
):
    """Forward-noise `z` with per-sample generators seeded seed + i, run ONE
    batched forward, and return the saliency dict as [N, L, 1, C, P]
    (samples leading, in the place of the time axis)."""
    _, _, lh, lw = z.shape
    n = num_samples
    with span(PIPELINE_PREPARE):
        noise = torch.cat([
            get_noise(
                torch.Generator(pipe.device).manual_seed(seed + i), 1, height, width, pipe.dtype,
                channels=pipe.spec.ae_params.z_channels, vae_factor=pipe.vae_factor,
            )
            for i in range(n)
        ])
    noised = forward_noise(z.expand(n, -1, -1, -1), noise, t)

    def bc(a):
        return a.expand(n, *a.shape[1:])

    saliency = _encode_forward(
        pipe.params, pipe.cfg, pack_latents(noised),
        make_img_ids(lh // 2, lw // 2, n, device=pipe.device),
        bc(txt), bc(txt_ids), bc(vec), bc(c_emb), bc(c_ids), bc(c_vec),
        torch.full((n,), t, dtype=torch.float32, device=pipe.device),
        spec, stop_after=stop_after,
    )
    return {k: a.transpose(0, 1)[:, :, None] for k, a in saliency.items()}


def _seeds_list(seed, batch: int) -> List[int]:
    """One int, or one per image, as a list of `batch` ints."""
    if np.isscalar(seed):
        return [int(seed)] * batch
    seeds = [int(s) for s in seed]
    if len(seeds) != batch:
        raise ValueError(f"{len(seeds)} seeds for {batch} images")
    return seeds


def batched_images_saliency(
    pipe, zs, t, num_samples, height, width, seed,
    txts, txt_ids, vec, c_embs, c_ids, c_vecs, spec, stop_after=True,
):
    """`batched_noise_saliency` for B images at once: B x N rows in ONE
    stopped forward. Inputs lead with the image axis (`zs` [B, Cz, H', W'],
    `txts` [B, T, d], `c_embs` [B, C, d], `vec` / `c_vecs` [B, d]). `seed`
    is one int or one per image; sample i of image b draws from a generator
    seeded seed_b + i, what that image's own `encode_image` draws. Rows are
    sample-major. Returns the saliency dict as [B, N, L, C, P]."""
    b, _, lh, lw = zs.shape
    n = num_samples
    seeds = _seeds_list(seed, b)
    with span(PIPELINE_PREPARE):
        eps = torch.cat([
            get_noise(
                torch.Generator(pipe.device).manual_seed(seeds[j] + i), 1, height, width,
                pipe.dtype, channels=pipe.spec.ae_params.z_channels, vae_factor=pipe.vae_factor,
            )
            for i in range(n) for j in range(b)
        ])

    def tile(a):
        return a.repeat(n, *([1] * (a.dim() - 1)))

    saliency = _encode_forward(
        pipe.params, pipe.cfg, pack_latents(forward_noise(tile(zs), eps, t)),
        make_img_ids(lh // 2, lw // 2, n * b, device=pipe.device),
        tile(txts), tile(txt_ids), tile(vec), tile(c_embs), tile(c_ids), tile(c_vecs),
        torch.full((n * b,), t, dtype=torch.float32, device=pipe.device),
        spec, stop_after=stop_after,
    )
    return {k: a.reshape(a.shape[0], n, b, *a.shape[2:]).permute(2, 1, 0, 3, 4)
            for k, a in saliency.items()}


def _load_flux_params(path: str, cfg, dtype: torch.dtype, mode: Optional[str],
                      device: torch.device, prepare=lambda params, stage: params):
    """A Flux checkpoint's parameter tree on `device`. Without a quantize
    `mode` each mapped tensor is copied to the device as stored and converted
    there. With one the tree is converted, quantized (one layer in f32 at a
    time) and laid out for the int8 GEMM on the host, then moved, so the
    unquantized tree never reaches the device. `prepare(params, stage)`
    runs on the unquantized tree: on the device ("final"), or on the host
    before the quantize ("prequant")."""
    from conceptattention_torch.weights.convert import convert_flux_state_dict, load_safetensors

    if not mode:
        return prepare(convert_flux_state_dict(load_safetensors(path), cfg, dtype, device), "final")
    params = prepare(convert_flux_state_dict(load_safetensors(path), cfg, dtype), "prequant")
    params = int8_gemm_layout(quantize_flux_params(params, mode=mode))
    return tree_map(lambda x: x.to(device), params)


def _vae_decode(ae_params, cfg, latents_packed, h_tokens, w_tokens, dtype=torch.float32):
    """Packed latents -> [B, 3, H, W] pixels through the NHWC decoder at `dtype`."""
    with span(VAE_DECODE):
        z = unpack_latents(latents_packed.to(dtype), h_tokens, w_tokens)
        return vae.decode_nhwc(tree_map(lambda x: x.to(dtype), ae_params), cfg, z)


def _vae_encode(ae_params, cfg, x, generator: Optional[torch.Generator] = None):
    """[B, 3, H, W] pixels -> scaled latents through the NCHW encoder: the
    posterior mean, or a reparameterized draw from `generator`."""
    with span(VAE_ENCODE):
        return vae.vae_latents(vae.encoder_apply(ae_params["encoder"], cfg, x), cfg, generator)


class ConceptAttentionFluxPipeline:
    """Generate / encode images with Flux and extract concept heatmaps."""

    def __init__(
        self,
        model_name: str = "flux-schnell",
        dtype: torch.dtype = torch.bfloat16,
        params: Optional[dict] = None,
        ae_params: Optional[dict] = None,
        text_encoders: Optional[TextEncoders] = None,
        init_seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        quantize: Union[bool, str] = False,
        attention_backend: str = "fused",
        int8_qk: bool = False,
        lora: Optional[Any] = None,
        mesh: Optional[Mesh] = None,
        lora_strength: Union[float, Sequence[float]] = 1.0,
        keep_base_for_swap: bool = False,
        offload_model: bool = False,
    ):
        """Without `params`, the DiT comes from the checkpoint that
        `spec.ckpt_path` names (its environment variable), else from a
        random init; without `ae_params`, the VAE comes from `spec.ae_path`
        in f32, else from a random init. `quantize` (False, True / "w8",
        "w8a8" or "w4") applies when no `params` are passed: a checkpoint's
        stacks are quantized on the host, a random init's drawn already
        quantized. Passed `params` are used as given, quantized or not. `attention_backend`
        is "fused" (the flash-saliency kernels), "sdpa" (the plain path), or a
        ring backend over the `seq` axis of `mesh` (`parallel.make_mesh`):
        "ring_rdma" (the CUDA ring kernel) or "ring" (the plain ring); the
        double blocks' attention is split over the ring, the single blocks
        run the plain path. `int8_qk` needs "fused". With a mesh the
        pipeline's device is the mesh's first; a mesh with `model` or
        `data` above 1 shards the parameters (`shard_params`), one whose
        only axis above 1 is `seq` keeps them on that device; `device` is
        then left unset.

        `lora` is a LoRA `.safetensors` path, an adapter tree
        (`weights/lora.py`), or a list of either, merged into the DiT at
        `lora_strength` (one value, or one per adapter) as the weights are
        built: on the device in f32, rounded once; on the checkpoint +
        quantize path on the host before the quantize, so the int8 cells
        quantize the adapted weights. `keep_base_for_swap` keeps a host copy
        of the weights before any merge (the bf16 tree before the quantize
        on that path), which `swap_loras` needs. `offload_model` is accepted
        for the JAX package's signature and ignored: the weights stay on
        the device."""
        del offload_model
        if attention_backend not in ("fused", "sdpa", *RING_BACKENDS):
            raise ValueError(
                f"attention_backend must be 'fused', 'sdpa', 'ring' or 'ring_rdma', "
                f"got {attention_backend!r}"
            )
        if int8_qk and attention_backend != "fused":
            raise ValueError(
                f"int8_qk=True requires the fused attention backend, got {attention_backend!r}"
            )
        if attention_backend in RING_BACKENDS and mesh is None:
            raise ValueError(f"attention_backend={attention_backend!r} requires a mesh")
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a device or a mesh, not both: with a mesh the "
                                 "pipeline runs on the mesh's first device")
            device = mesh.devices.flat[0]
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ConceptAttentionFluxPipeline runs on a CUDA device by default and "
                    "none is available; pass device='cpu' to run on the CPU"
                )
        self.spec: ModelSpec = configs[model_name]
        self.model_name = model_name
        self.is_schnell = "schnell" in model_name or model_name == "flux-tiny"
        self.cfg = self.spec.params
        self.dtype = dtype
        self.vae_factor = 2 ** (len(self.spec.ae_params.ch_mult) - 1)
        on_card = self.device.type == "cuda"
        self.decode_dtype = torch.bfloat16 if on_card else torch.float32
        mode = resolve_quant_mode(quantize)
        self._quantize = mode
        self._swap_base = None  # the host copy of the pre-merge tree, for swap_loras
        self._swap_stage = "final"
        adapters, strengths, self._active_loras = self._load_adapters(lora, lora_strength)
        self._adapters = (adapters, strengths)

        def merged(p, stage="final"):
            if keep_base_for_swap:
                self._swap_base = tree_map(lambda x: x.to("cpu"), p)
                self._swap_stage = stage
            return merge_loras(p, adapters, strengths) if adapters else p

        if params is None and self.spec.ckpt_path:
            params = _load_flux_params(self.spec.ckpt_path, self.cfg, dtype, mode, self.device,
                                       merged)
        elif params is None:
            gen = torch.Generator(self.device).manual_seed(init_seed)
            params = merged(init_flux_params_quantized(gen, self.cfg, dtype, mode=mode) if mode
                            else init_flux_params(gen, self.cfg, dtype))
        else:
            params = merged(int8_gemm_layout(params))
        if ae_params is None and self.spec.ae_path:
            from conceptattention_torch.weights.convert import (
                convert_autoencoder_state_dict,
                load_safetensors,
            )

            ae_params = convert_autoencoder_state_dict(
                load_safetensors(self.spec.ae_path), self.spec.ae_params, torch.float32,
                self.device)
        elif ae_params is None:
            ae_params = vae.init_autoencoder_params(
                torch.Generator(self.device).manual_seed(init_seed + 1), self.spec.ae_params
            )
        self.params = self._place(params)
        self.ae_params = ae_params
        if text_encoders is None:
            text_encoders = StubTextEncoders(
                t5_dim=self.cfg.context_in_dim,
                clip_dim=self.cfg.vec_in_dim,
                t5_max_length=self.spec.t5_max_length,
            )
        self.text_encoders = text_encoders
        self.attention_spec = ConceptAttentionSpec(
            taps=("output", "cross_attention"),
            backend=attention_backend,
            int8_qk=int8_qk,
            stash_dtype="bf16" if on_card else None,
            mesh=mesh if attention_backend in RING_BACKENDS else None,
        )

    # ------------------------------------------------------------------
    def _load_adapters(self, lora, lora_strength):
        """(adapters, strengths, descriptors) of the `lora` forms: a
        `.safetensors` path, an adapter tree, or a list of either; the
        descriptors are JSON-able {"source", "strength"} records."""
        items = [] if lora is None else lora if isinstance(lora, (list, tuple)) else [lora]
        adapters = [load_lora(it, self.cfg) if isinstance(it, str) else it for it in items]
        sources = [it if isinstance(it, str) else "<adapter pytree>" for it in items]
        strengths = (list(lora_strength) if isinstance(lora_strength, (list, tuple))
                     else [float(lora_strength)] * len(adapters))
        if len(strengths) != len(adapters):
            raise ValueError(f"{len(adapters)} LoRA adapter(s) but {len(strengths)} strengths")
        descriptors = [{"source": s, "strength": float(st)} for s, st in zip(sources, strengths)]
        return adapters, strengths, descriptors

    @property
    def active_loras(self) -> List[dict]:
        """JSON-able descriptors of the merged adapter set."""
        return list(self._active_loras)

    def swap_loras(self, lora: Optional[Any] = None,
                   lora_strength: Union[float, Sequence[float]] = 1.0) -> List[dict]:
        """Replace the merged adapter set (`lora=None` clears it) from the
        host copy that `keep_base_for_swap=True` kept, building what the
        constructor would have built: on the checkpoint + quantize path the
        adapters merge into the bf16 base on the host and the tree is
        quantized again; otherwise each targeted leaf of the base is merged
        on the device as it is uploaded, and the rest is uploaded as it is.
        The old tree is let go before the new one is built, so two trees
        never share the device; if the build fails, the previous set is
        built again and the error raised. Not safe against forwards running
        on other threads: the serving daemon runs swaps on its one worker
        thread. Returns the new descriptors."""
        if self._swap_base is None:
            raise RuntimeError("swap_loras needs keep_base_for_swap=True at construction (the "
                               "pipeline keeps no copy of its pre-merge weights by default)")
        adapters, strengths, descriptors = self._load_adapters(lora, lora_strength)
        previous = self._adapters
        self.params = None
        try:
            self.params = self._params_from_base(adapters, strengths)
        except BaseException:
            self.params = self._params_from_base(*previous)
            raise
        self._adapters = (adapters, strengths)
        self._active_loras = descriptors
        return self.active_loras

    def _params_from_base(self, adapters, strengths):
        """The device tree of the host base with `adapters` merged."""
        if self._swap_stage == "prequant":
            p = merge_loras(self._swap_base, adapters, strengths) if adapters else self._swap_base
            p = int8_gemm_layout(quantize_flux_params(p, mode=self._quantize))
        else:
            p = (merge_loras(self._swap_base, adapters, strengths, device=self.device)
                 if adapters else self._swap_base)
        return self._place(tree_map(lambda x: x.to(self.device), p))

    def _place(self, params):
        """The DiT tree laid out over the mesh (tensor-parallel rules) when
        its `model` or `data` axis is above 1; else as it is."""
        mesh = self.mesh
        if mesh is None or (mesh.shape[AXES.model] == 1 and mesh.shape[AXES.data] == 1):
            return params
        return shard_params(params, mesh, self.cfg)

    # ------------------------------------------------------------------
    def _prepare_text(self, prompt: str, batch_size: int = 1, need_clip: bool = True):
        """(txt, txt_ids, vec); vec is None when `need_clip` is False (the
        encode path modulates with the zeroed concept vector instead)."""
        txt = self.text_encoders.encode_t5([prompt]).to(self.device, self.dtype)
        txt = txt.expand(batch_size, -1, -1)
        vec = None
        if need_clip:
            vec = self.text_encoders.encode_clip([prompt]).to(self.device, self.dtype)
            vec = vec.expand(batch_size, -1)
        txt_ids = torch.zeros((batch_size, txt.shape[1], 3), dtype=torch.float32, device=self.device)
        return txt, txt_ids, vec

    def _prepare_concepts(self, concepts: List[str], batch_size: int = 1):
        c_emb, c_ids, c_vec = embed_concepts(self.text_encoders, concepts, batch_size)
        return (c_emb.to(self.device, self.dtype), c_ids.to(self.device),
                c_vec.to(self.device, self.dtype))

    def _layer_indices(self, layer_indices):
        depth = self.cfg.depth
        if layer_indices is None:
            return list(range(max(0, depth - 4), depth))
        if not all(0 <= i < depth for i in layer_indices):
            raise ValueError(f"layer_indices {list(layer_indices)} out of range for depth {depth}")
        return list(layer_indices)

    @staticmethod
    def _check_size(height: int, width: int):
        if height % 16 or width % 16:
            raise ValueError("height/width must be multiples of 16 (VAE 8x + 2x2 packing)")

    # ------------------------------------------------------------------
    def generate_image(
        self,
        prompt: str,
        concepts: List[str],
        width: int = 1024,
        height: int = 1024,
        return_cross_attention: bool = False,  # reference parity; maps are always returned
        layer_indices: Optional[Sequence[int]] = None,
        return_pil_heatmaps: bool = True,
        seed: int = 0,
        num_inference_steps: int = 4,
        guidance: float = 0.0,
        timesteps: Optional[Sequence[int]] = None,
        softmax: bool = True,
        attention_norm: str = "sparsemax",
        cmap: str = "plasma",
        return_image_array: bool = False,
        init_image=None,
        image2image_strength: float = 0.8,
        watermark: bool = True,
    ) -> ConceptAttentionPipelineOutput:
        """Generate an image and per-concept heatmaps (defaults: layers
        depth-4..depth-1, all timesteps, softmax over concepts; softmax=True
        overrides attention_norm). With `init_image`, image-to-image: the
        denoise starts from the VAE encoding of `init_image` forward-noised
        to step int((1 - image2image_strength) * num_inference_steps) of the
        schedule and runs the rest of it; the default `timesteps` then cover
        the steps that run."""
        return self._generate(
            [prompt], concepts, width, height, layer_indices, return_pil_heatmaps, seed,
            num_inference_steps, guidance, timesteps, softmax, attention_norm, cmap,
            return_image_array, watermark, [seed], init_image, image2image_strength,
        )[0]

    def generate_images(
        self,
        prompts: List[str],
        concepts: List[str],
        width: int = 1024,
        height: int = 1024,
        layer_indices: Optional[Sequence[int]] = None,
        return_pil_heatmaps: bool = True,
        seed: int = 0,
        num_inference_steps: int = 4,
        guidance: float = 0.0,
        timesteps: Optional[Sequence[int]] = None,
        softmax: bool = True,
        attention_norm: str = "sparsemax",
        cmap: str = "plasma",
        return_image_array: bool = False,
        watermark: bool = True,
        seeds: Optional[Sequence[int]] = None,
    ) -> List[ConceptAttentionPipelineOutput]:
        """One batched denoise for all prompts (shared concepts and
        schedule), then one decode per image; one output per prompt, in
        order. With `seeds`, prompt i draws exactly the noise of
        `generate_image(seed=seeds[i])`, so its output does not depend on
        its batch; without, one [B, ...] draw from `seed`."""
        return self._generate(
            prompts, concepts, width, height, layer_indices, return_pil_heatmaps, seed,
            num_inference_steps, guidance, timesteps, softmax, attention_norm, cmap,
            return_image_array, watermark, seeds,
        )

    @torch.inference_mode()
    @_full_f32()
    def _generate(
        self, prompts, concepts, width, height, layer_indices, return_pil_heatmaps, seed,
        num_inference_steps, guidance, timesteps, softmax, attention_norm, cmap,
        return_image_array, watermark, seeds, init_image=None, image2image_strength=0.8,
    ) -> List[ConceptAttentionPipelineOutput]:
        with span(CALL_GENERATE_IMAGES):
            b = len(prompts)
            if b == 0:
                return []
            if seeds is not None and len(seeds) != b:
                raise ValueError(f"seeds has {len(seeds)} entries for {b} prompts")
            layer_indices = self._layer_indices(layer_indices)
            self._check_size(height, width)
            if timesteps is None:
                timesteps = list(range(num_inference_steps))

            def noise_of(s, n):
                return get_noise(
                    torch.Generator(self.device).manual_seed(int(s)), n, height, width,
                    self.dtype, channels=self.spec.ae_params.z_channels,
                    vae_factor=self.vae_factor,
                )

            with span(PIPELINE_PREPARE):
                noise = (noise_of(seed, b) if seeds is None
                         else torch.cat([noise_of(s, 1) for s in seeds]))
            _, _, lh, lw = noise.shape
            schedule = get_schedule(
                num_inference_steps, (lh // 2) * (lw // 2), shift=not self.is_schnell
            )
            if init_image is not None:
                z0 = self._encode_pixels(init_image, height, width, seed)
                t_idx = max(int((1.0 - image2image_strength) * num_inference_steps), 0)
                if t_idx >= num_inference_steps:
                    raise ValueError(
                        f"image2image_strength={image2image_strength} leaves no denoise steps "
                        "(and so no concept saliency); use a strength above 0, or "
                        "encode_image() for the heatmaps of an unmodified image"
                    )
                t = schedule[t_idx]
                schedule = schedule[t_idx:]
                noise = (t * noise.float() + (1.0 - t) * z0.float()).to(noise.dtype)
                if list(timesteps) == list(range(num_inference_steps)):
                    timesteps = list(range(len(schedule) - 1))
            with span(PIPELINE_PREPARE):
                txt = self.text_encoders.encode_t5(list(prompts)).to(self.device, self.dtype)
                vec = self.text_encoders.encode_clip(list(prompts)).to(self.device, self.dtype)
                txt_ids = torch.zeros((b, txt.shape[1], 3), dtype=torch.float32,
                                      device=self.device)
                c_emb, c_ids, c_vec = self._prepare_concepts(concepts, b)
            latents, saliency = denoise(
                self.params, self.cfg, pack_latents(noise),
                make_img_ids(lh // 2, lw // 2, b, device=self.device),
                txt, txt_ids, vec, schedule, guidance,
                concepts=c_emb, concept_ids=c_ids, concept_vec=c_vec, spec=self.attention_spec,
            )
            grid = (lh // 2, lw // 2)
            concept_heatmaps = reduce_maps(
                saliency["output"], layer_indices, timesteps, softmax, attention_norm, grid
            )
            cross_attention_maps = reduce_maps(
                saliency["cross_attention"], layer_indices, timesteps, softmax, attention_norm,
                grid,
            )
            return [
                self._package_output(
                    self._decode_image(latents[i : i + 1], grid, watermark, return_image_array),
                    concept_heatmaps[i : i + 1], cross_attention_maps[i : i + 1],
                    return_pil_heatmaps, cmap,
                )
                for i in range(b)
            ]

    def _decode_image(self, latents, grid, watermark: bool, return_image_array: bool):
        """Packed latents of one image -> HWC uint8 array (or PIL image),
        watermarked unless `watermark` is False."""
        pixels = _vae_decode(
            self.ae_params, self.spec.ae_params, latents, grid[0], grid[1], dtype=self.decode_dtype
        )
        image = self._pixels_to_uint8(pixels[0])
        if watermark:
            from conceptattention_torch.utils.watermark import embed_watermark

            image = embed_watermark(image)
        if not return_image_array:
            import PIL.Image

            image = PIL.Image.fromarray(image)
        return image

    # ------------------------------------------------------------------
    @torch.inference_mode()
    @_full_f32()
    def encode_image(
        self,
        image,
        concepts: List[str],
        prompt: str = "",
        width: int = 1024,
        height: int = 1024,
        layer_indices: Optional[Sequence[int]] = None,
        num_samples: int = 1,
        num_steps: int = 4,
        noise_timestep: int = 2,
        return_pil_heatmaps: bool = True,
        seed: int = 0,
        cmap: str = "plasma",
        stop_after_multi_modal_attentions: bool = True,
        attention_norm: str = "sparsemax",
        softmax: bool = True,
    ) -> ConceptAttentionPipelineOutput:
        """Concept heatmaps of a real image: VAE-encode, forward-noise to
        `noise_timestep`, one DiT forward stopping after the double blocks."""
        with span(CALL_ENCODE_IMAGES):
            layer_indices = self._layer_indices(layer_indices)
            self._check_size(height, width)
            z = self._encode_pixels(image, height, width, seed)
            with span(PIPELINE_PREPARE):
                txt, txt_ids, _ = self._prepare_text(prompt, 1, need_clip=False)
                c_emb, c_ids, c_vec = self._prepare_concepts(concepts, 1)
            _, _, lh, lw = z.shape
            schedule = get_schedule(num_steps, (lh // 2) * (lw // 2), shift=not self.is_schnell)
            # The encode protocol modulates both streams with the zeroed concept
            # vector (y = concept_vec), not the prompt's pooled vector.
            saliency = batched_noise_saliency(
                self, z, schedule[noise_timestep], num_samples, height, width, seed,
                txt, txt_ids, c_vec, c_emb, c_ids, c_vec, self.attention_spec,
                stop_after=stop_after_multi_modal_attentions,
            )
            grid = (lh // 2, lw // 2)
            concept_heatmaps = reduce_maps(
                saliency["output"], layer_indices, None, softmax, attention_norm, grid
            )
            cross_attention_maps = reduce_maps(
                saliency["cross_attention"], layer_indices, None, softmax, attention_norm, grid
            )
            return self._package_output(
                image, concept_heatmaps, cross_attention_maps, return_pil_heatmaps, cmap
            )

    # ------------------------------------------------------------------
    @torch.inference_mode()
    @_full_f32()
    def encode_images(
        self,
        images,
        concepts,
        prompts=None,
        width: int = 1024,
        height: int = 1024,
        layer_indices: Optional[Sequence[int]] = None,
        num_samples: int = 1,
        num_steps: int = 4,
        noise_timestep: int = 2,
        return_pil_heatmaps: bool = True,
        seeds=None,
        cmap: str = "plasma",
        stop_after_multi_modal_attentions: bool = True,
        attention_norm: str = "sparsemax",
        softmax: bool = True,
    ) -> List[ConceptAttentionPipelineOutput]:
        """`encode_image` for B images with one stopped forward over all B x
        `num_samples` rows. `concepts` is one list shared by every image or
        one list per image, all of one length; `prompts` one string or one
        per image; `seeds` one int or one per image. The outputs are those of
        B separate `encode_image` calls: each image draws its VAE noise and
        its forward noise from its own generators."""
        with span(CALL_ENCODE_IMAGES):
            b = len(images)
            if b == 0:
                return []
            if concepts and isinstance(concepts[0], str):
                concepts_list = [list(concepts)] * b
            else:
                concepts_list = [list(c) for c in concepts]
                if len(concepts_list) != b:
                    raise ValueError(f"{len(concepts_list)} concept lists for {b} images")
            if len({len(c) for c in concepts_list}) != 1:
                raise ValueError("per-image concept lists must share a length in one batch")
            if prompts is None:
                prompts = [""] * b
            elif isinstance(prompts, str):
                prompts = [prompts] * b
            if len(prompts) != b:
                raise ValueError(f"{len(prompts)} prompts for {b} images")
            seeds = _seeds_list(0 if seeds is None else seeds, b)
            layer_indices = self._layer_indices(layer_indices)
            self._check_size(height, width)

            zs = self._encode_pixels_batch(images, height, width, seeds)
            _, _, lh, lw = zs.shape
            schedule = get_schedule(num_steps, (lh // 2) * (lw // 2), shift=not self.is_schnell)
            with span(PIPELINE_PREPARE):
                txts = self.text_encoders.encode_t5(list(prompts)).to(self.device, self.dtype)
                txt_ids = torch.zeros((b, txts.shape[1], 3), dtype=torch.float32,
                                      device=self.device)
                c_embs, c_ids, c_vecs = (torch.cat(parts) for parts in zip(
                    *(self._prepare_concepts(c, 1) for c in concepts_list)))
            # y is the zeroed concept vector, as in encode_image
            saliency = batched_images_saliency(
                self, zs, schedule[noise_timestep], num_samples, height, width, seeds,
                txts, txt_ids, c_vecs, c_embs, c_ids, c_vecs, self.attention_spec,
                stop_after=stop_after_multi_modal_attentions,
            )
            grid = (lh // 2, lw // 2)
            outputs = []
            for i in range(b):
                sal = {k: a[i][:, :, None] for k, a in saliency.items()}  # [N, L, 1, C, P]
                outputs.append(self._package_output(
                    images[i],
                    reduce_maps(sal["output"], layer_indices, None, softmax, attention_norm, grid),
                    reduce_maps(sal["cross_attention"], layer_indices, None, softmax,
                                attention_norm, grid),
                    return_pil_heatmaps, cmap,
                ))
            return outputs

    # ------------------------------------------------------------------
    def _resize_pixels(self, image, height: int, width: int) -> torch.Tensor:
        """PIL / array -> [1, 3, H, W] f32 in [-1, 1], resized bilinearly with
        antialiasing when downsampling (as `jax.image.resize` does)."""
        with span(PIPELINE_PREPARE):
            x = torch.from_numpy(2.0 * as_float01_chw(image) - 1.0)[None].to(self.device)
            return F.interpolate(
                x, size=(height, width), mode="bilinear", antialias=True, align_corners=False
            )

    def _encode_pixels(self, image, height: int, width: int, seed: int,
                       sample: bool = True) -> torch.Tensor:
        """PIL / array -> VAE latents [1, z, H/f, W/f] in the pipeline dtype;
        `sample=False` returns the posterior mean."""
        return self._encode_pixels_batch([image], height, width, [seed], sample)

    def _encode_pixels_batch(self, images, height: int, width: int, seeds: Sequence[int],
                             sample: bool = True) -> torch.Tensor:
        """B images -> [B, z, H/f, W/f] latents, each image through the
        encoder alone with its reparameterization draw from its own generator
        (seeds[b] + the VAE salt): row b is image b's own `_encode_pixels`.
        One image at a time keeps one image's 1024^2 first-stage activations
        beside the resident DiT."""
        out = [
            _vae_encode(self.ae_params, self.spec.ae_params, self._resize_pixels(im, height, width),
                        torch.Generator(self.device).manual_seed(_VAE_SEED_SALT + int(s))
                        if sample else None)
            for im, s in zip(images, seeds)
        ]
        return torch.cat(out).to(self.dtype)

    @staticmethod
    def _pixels_to_uint8(p: torch.Tensor) -> np.ndarray:
        """[3, H, W] decode output -> HWC uint8 (f32 upcast first, so a bf16
        decode maps to 0..255 exactly as an f32 one)."""
        with span(PIPELINE_TO_HOST):
            x = torch.clamp(p.float(), -1.0, 1.0)
            return ((x + 1.0) * 127.5).permute(1, 2, 0).cpu().numpy().astype(np.uint8)

    def _package_output(
        self, image, concept_heatmaps, cross_attention_maps, return_pil: bool, cmap: str
    ) -> ConceptAttentionPipelineOutput:
        with span(PIPELINE_TO_HOST):
            concept_heatmaps = concept_heatmaps.float().cpu().numpy()[0]
            cross_attention_maps = cross_attention_maps.float().cpu().numpy()[0]
            if return_pil:
                concept_heatmaps = heatmaps_to_pil(concept_heatmaps, cmap)
                cross_attention_maps = heatmaps_to_pil(cross_attention_maps, cmap)
        return ConceptAttentionPipelineOutput(
            image=image,
            concept_heatmaps=concept_heatmaps,
            cross_attention_maps=cross_attention_maps,
        )
