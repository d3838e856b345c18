"""The port's pipeline, as a whole, against the JAX package's, on the CPU.

Both pipelines hold the same flux-tiny weights (the JAX init, carried across
by `weights/from_jax.py`) and f32 activations. The JAX package draws its
noise from threefry, which torch cannot reproduce, so the noise is made with
numpy and injected at the stage that consumes it: the packed latents handed
to `denoise`, and the forward-noising of the encoded image. Tolerances: 1e-4
for latents, saliency and heatmaps (two denoise steps of the tiny DiT in f32,
reduction order apart), 1e-3 for decoded pixels, one grey level for the uint8
image (a pixel within 1e-3 of a rounding edge may land on either side).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.models.text import encoders as t_enc
from conceptattention_torch.ops.packing import make_img_ids as t_img_ids
from conceptattention_torch.ops.packing import pack_latents as t_pack
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.pipeline import concept_pipeline as t_pipe
from conceptattention_torch.pipeline import heatmaps as t_heat
from conceptattention_torch.sampling import rectified_flow as t_flow
from conceptattention_torch.utils import images as t_images
from conceptattention_torch.utils import watermark as t_wm
from conceptattention_torch.weights.from_jax import ae_params_from_numpy, flux_params_from_numpy
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.models.text import encoders as j_enc
from conceptattention_tpu.ops.packing import make_img_ids as j_img_ids
from conceptattention_tpu.ops.packing import pack_latents as j_pack
from conceptattention_tpu.pipeline import concept_pipeline as j_pipe
from conceptattention_tpu.pipeline import heatmaps as j_heat
from conceptattention_tpu.sampling import rectified_flow as j_flow
from conceptattention_tpu.utils import images as j_images
from conceptattention_tpu.utils import watermark as j_wm

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)
PIXELS = dict(rtol=1e-3, atol=1e-3)
PROMPT, CONCEPTS = "a dragon on a rock", ["dragon", "rock", "sky"]
SIZE, STEPS = 32, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(got, want, tol=TOL, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **tol)


@pytest.fixture(scope="module")
def pipes():
    j = JaxPipeline("flux-tiny", dtype=jnp.float32)
    t = TorchPipeline(
        "flux-tiny", dtype=torch.float32, device="cpu",
        params=flux_params_from_numpy(jax.tree.map(np.asarray, j.params)),
        ae_params=ae_params_from_numpy(jax.tree.map(np.asarray, j.ae_params)),
    )
    return t, j


@pytest.fixture(scope="module")
def generated(pipes):
    """Both pipelines' generate stages on the same injected noise: denoise,
    then the heatmap reduction, then the VAE decode."""
    t, j = pipes
    noise = np.random.default_rng(0).standard_normal(
        (1, t.spec.ae_params.z_channels, SIZE // t.vae_factor, SIZE // t.vae_factor)
    ).astype(np.float32)
    lh, lw = noise.shape[2:]
    grid = (lh // 2, lw // 2)
    schedule = get_schedule(STEPS, grid[0] * grid[1], shift=False)

    txt, txt_ids, vec = t._prepare_text(PROMPT)
    c_emb, c_ids, c_vec = t._prepare_concepts(CONCEPTS)
    t_lat, t_sal = t_flow.denoise(
        t.params, t.cfg, t_pack(torch.from_numpy(noise)), t_img_ids(*grid, 1), txt, txt_ids,
        vec, schedule, 0.0, concepts=c_emb, concept_ids=c_ids, concept_vec=c_vec,
        spec=t.attention_spec,
    )
    txt, txt_ids, vec = j._prepare_text(PROMPT)
    c_emb, c_ids, c_vec = j._prepare_concepts(CONCEPTS)
    j_lat, j_sal = j_pipe._generate_latents(
        j.params, j.cfg, j_pack(jnp.asarray(noise)), j_img_ids(*grid, 1), txt, txt_ids, vec,
        c_emb, c_ids, c_vec, jnp.asarray(schedule), 0.0, j._attention_spec(), j.cfg.guidance_embed,
    )
    t_pix = t_pipe._vae_decode(t.ae_params, t.spec.ae_params, t_lat, *grid)
    j_pix = j_pipe._vae_decode(j.ae_params, j.spec.ae_params, j_lat, *grid)
    return dict(grid=grid, t_lat=t_lat, j_lat=j_lat, t_sal=t_sal, j_sal=j_sal,
                t_pix=t_pix, j_pix=j_pix)


def test_denoise_latents_and_saliency(generated):
    close(generated["t_lat"], generated["j_lat"], msg="latents")
    for tap in ("output", "cross_attention"):
        assert generated["t_sal"][tap].shape == (STEPS, 2, 1, len(CONCEPTS), 64)
        close(generated["t_sal"][tap], generated["j_sal"][tap], msg=tap)


@pytest.mark.parametrize(
    "softmax,norm,timesteps,layers",
    [(True, "sparsemax", None, [0, 1]), (False, "sparsemax", [1], [1]),
     (False, "entmax15", [0, 1], [0]), (False, "none", None, [1, 0])],
)
def test_reduce_maps(generated, softmax, norm, timesteps, layers):
    for tap in ("output", "cross_attention"):
        got = t_heat.reduce_maps(generated["t_sal"][tap], layers, timesteps, softmax, norm,
                                 generated["grid"])
        want = j_heat.reduce_maps(generated["j_sal"][tap], layers, timesteps, softmax, norm,
                                  generated["grid"])
        assert got.shape == (1, len(CONCEPTS), *generated["grid"])
        close(got, want, msg=tap)


@pytest.mark.parametrize("bad", [dict(layer_indices=[-1]), dict(layer_indices=[2]),
                                 dict(timesteps=[-1]), dict(timesteps=[STEPS])])
def test_reduce_maps_rejects_out_of_range(generated, bad):
    """Tensor indexing would wrap -1 to the last layer; the port refuses it as
    the JAX package does."""
    args = dict(layer_indices=[0], timesteps=None) | bad
    with pytest.raises(ValueError):
        t_heat.reduce_maps(generated["t_sal"]["output"], args["layer_indices"], args["timesteps"])
    with pytest.raises(ValueError):
        j_heat.reduce_maps(generated["j_sal"]["output"], args["layer_indices"], args["timesteps"])


def test_vae_decode_and_uint8(generated):
    close(generated["t_pix"], generated["j_pix"], tol=PIXELS)
    got = TorchPipeline._pixels_to_uint8(generated["t_pix"][0])
    want = JaxPipeline._pixels_to_uint8(generated["j_pix"][0])
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("src", [(48, 40), (20, 24)])
def test_resize_matches_jax_image_resize(pipes, src):
    """Bilinear resize with antialiasing when downsampling (48x40 -> 32x32)
    and plain bilinear when upsampling, as `jax.image.resize` does."""
    t, _ = pipes
    image = np.random.default_rng(1).integers(0, 256, (*src, 3), dtype=np.uint8)
    got = t._resize_pixels(image, SIZE, SIZE)
    x = jnp.asarray(2.0 * j_images.as_float01_chw(image) - 1.0)[None]
    want = jax.image.resize(x, (1, 3, SIZE, SIZE), method="bilinear")
    close(got, want, tol=dict(rtol=1e-5, atol=1e-5))
    # without antialiasing the downsampling case would not match
    plain = F.interpolate(got.new_tensor(np.asarray(x)), size=(SIZE, SIZE), mode="bilinear",
                          align_corners=False)
    assert (src[0] > SIZE) == (not np.allclose(plain.numpy(), np.asarray(want), atol=1e-3))


def test_encode_stages(pipes):
    """`encode_image`'s stages: resize + VAE encode (posterior mean), forward
    noising with injected noise at the schedule's noise step, the stopped
    forward, then the heatmap reduction."""
    t, j = pipes
    image = np.random.default_rng(2).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    t_z = t._encode_pixels(image, SIZE, SIZE, seed=0, sample=False)
    j_z = j._encode_pixels(image, SIZE, SIZE, seed=0, sample=False)
    close(t_z, j_z, msg="latents")
    lh, lw = t_z.shape[2:]
    grid = (lh // 2, lw // 2)
    tt = get_schedule(4, grid[0] * grid[1], shift=False)[2]
    noise = np.random.default_rng(3).standard_normal(t_z.shape).astype(np.float32)
    t_noised = t_flow.forward_noise(t_z, torch.from_numpy(noise), tt)
    j_noised = j_flow.forward_noise(j_z, jnp.asarray(noise), tt)
    close(t_noised, j_noised, msg="noised")

    txt, txt_ids, _ = t._prepare_text("", 1, need_clip=False)
    c_emb, c_ids, c_vec = t._prepare_concepts(CONCEPTS)
    t_sal = t_pipe._encode_forward(
        t.params, t.cfg, t_pack(t_noised), t_img_ids(*grid, 1), txt, txt_ids, c_vec,
        c_emb, c_ids, c_vec, torch.full((1,), tt), t.attention_spec)
    txt, txt_ids, _ = j._prepare_text("", 1, need_clip=False)
    c_emb, c_ids, c_vec = j._prepare_concepts(CONCEPTS)
    forward = jax.jit(j_pipe._encode_forward, static_argnames=("cfg", "spec", "stop_after"))
    j_sal = forward(
        j.params, j.cfg, j_pack(j_noised), j_img_ids(*grid, 1), txt, txt_ids, c_vec,
        c_emb, c_ids, c_vec, jnp.full((1,), tt, jnp.float32), j._attention_spec())
    for tap in ("output", "cross_attention"):
        got = t_heat.reduce_maps(t_sal[tap][None], [0, 1], None, True, "sparsemax", grid)
        want = j_heat.reduce_maps(j_sal[tap][None], [0, 1], None, True, "sparsemax", grid)
        close(got, want, msg=tap)


def test_generate_and_encode_end_to_end(pipes):
    """The public entry points on the CPU: shapes, dtypes, finite maps and no
    kernel launch (CPU tensors take the plain versions)."""
    from conceptattention_torch.kernels.conv3x3 import conv3x3_same
    from conceptattention_torch.kernels.flash_saliency import fused_concept_flash_attention

    t, _ = pipes
    before = (fused_concept_flash_attention.launches, conv3x3_same.launches)
    out = t.generate_image(PROMPT, CONCEPTS, width=SIZE, height=SIZE, num_inference_steps=STEPS,
                           return_pil_heatmaps=False, return_image_array=True)
    grid = SIZE // (2 * t.vae_factor)
    assert out.image.shape == (SIZE, SIZE, 3) and out.image.dtype == np.uint8
    for maps in (out.concept_heatmaps, out.cross_attention_maps):
        assert maps.shape == (len(CONCEPTS), grid, grid) and np.isfinite(maps).all()
    image = np.random.default_rng(4).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    enc = t.encode_image(image, CONCEPTS, width=SIZE, height=SIZE)
    assert len(enc.concept_heatmaps) == len(CONCEPTS)  # PIL heatmaps by default
    assert enc.concept_heatmaps[0].size == (grid, grid)
    i2i = t.generate_image(PROMPT, CONCEPTS, width=SIZE, height=SIZE, num_inference_steps=STEPS,
                           init_image=image, image2image_strength=0.5,
                           return_pil_heatmaps=False, return_image_array=True)
    assert i2i.image.shape == (SIZE, SIZE, 3) and np.isfinite(i2i.concept_heatmaps).all()
    assert (fused_concept_flash_attention.launches, conv3x3_same.launches) == before
    with pytest.raises(ValueError, match="no denoise steps"):
        t.generate_image(PROMPT, CONCEPTS, width=SIZE, height=SIZE, init_image=image,
                         image2image_strength=0.0)


def test_entry_points_scope_tf32_off(pipes, monkeypatch):
    """The f32 VAE encode runs with TF32 off, and the caller's settings come
    back after the call."""
    t, _ = pipes
    seen = []
    vae_encode = t_pipe._vae_encode

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return vae_encode(*args, **kwargs)

    monkeypatch.setattr(t_pipe, "_vae_encode", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    image = np.random.default_rng(6).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    t.encode_image(image, CONCEPTS, width=SIZE, height=SIZE, return_pil_heatmaps=False)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_stub_text_encoders_bit_identical():
    t_stub, j_stub = t_enc.StubTextEncoders(64, 32, 16), j_enc.StubTextEncoders(64, 32, 16)
    np.testing.assert_array_equal(t_stub.encode_t5([PROMPT, ""]).numpy(),
                                  np.asarray(j_stub.encode_t5([PROMPT, ""])))
    np.testing.assert_array_equal(t_stub.encode_clip([PROMPT]).numpy(),
                                  np.asarray(j_stub.encode_clip([PROMPT])))
    for got, want in zip(t_enc.embed_concepts(t_stub, CONCEPTS, 2),
                         j_enc.embed_concepts(j_stub, CONCEPTS, 2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_image_helpers_bit_identical():
    image = np.random.default_rng(5).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_images.as_float01_chw(image), j_images.as_float01_chw(image))
    np.testing.assert_array_equal(t_wm.embed_watermark(image), j_wm.embed_watermark(image))


def test_import_leaves_out_jax():
    """The port's modules (and the smoke script) import no JAX, nothing of
    the JAX package, neither `safetensors` nor `transformers`, and the eval
    path's modules neither `h5py`, PIL nor matplotlib (the loaders import
    them when they read files, the sweep plots when they draw)."""
    modules = ("conceptattention_torch, conceptattention_torch.pipeline.concept_pipeline, "
               "conceptattention_torch.weights.convert, conceptattention_torch.models.text.t5, "
               "conceptattention_torch.models.text.clip, conceptattention_torch.models.text.encoders, "
               "conceptattention_torch.models.flux.autoencoder, "
               "conceptattention_torch.sampling.rectified_flow, conceptattention_torch.utils.watermark, "
               "conceptattention_torch.pipeline.concept_encoding, conceptattention_torch.native, "
               "conceptattention_torch.evals, conceptattention_torch.evals.segmentation, "
               "conceptattention_torch.evals.datasets, conceptattention_torch.utils.eval_state, "
               "conceptattention_torch.utils.plotting, "
               "conceptattention_torch.experiments.imagenet_segmentation, "
               "conceptattention_torch.experiments.voc_single_class, "
               "conceptattention_torch.experiments.voc_multi_class, "
               "conceptattention_torch.models.vit, conceptattention_torch.models.clip_vit, "
               "conceptattention_torch.evals.lrp, conceptattention_torch.evals.baselines, "
               "conceptattention_torch.evals.textspan, conceptattention_torch.evals.model_zoo, "
               "conceptattention_torch.utils.sweep_plots, "
               "conceptattention_torch.experiments.per_layer_segmentation, "
               "conceptattention_torch.experiments.per_timestep_segmentation, "
               "conceptattention_torch.experiments.plot_segmentations_per_layer, "
               "conceptattention_torch.experiments.plot_segmentations_per_time, "
               "conceptattention_torch.models.sd_unet, conceptattention_torch.evals.perturbation, "
               "conceptattention_torch.evals.imagenet_data, "
               "conceptattention_torch.evals.imagenet_classes, conceptattention_torch.utils.data, "
               "conceptattention_torch.utils.colormaps, "
               "conceptattention_torch.experiments.perturbation, "
               "conceptattention_torch.experiments.compare_methods, "
               "chip_smoke")
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'conceptattention_tpu', 'safetensors', 'transformers', 'h5py', 'PIL', "
            "'matplotlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchPipeline("flux-tiny")
