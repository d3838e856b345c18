"""The rest of the port's flux surface against the JAX package's, on the CPU.

Image-to-image, true classifier-free guidance, `prepare`, the batched
`encode_images`, the VAE's NCHW decode and NHWC encode, the torch-parity
noise, and watermark extraction. Both packages hold the same flux-tiny
weights in f32. The JAX package draws noise from threefry, so noise is made
with numpy and injected into both (`get_noise` of each pipeline module, and
the posterior mean in place of the VAE's draw). Tolerances are those of
`tests/test_torch_pipeline.py`: 1e-4 for latents and heatmaps, 1e-3 for
pixels, one grey level for uint8 images; `encode_images` against sequential
`encode_image` calls in the port uses the JAX package's own limit for that
check (rtol 2e-4, atol 1e-6: the batched forward sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.models.flux import autoencoder as t_vae
from conceptattention_torch.ops.packing import make_img_ids as t_img_ids
from conceptattention_torch.ops.packing import pack_latents as t_pack
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.pipeline import concept_pipeline as t_pipe
from conceptattention_torch.sampling import rectified_flow as t_flow
from conceptattention_torch.utils import watermark as t_wm
from conceptattention_torch.weights.from_jax import ae_params_from_numpy, flux_params_from_numpy
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.models.flux import autoencoder as j_vae
from conceptattention_tpu.ops.packing import make_img_ids as j_img_ids
from conceptattention_tpu.ops.packing import pack_latents as j_pack
from conceptattention_tpu.pipeline import concept_pipeline as j_pipe
from conceptattention_tpu.sampling import rectified_flow as j_flow
from conceptattention_tpu.utils import watermark as j_wm

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)
PIXELS = dict(rtol=1e-3, atol=1e-3)
BATCH = dict(rtol=2e-4, atol=1e-6)
PROMPT, CONCEPTS = "a dragon on a rock", ["dragon", "rock", "sky"]
SIZE = 32


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


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("strength,steps", [(0.5, 4), (0.6, 3)])
def test_image_to_image_matches_jax(pipes, monkeypatch, strength, steps):
    """generate_image(init_image=...) end to end on injected noise and the
    posterior mean: the blend, the shortened schedule and the rebased
    default timesteps."""
    t, j = pipes
    noise = np.random.default_rng(1).standard_normal(
        (1, t.spec.ae_params.z_channels, SIZE // t.vae_factor, SIZE // t.vae_factor)
    ).astype(np.float32)
    monkeypatch.setattr(t_pipe, "get_noise", lambda *a, **k: torch.from_numpy(noise))
    monkeypatch.setattr(j_pipe, "get_noise", lambda *a, **k: jnp.asarray(noise))
    for pipe in (t, j):
        mean = type(pipe)._encode_pixels
        monkeypatch.setattr(pipe, "_encode_pixels",
                            lambda im, h, w, seed, p=pipe, f=mean: f(p, im, h, w, seed, sample=False))
    kw = dict(width=SIZE, height=SIZE, num_inference_steps=steps, init_image=_images(1, 2)[0],
              image2image_strength=strength, return_pil_heatmaps=False, return_image_array=True)
    got, want = t.generate_image(PROMPT, CONCEPTS, **kw), j.generate_image(PROMPT, CONCEPTS, **kw)
    close(got.concept_heatmaps, want.concept_heatmaps, msg="concept heatmaps")
    close(got.cross_attention_maps, want.cross_attention_maps, msg="cross attention")
    assert np.abs(got.image.astype(int) - want.image.astype(int)).max() <= 1
    scratch = t.generate_image(PROMPT, CONCEPTS, **{**kw, "init_image": None})
    assert not np.array_equal(scratch.image, got.image)


def test_true_cfg_denoise_matches_jax(pipes):
    t, j = pipes
    rng = np.random.default_rng(3)
    grid = (SIZE // (2 * t.vae_factor),) * 2
    img = rng.standard_normal((1, grid[0] * grid[1], t.cfg.in_channels)).astype(np.float32)
    schedule = get_schedule(2, grid[0] * grid[1], shift=False)
    t_txt, t_ids, t_vec = t._prepare_text(PROMPT)
    n_txt, _, n_vec = t._prepare_text("blurry")
    t_c = t._prepare_concepts(CONCEPTS)
    j_txt, j_ids, j_vec = j._prepare_text(PROMPT)
    jn_txt, _, jn_vec = j._prepare_text("blurry")
    j_c = j._prepare_concepts(CONCEPTS)
    kw = dict(guidance_scale=3.0, true_cfg=True)
    got, got_sal = t_flow.denoise(
        t.params, t.cfg, torch.from_numpy(img), t_img_ids(*grid, 1), t_txt, t_ids, t_vec,
        schedule, 0.0, *t_c, spec=t.attention_spec, neg_txt=n_txt, neg_vec=n_vec, **kw)
    want, want_sal = j_flow.denoise(
        j.params, j.cfg, jnp.asarray(img), j_img_ids(*grid, 1), j_txt, j_ids, j_vec,
        jnp.asarray(schedule), 0.0, *j_c, spec=j._attention_spec(), neg_txt=jn_txt,
        neg_vec=jn_vec, **kw)
    close(got, want, msg="latents")
    for tap in ("output", "cross_attention"):
        close(got_sal[tap], want_sal[tap], msg=tap)
    plain, _ = t_flow.denoise(t.params, t.cfg, torch.from_numpy(img), t_img_ids(*grid, 1), t_txt,
                              t_ids, t_vec, schedule, 0.0, *t_c, spec=t.attention_spec)
    assert not torch.allclose(plain, got, atol=1e-3)


def test_prepare_matches_jax(pipes):
    t, j = pipes
    x = np.random.default_rng(4).standard_normal((1, 4, 8, 6)).astype(np.float32)
    prompts = ["a dragon", "a rock"]
    got = t_flow.prepare(t.text_encoders, torch.from_numpy(x), prompts)
    want = j_flow.prepare(j.text_encoders, jnp.asarray(x), prompts)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        close(got[key], want[key], msg=key)
    tokens, ids = t_flow.prepare_image_tokens(torch.from_numpy(x))
    assert torch.equal(tokens, t_pack(torch.from_numpy(x))) and ids.shape == (1, 12, 3)


def test_get_noise_torch_parity_bit_identical():
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got = t_flow.get_noise_torch_parity(7, 2, 64, 48, dtype, channels=4, vae_factor=8)
        want = j_flow.get_noise_torch_parity(7, 2, 64, 48, jdtype, channels=4, vae_factor=8)
        assert got.dtype == dtype and tuple(got.shape) == want.shape == (2, 4, 8, 6)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_encode_images_matches_sequential_encode_image(pipes):
    """Per-image concepts, prompts and seeds, two noise samples each: every
    output is that image's own encode_image call."""
    t, _ = pipes
    images = _images(3, seed=7)
    concepts = [["dragon", "sky"], ["rock", "sky"], ["sky", "dragon"]]
    prompts, seeds = ["a dragon", "a rock", "the sky"], [0, 11, 42]
    kw = dict(width=SIZE, height=SIZE, num_samples=2, num_steps=2, noise_timestep=1,
              layer_indices=[0, 1], return_pil_heatmaps=False)
    outs = t.encode_images(images, concepts, prompts=prompts, seeds=seeds, **kw)
    assert len(outs) == 3
    for i, out in enumerate(outs):
        direct = t.encode_image(images[i], concepts[i], prompt=prompts[i], seed=seeds[i], **kw)
        close(out.concept_heatmaps, direct.concept_heatmaps, BATCH, f"image {i}")
        close(out.cross_attention_maps, direct.cross_attention_maps, BATCH, f"image {i}")
        assert out.image is images[i]
    # another image's seed is another draw
    swapped = t.encode_image(images[1], concepts[1], prompt=prompts[1], seed=seeds[0], **kw)
    assert not np.allclose(outs[1].concept_heatmaps, swapped.concept_heatmaps, **BATCH)
    shared = t.encode_images(images[:2], ["dragon", "sky"], width=SIZE, height=SIZE,
                             num_steps=2, noise_timestep=1, return_pil_heatmaps=False)
    direct = t.encode_image(images[1], ["dragon", "sky"], width=SIZE, height=SIZE, num_steps=2,
                            noise_timestep=1, return_pil_heatmaps=False)
    close(shared[1].concept_heatmaps, direct.concept_heatmaps, BATCH)
    with pytest.raises(ValueError, match="share a length"):
        t.encode_images(images[:2], [["dragon"], ["rock", "sky"]], width=SIZE, height=SIZE)


def test_encode_images_saliency_matches_jax(pipes):
    """The batched stopped forward on the same latents and injected noise:
    image-leading [B, N, L, C, P] maps equal the JAX package's."""
    t, j = pipes
    b, n = 2, 2
    rng = np.random.default_rng(9)
    zs = rng.standard_normal((b, 4, SIZE // t.vae_factor, SIZE // t.vae_factor)).astype(np.float32)
    eps = rng.standard_normal((n * b, *zs.shape[1:])).astype(np.float32)
    draws = iter(torch.from_numpy(eps[k : k + 1]) for k in range(n * b))
    tt = 0.6
    t_txt, _, _ = t._prepare_text("", b, need_clip=False)
    t_c, t_ids, t_v = t._prepare_concepts(CONCEPTS, b)
    got = None
    orig = t_pipe.get_noise
    try:
        t_pipe.get_noise = lambda *a, **k: next(draws)
        got = t_pipe.batched_images_saliency(
            t, torch.from_numpy(zs), tt, n, SIZE, SIZE, [0, 5], t_txt,
            torch.zeros(b, t_txt.shape[1], 3), t_v, t_c, t_ids, t_v, t.attention_spec)
    finally:
        t_pipe.get_noise = orig
    j_txt, _, _ = j._prepare_text("", b, need_clip=False)
    j_c, j_ids, j_v = j._prepare_concepts(CONCEPTS, b)
    noised = j_flow.forward_noise(jnp.concatenate([jnp.asarray(zs)] * n), jnp.asarray(eps), tt)
    lh = zs.shape[2] // 2
    tile = lambda a: jnp.concatenate([a] * n)  # noqa: E731
    forward = jax.jit(j_pipe._encode_forward, static_argnames=("cfg", "spec", "stop_after"))
    sal = forward(j.params, j.cfg, j_pack(noised), j_img_ids(lh, lh, n * b), tile(j_txt),
                  jnp.zeros((n * b, j_txt.shape[1], 3)), tile(j_v), tile(j_c), tile(j_ids),
                  tile(j_v), jnp.full((n * b,), tt, jnp.float32), j._attention_spec())
    for tap in ("output", "cross_attention"):
        want = np.asarray(sal[tap]).reshape(sal[tap].shape[0], n, b, *sal[tap].shape[2:])
        assert tuple(got[tap].shape) == (b, n, 2, len(CONCEPTS), lh * lh)
        close(got[tap], want.transpose(2, 1, 0, 3, 4), msg=tap)


@pytest.fixture(scope="module")
def tiny_vae():
    from conceptattention_tpu.config import AutoEncoderConfig as JCfg

    from conceptattention_torch.config import AutoEncoderConfig as TCfg

    kw = dict(resolution=32, ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
    j_params = j_vae.init_autoencoder_params(jax.random.PRNGKey(0), JCfg(**kw), jnp.float32)
    return TCfg(**kw), ae_params_from_numpy(jax.tree.map(np.asarray, j_params)), JCfg(**kw), j_params


def test_decode_nchw_matches_nhwc_and_jax(tiny_vae):
    t_cfg, t_params, j_cfg, j_params = tiny_vae
    z = np.random.default_rng(5).standard_normal((2, 4, 4, 6)).astype(np.float32)
    got = t_vae.decode(t_params, t_cfg, torch.from_numpy(z))
    close(got, t_vae.decode_nhwc(t_params, t_cfg, torch.from_numpy(z)), dict(rtol=0, atol=2e-5))
    close(got, j_vae.decode(j_params, j_cfg, jnp.asarray(z)), PIXELS)


def test_encode_nhwc_matches_nchw_and_jax(tiny_vae):
    t_cfg, t_params, j_cfg, j_params = tiny_vae
    x = np.random.default_rng(6).standard_normal((2, 3, 32, 24)).astype(np.float32)
    got = t_vae.encode_nhwc(t_params, t_cfg, torch.from_numpy(x))
    close(got, t_vae.encode(t_params, t_cfg, torch.from_numpy(x)), dict(rtol=0, atol=2e-5))
    close(got, j_vae.encode_nhwc(j_params, j_cfg, jnp.asarray(x)), TOL)
    # a draw from a generator: the same draw through either layout
    draws = [f(t_params, t_cfg, torch.from_numpy(x), torch.Generator().manual_seed(3))
             for f in (t_vae.encode, t_vae.encode_nhwc)]
    close(draws[1], draws[0], dict(rtol=0, atol=2e-5))
    assert not torch.allclose(draws[0], got, atol=1e-3)


def test_extract_watermark_round_trip():
    image = np.random.default_rng(8).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    marked = t_wm.embed_watermark(image)
    assert t_wm.extract_watermark(marked) == t_wm.WATERMARK_BITS
    assert t_wm.extract_watermark(marked) == j_wm.extract_watermark(marked)
    assert t_wm.extract_watermark(image) == j_wm.extract_watermark(image) != t_wm.WATERMARK_BITS
    flipped = [1 - b for b in t_wm.WATERMARK_BITS]
    assert t_wm.extract_watermark(t_wm.embed_watermark(image, bits=flipped)) == flipped
