"""The port's segmentation models and concept basis against the JAX package's.

Both packages hold the same flux-tiny weights (the JAX init, carried across
by `weights/from_jax.py`) in f32, and JAX runs its plain attention ("xla"),
as its own tests do on the CPU. JAX draws noise from threefry, which torch
cannot reproduce, so every diffusion-noise draw is replaced in both packages
by numpy noise seeded with the draw's own seed (the torch generator's seed,
the JAX key's), and the VAE encodes to its posterior mean. The draws keep
their seeds: sample i of an image still draws seed + i, so batched and
per-image calls see the same noise.

Tolerance: `TOL` of `tests/test_torch_pipeline.py` (rtol = atol = 1e-4:
one stopped forward of the tiny DiT in f32, reduction order apart). A mask
pixel may differ only where the JAX coefficient lies within that tolerance
of its threshold; a multi-class argmax only where the two largest
coefficients do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.evals import segmentation as t_seg
from conceptattention_torch.models.flux.dit import flux_forward as t_forward
from conceptattention_torch.ops import attention as t_attn
from conceptattention_torch.ops.packing import latent_noise_shape
from conceptattention_torch.pipeline import concept_encoding as t_enc
from conceptattention_torch.pipeline import concept_pipeline as t_pipe
from conceptattention_torch.pipeline import heatmaps as t_heat
from conceptattention_torch.weights.from_jax import ae_params_from_numpy, flux_params_from_numpy
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.evals import segmentation as j_seg
from conceptattention_tpu.ops import attention as j_attn
from conceptattention_tpu.pipeline import concept_encoding as j_enc
from conceptattention_tpu.pipeline import concept_pipeline as j_pipe
from conceptattention_tpu.pipeline import heatmaps as j_heat

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 32
CONCEPTS = ["dragon", "rock", "sky"]
CAPTION = "a dragon"
MODEL_KW = dict(num_steps=2, noise_timestep=1, width=SIZE, height=SIZE, vae_sample=False)


def numpy_noise(seed, *args, **kwargs):
    """The stand-in for one `get_noise(seed_or_key, n, h, w, dtype, channels,
    vae_factor)` draw: f32 numpy noise of its shape from `seed`."""
    n, h, w = args[:3]
    shape = latent_noise_shape(n, h, w, kwargs.get("channels", 16), kwargs.get("vae_factor", 8))
    return np.random.default_rng(int(seed)).standard_normal(shape).astype(np.float32)


def inject_noise(monkeypatch):
    """Seed-keyed numpy noise in both packages' noise draws (the port's
    `get_noise` takes a generator, the JAX package's a key [0, seed])."""

    def t_noise(gen, *args, **kwargs):
        return torch.from_numpy(numpy_noise(gen.initial_seed(), *args, **kwargs)).to(gen.device)

    def j_noise(key, *args, **kwargs):
        return jnp.asarray(numpy_noise(np.asarray(key)[-1], *args, **kwargs))

    def j_noise_for_keys(keys, height, width, dtype, channels, vae_factor):
        return jnp.concatenate([j_noise(k, 1, height, width, channels=channels,
                                        vae_factor=vae_factor) for k in keys])

    monkeypatch.setattr(t_pipe, "get_noise", t_noise)
    monkeypatch.setattr(j_pipe, "get_noise", j_noise)
    monkeypatch.setattr(j_enc, "get_noise", j_noise)
    monkeypatch.setattr(j_pipe, "_noise_for_keys", j_noise_for_keys)


@pytest.fixture(scope="module")
def pipes():
    j = JaxPipeline("flux-tiny", dtype=jnp.float32)
    t = TorchPipeline(
        "flux-tiny", dtype=torch.float32, device="cpu",
        params=flux_params_from_numpy(jax.tree.map(np.asarray, j.params)),
        ae_params=ae_params_from_numpy(jax.tree.map(np.asarray, j.ae_params)),
    )
    return t, j


@pytest.fixture
def noise(monkeypatch):
    inject_noise(monkeypatch)


def images(n, seed=0, shape=(40, 48)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*shape, 3), dtype=np.uint8) for _ in range(n)]


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=msg, **tol)


def masks_agree(got, want, coeff, threshold, msg=""):
    """Masks equal except where the coefficient is within TOL of its
    threshold."""
    near = np.abs(coeff - threshold) <= TOL["atol"] + TOL["rtol"] * np.abs(threshold)
    assert np.array_equal(got[~near], want[~near]), msg


CASES = {
    "output": dict(tap="output"),
    "cross_attention": dict(tap="cross_attention"),
    "value": dict(tap="value"),
    "cross_only": dict(tap="output", concept_self_attention=False),
    "self_only": dict(tap="output", concept_cross_attention=False),
    "neither": dict(tap="output", concept_cross_attention=False, concept_self_attention=False),
    "softmax": dict(tap="output", softmax=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tap_coefficients_and_masks_match_jax(pipes, noise, case):
    t, j = pipes
    kw = dict(MODEL_KW, layer_indices=[1, 0], **CASES[case])
    tm, jm = t_seg.FluxTapSegmentationModel(t, **kw), j_seg.FluxTapSegmentationModel(j, **kw)
    (image,) = images(1, seed=1)
    t_masks, t_coeffs, _ = tm([image], None, CONCEPTS, [CAPTION])
    j_masks, j_coeffs, _ = jm([image], None, CONCEPTS, [CAPTION])
    assert t_coeffs[0].shape == (len(CONCEPTS), SIZE // 4, SIZE // 4)
    close(t_coeffs[0], j_coeffs[0], msg=case)
    masks_agree(t_masks[0], j_masks[0], j_coeffs[0], j_coeffs[0].mean(axis=(1, 2), keepdims=True))
    t_masks, t_coeffs, _ = tm([image], ["rock"], CONCEPTS, [CAPTION], apply_blur=True)
    j_masks, j_coeffs, _ = jm([image], ["rock"], CONCEPTS, [CAPTION], apply_blur=True)
    close(t_coeffs[0], j_coeffs[0], msg=f"{case} blurred target")
    masks_agree(t_masks[0], j_masks[0], j_coeffs[0], j_coeffs[0].mean())


def test_ablations_change_the_maps(pipes, noise):
    """Each cross / self ablation gives other coefficients (as the JAX
    harness test asserts for its package)."""
    t, _ = pipes
    (image,) = images(1, seed=1)
    maps = {
        case: t_seg.FluxTapSegmentationModel(t, **MODEL_KW, **CASES[case])
        .segment_individual_image(image, CONCEPTS, CAPTION)[0]
        for case in ("output", "cross_only", "self_only")
    }
    assert not np.allclose(maps["output"], maps["cross_only"])
    assert not np.allclose(maps["output"], maps["self_only"])
    assert not np.allclose(maps["cross_only"], maps["self_only"])


# The port's batched forward against its per-image calls, f32 on the CPU:
# only the GEMMs' reduction order differs. Measured max |d| 1.2e-6 to 4.3e-6
# on coefficients up to 10 in magnitude (the output tap), at most 2.1e-6 on
# softmax coefficients up to 1; the limit, 1e-5 + 1e-5 |want|, is 2.3 times
# the largest reading at magnitude 1 and ten times below TOL.
BATCH = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tap", ["output", "value"])
def test_segment_batch_matches_jax_and_per_image(pipes, noise, tap):
    t, j = pipes
    imgs = images(3, seed=2)
    concepts = [["dragon", "sky"], ["rock", "sky"], ["sky", "dragon"]]
    captions = ["a dragon", "a rock", "the sky"]
    targets = ["dragon", "sky", "dragon"]
    kw = dict(MODEL_KW, tap=tap, layer_indices=[0, 1], softmax=tap == "value")
    tm, jm = t_seg.FluxTapSegmentationModel(t, **kw), j_seg.FluxTapSegmentationModel(j, **kw)
    t_masks, t_coeffs, recon = tm.segment_batch(imgs, targets, concepts, captions)
    j_masks, j_coeffs, _ = jm.segment_batch(imgs, targets, concepts, captions)
    assert recon == [None] * 3
    for b in range(3):
        close(t_coeffs[b], j_coeffs[b], msg=f"image {b}")
        masks_agree(t_masks[b], j_masks[b], j_coeffs[b], j_coeffs[b].mean())
        masks, coeffs, _ = tm([imgs[b]], [targets[b]], concepts[b], [captions[b]])
        close(t_coeffs[b], coeffs[0], BATCH, f"batched against per-image, image {b}")
        masks_agree(t_masks[b], masks[0], coeffs[0], coeffs[0].mean())
    with pytest.raises(ValueError, match="share a length"):
        tm.segment_batch(imgs[:2], None, [["dragon"], ["rock", "sky"]], captions[:2])


def test_segment_batch_draws_each_images_own_vae_noise(pipes, noise):
    """With the VAE's reparameterised draw on, image b of a batch draws
    what its own call draws (the model's one seed for every image)."""
    t, _ = pipes
    imgs = images(2, seed=3)
    tm = t_seg.FluxTapSegmentationModel(t, **dict(MODEL_KW, vae_sample=True))
    _, batched, _ = tm.segment_batch(imgs, None, [CONCEPTS] * 2, [CAPTION] * 2)
    for b in range(2):
        _, single, _ = tm([imgs[b]], None, CONCEPTS, [CAPTION])
        close(batched[b], single[0], BATCH, f"image {b}")
    mean_only = t_seg.FluxTapSegmentationModel(t, **MODEL_KW)
    _, posterior_mean, _ = mean_only([imgs[0]], None, CONCEPTS, [CAPTION])
    assert not np.allclose(batched[0], posterior_mean[0], **TOL)


def test_per_layer_coefficients(pipes, noise):
    t, j = pipes
    kw = dict(MODEL_KW, tap="cross_attention", layer_indices=[1])
    tm, jm = t_seg.FluxTapSegmentationModel(t, **kw), j_seg.FluxTapSegmentationModel(j, **kw)
    (image,) = images(1, seed=4)
    got = tm.per_layer_coefficients(image, CONCEPTS, CAPTION)
    assert got.shape == (t.cfg.depth, len(CONCEPTS), SIZE // 4, SIZE // 4)
    close(got, jm.per_layer_coefficients(image, CONCEPTS, CAPTION))
    close(got[1], tm.segment_individual_image(image, CONCEPTS, CAPTION)[0], BATCH)


def test_daam_flux_matches_jax(pipes, noise):
    t, j = pipes
    caption = "Two dragons, a rock and the blue sky above"
    concepts = ["dragon", "sky", "category"]  # "category" matches no word: the mean map
    tm = t_seg.DAAMFluxSegmentationModel(t, **MODEL_KW)
    jm = j_seg.DAAMFluxSegmentationModel(j, **MODEL_KW)
    (image,) = images(1, seed=5)
    got, _ = tm.segment_individual_image(image, concepts, caption)
    want, _ = jm.segment_individual_image(image, concepts, caption)
    assert got.shape == (3, SIZE // 4, SIZE // 4)
    close(got, want)
    words = caption.replace(",", " ").split()
    assert t_seg.match_concept_word_indices("dragon", words) == [1]
    for concept in ("dragon", "blue sky", "cat", "a rock"):
        assert (t_seg.match_concept_word_indices(concept, words)
                == j_seg.match_concept_word_indices(concept, words))


def test_multi_class_argmax_matches_jax(pipes, noise):
    t, j = pipes
    concepts = ["background", "sky", "dragon", "rock"]
    tm = t_seg.FluxMultiClassSegmentationModel(t, **MODEL_KW)
    jm = j_seg.FluxMultiClassSegmentationModel(j, **MODEL_KW)
    (image,) = images(1, seed=6)
    t_arg, t_coeff = tm.segment_multi_class(image, concepts, "a dragon,a rock")
    j_arg, j_coeff = jm.segment_multi_class(image, concepts, "a dragon,a rock")
    close(t_coeff, j_coeff)
    top2 = np.sort(j_coeff, axis=0)[-2:]
    near = top2[1] - top2[0] <= 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[1]))
    assert np.array_equal(t_arg[~near], np.asarray(j_arg)[~near])


@pytest.mark.parametrize("bad", [[2], [-1]])
def test_out_of_range_layers_raise_in_both(pipes, noise, bad):
    t, j = pipes
    for pkg, pipe in ((t_seg, t), (j_seg, j)):
        with pytest.raises(ValueError, match="out of range"):
            pkg.FluxTapSegmentationModel(pipe, layer_indices=bad)
    (image,) = images(1)
    kw = dict(width=SIZE, height=SIZE, num_steps=2, noise_timestep=1, layers=bad)
    with pytest.raises(ValueError, match="out of range"):
        t_enc.generate_concept_basis_and_image_representation(t, image, CAPTION, CONCEPTS, **kw)
    with pytest.raises(ValueError, match="out of range"):
        j_enc.generate_concept_basis_and_image_representation(j, image, CAPTION, CONCEPTS, **kw)


def posterior_mean_encodes(monkeypatch, pipes):
    """`generate_concept_basis_and_image_representation` encodes with the
    VAE's draw in both packages: both take the posterior mean here."""
    for pipe in pipes:
        encode = pipe._encode_pixels
        monkeypatch.setattr(pipe, "_encode_pixels",
                            lambda im, h, w, seed, sample=True, f=encode: f(im, h, w, seed,
                                                                           sample=False))


@pytest.mark.parametrize("reduce_dims", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("space", ["output", "cross_attention"])
def test_concept_basis_matches_jax(pipes, noise, monkeypatch, space, normalize, reduce_dims):
    t, j = pipes
    posterior_mean_encodes(monkeypatch, pipes)
    (image,) = images(1, seed=7)
    kw = dict(noise_timestep=1, num_steps=2, target_space=space, height=SIZE, width=SIZE,
              num_samples=2, normalize_concepts=normalize, reduce_dims=reduce_dims,
              layers=None if reduce_dims else [1, 0])
    got = t_enc.generate_concept_basis_and_image_representation(t, image, CAPTION, CONCEPTS, **kw)
    want = j_enc.generate_concept_basis_and_image_representation(j, image, CAPTION, CONCEPTS, **kw)
    hidden, p = t.cfg.hidden_size, (SIZE // 4) ** 2
    shapes = (((p, 2 * 2 * hidden), (3, 2 * 2 * hidden)) if reduce_dims
              else ((2, 2, p, hidden), (2, 2, 3, hidden)))
    for g, w, shape, name in zip(got, want, shapes, ("image", "concept")):
        assert g.shape == shape and g.dtype == np.float32, name
        close(g, w, msg=name)
    with pytest.raises(ValueError, match="target_space"):
        t_enc.generate_concept_basis_and_image_representation(
            t, image, CAPTION, CONCEPTS, **dict(kw, target_space="value"))


def test_raw_vectors_reproduce_the_output_map(pipes):
    """The stopped forward in raw-vector mode: the four vector sets stacked
    over depth, the output-space ones reproducing the `output` tap's map
    layer by layer, and the cross-attention ones the `cross_attention` map."""
    t, _ = pipes
    gen = torch.Generator().manual_seed(0)
    b, p, c, tlen = 2, 16, 3, 5
    cfg = t.cfg
    args = dict(
        img=torch.randn(b, p, cfg.in_channels, generator=gen),
        img_ids=t_pipe.make_img_ids(4, 4, b), txt=torch.randn(b, tlen, cfg.context_in_dim,
                                                               generator=gen),
        txt_ids=torch.zeros(b, tlen, 3), timesteps=torch.full((b,), 0.5),
        y=torch.randn(b, cfg.vec_in_dim, generator=gen),
        concepts=torch.randn(b, c, cfg.context_in_dim, generator=gen),
        concept_ids=torch.zeros(b, c, 3), concept_vec=torch.zeros(b, cfg.vec_in_dim),
        stop_after_multimodal_attentions=True,
    )
    _, raw = t_forward(t.params, cfg, spec=t_attn.ConceptAttentionSpec(return_raw_vectors=True),
                       **args)
    _, maps = t_forward(t.params, cfg, **args)
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    assert raw["output_space_image_vectors"].shape == (cfg.depth, b, p, h * d)
    assert raw["output_space_concept_vectors"].shape == (cfg.depth, b, c, h * d)
    assert raw["cross_attention_image_vectors"].shape == (cfg.depth, b, h, p, d)
    assert raw["cross_attention_concept_vectors"].shape == (cfg.depth, b, h, c, d)
    for layer in range(cfg.depth):
        got = t_attn.similarity_map(raw["output_space_concept_vectors"][layer],
                                    raw["output_space_image_vectors"][layer])
        close(got, maps["output"][layer], dict(rtol=1e-5, atol=1e-5), f"layer {layer}")
        got = t_attn.similarity_map_heads(raw["cross_attention_concept_vectors"][layer],
                                          raw["cross_attention_image_vectors"][layer])
        close(got, maps["cross_attention"][layer], dict(rtol=1e-5, atol=1e-5), f"layer {layer}")


def test_similarity_and_normalize_match_jax():
    rng = np.random.default_rng(8)
    con, img = rng.standard_normal((2, 3, 16)), rng.standard_normal((2, 10, 16))
    close(t_attn.similarity_map(torch.from_numpy(con), torch.from_numpy(img)),
          j_attn.similarity_map(jnp.asarray(con), jnp.asarray(img)))
    x = rng.standard_normal((4, 5, 6)).astype(np.float32)
    x[1] = 2.0  # a constant slice: its sum after the shift is 0
    for dim in (-2, 0):
        close(t_heat.normalize_concepts_linear(torch.from_numpy(x), dim=dim),
              j_heat.normalize_concepts_linear(jnp.asarray(x), axis=dim),
              dict(rtol=1e-6, atol=1e-7))


@pytest.mark.parametrize("heads", [False, True], ids=["merged", "head_form"])
@pytest.mark.parametrize("normalize", [False, True])
def test_compute_heatmaps_from_vectors_matches_jax(heads, normalize):
    rng = np.random.default_rng(9)
    lead = (2, 3, 1)  # timesteps, layers, batch
    img_shape, con_shape = ((2, 16, 4), (2, 3, 4)) if heads else ((16, 8), (3, 8))
    iv = rng.standard_normal((*lead, *img_shape)).astype(np.float32)
    cv = rng.standard_normal((*lead, *con_shape)).astype(np.float32)
    kw = dict(layer_indices=[2, 0], timesteps=[1], softmax=False, normalize_concepts=normalize,
              attention_norm="sparsemax")
    got = t_heat.compute_heatmaps_from_vectors(torch.from_numpy(iv), torch.from_numpy(cv), **kw)
    want = j_heat.compute_heatmaps_from_vectors(jnp.asarray(iv), jnp.asarray(cv), **kw)
    assert tuple(got.shape) == (1, 3, 4, 4)
    close(got, want, dict(rtol=1e-5, atol=1e-6))
