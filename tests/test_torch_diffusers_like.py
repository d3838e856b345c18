"""The port's diffusers-style pipeline (`pipeline/diffusers_like.py`) and the
DiT's ControlNet residuals (`models/flux/dit.py`) against the JAX package's.

Mirrors `tests/test_diffusers_like.py::TestDiffusersLikePipeline` and
`tests/test_dit.py::TestControlNetResiduals`. Both packages hold the same
weights (the JAX init, carried across) in f32; JAX runs its plain attention
("xla"), the port its fused backend, whose plain version runs on CPU
tensors. The diffusion noise is one numpy draw injected into both (threefry
cannot be reproduced in torch). Tolerances: `TOL` of
`tests/test_torch_pipeline.py` (1e-4) for maps and DiT outputs, one grey
level for uint8 images; the zero-residual identity is the JAX test's 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.config import FluxConfig as TFluxConfig
from conceptattention_torch.models.flux import dit as t_dit
from conceptattention_torch.ops.packing import latent_noise_shape
from conceptattention_torch.ops.packing import make_img_ids as t_img_ids
from conceptattention_torch.pipeline import diffusers_like as t_dl
from conceptattention_torch.weights.from_jax import params_from_numpy
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.config import FluxConfig as JFluxConfig
from conceptattention_tpu.models.flux import dit as j_dit
from conceptattention_tpu.models.flux.params import init_flux_params
from conceptattention_tpu.ops.packing import make_img_ids as j_img_ids
from conceptattention_tpu.pipeline import diffusers_like as j_dl

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 64


@pytest.fixture(scope="module")
def pipes():
    j = JaxPipeline("flux-tiny", dtype=jnp.float32)
    t = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                      params=params_from_numpy(jax.tree.map(np.asarray, j.params)),
                      ae_params=params_from_numpy(jax.tree.map(np.asarray, j.ae_params)))
    return t_dl.FluxWithConceptAttentionPipeline(t), j_dl.FluxWithConceptAttentionPipeline(j)


@pytest.fixture
def same_noise(monkeypatch):
    """One numpy draw per seed in both packages' `get_noise`."""
    def noise(seed, n, h, w, *args, channels=16, vae_factor=8, **kwargs):
        shape = latent_noise_shape(n, h, w, channels, vae_factor)
        return np.random.default_rng(int(seed)).standard_normal(shape).astype(np.float32)

    monkeypatch.setattr(t_dl, "get_noise",
                        lambda gen, *a, **k: torch.from_numpy(noise(gen.initial_seed(), *a, **k)))
    monkeypatch.setattr(j_dl, "get_noise",
                        lambda key, *a, **k: jnp.asarray(noise(np.asarray(key)[-1], *a, **k)))


def call_both(pipes, **kw):
    t, j = pipes
    kw = dict(height=SIZE, width=SIZE, output_type="np") | kw
    return t(**kw), j(**kw)


def check_same(got, want):
    assert len(got.images) == len(want.images) == 1
    g, w = np.asarray(got.images[0]), np.asarray(want.images[0])
    assert g.shape == w.shape == (SIZE, SIZE, 3) and g.dtype == np.uint8
    assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    assert len(got.concept_attention_maps) == len(want.concept_attention_maps)
    for a, b in zip(got.concept_attention_maps, want.concept_attention_maps):
        assert a.shape == (SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


class TestDiffusersLikePipeline:
    def test_call_with_concept_kwargs(self, pipes):
        """Maps gated to timesteps [0, 1] and layers [0, 1] (PIL output)."""
        out = pipes[0](prompt="a cat in a garden", height=SIZE, width=SIZE, num_inference_steps=2,
                       concept_attention_kwargs={"concepts": ["cat", "garden"],
                                                 "timesteps": [0, 1], "layers": [0, 1]})
        assert len(out.images) == 1 and out.images[0].size == (SIZE, SIZE)
        assert len(out.concept_attention_maps) == 2
        assert out.concept_attention_maps[0].size == (SIZE // 4, SIZE // 4)

    @pytest.mark.parametrize("gate", [
        {},
        {"timesteps": [1]},
        {"timesteps": [0, 1], "layers": [1]},
        {"layers": [1, 0]},
    ], ids=["all", "last_step", "one_layer", "layers_reordered"])
    def test_maps_match_jax(self, pipes, same_noise, gate):
        got, want = call_both(pipes, prompt="a cat in a garden", num_inference_steps=2,
                              concept_attention_kwargs={"concepts": ["cat", "garden"]} | gate)
        check_same(got, want)

    def test_maps_are_softmax_over_patches(self, pipes, same_noise):
        """Each map is a mean of softmaxes over the patch axis: it sums to 1."""
        got, _ = call_both(pipes, prompt="a cat", num_inference_steps=1,
                           concept_attention_kwargs={"concepts": ["cat", "sky", "tree"]})
        for m in got.concept_attention_maps:
            assert abs(float(m.sum()) - 1.0) < 1e-5

    def test_true_cfg_branch(self, pipes, same_noise):
        """true_cfg > 1 runs the negative-prompt forward: the image moves
        away from the plain call's, and equals the JAX package's."""
        kw = dict(prompt="a cat", height=SIZE, width=SIZE, num_inference_steps=1,
                  concept_attention_kwargs={"concepts": ["cat"]})
        cfg_t, cfg_j = call_both(pipes, negative_prompt="blurry", guidance_scale=2.0,
                                 true_cfg=1.5, **kw)
        plain_t, _ = call_both(pipes, **kw)
        assert not np.array_equal(np.asarray(cfg_t.images[0]), np.asarray(plain_t.images[0]))
        check_same(cfg_t, cfg_j)

    @pytest.mark.parametrize("kwargs,msg", [
        ({"concepts": ["cat"], "timesteps": [2]}, "timesteps"),
        ({"concepts": ["cat"], "timesteps": [-1]}, "timesteps"),
        ({"concepts": ["cat"], "layers": [2]}, "layers"),
        ({"concepts": []}, "concepts"),
    ])
    def test_rejects_out_of_range(self, pipes, kwargs, msg):
        with pytest.raises(ValueError, match=msg):
            pipes[0](prompt="a cat", height=SIZE, width=SIZE, num_inference_steps=2,
                     concept_attention_kwargs=kwargs)


# ---------------------------------------------------------------------------
CN_CFG = dict(in_channels=4, vec_in_dim=8, context_in_dim=8, hidden_size=32, mlp_ratio=2.0,
              num_heads=2, depth=4, depth_single_blocks=2, axes_dim=(4, 6, 6), qkv_bias=True,
              guidance_embed=False)


@pytest.fixture(scope="module")
def dit():
    """The JAX test's small DiT (4 double, 2 single blocks) in both packages,
    and one set of inputs."""
    j_cfg, t_cfg = JFluxConfig(**CN_CFG), TFluxConfig(**CN_CFG)
    j_params = init_flux_params(jax.random.PRNGKey(0), j_cfg, jnp.float32)
    t_params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    b, p, t = 1, 16, 4
    rng = np.random.default_rng(1)
    img = rng.standard_normal((b, p, 4)).astype(np.float32)
    txt = rng.standard_normal((b, t, 8)).astype(np.float32)
    y = rng.standard_normal((b, 8)).astype(np.float32)
    t_kw = dict(img=torch.from_numpy(img), img_ids=t_img_ids(4, 4, b), txt=torch.from_numpy(txt),
                txt_ids=torch.zeros(b, t, 3), timesteps=torch.tensor([0.5]),
                y=torch.from_numpy(y))
    j_kw = dict(img=jnp.asarray(img), img_ids=j_img_ids(4, 4, b), txt=jnp.asarray(txt),
                txt_ids=jnp.zeros((b, t, 3)), timesteps=jnp.asarray([0.5]), y=jnp.asarray(y))
    return (t_cfg, t_params, t_kw), (j_cfg, j_params, j_kw), (b, p)


class TestControlNetResiduals:
    @pytest.mark.parametrize("n,depth", [(2, 4), (3, 4), (4, 4), (1, 3), (3, 19)])
    def test_per_layer_mapping(self, n, depth):
        """interval: sample i // ceil(depth / n); repeat (XLabs): i % n."""
        samples = np.arange(float(n))[:, None, None, None] * np.ones((n, 1, 1, 1))
        for repeat in (False, True):
            got = t_dit._controlnet_per_layer(torch.from_numpy(samples), depth, repeat)
            want = j_dit._controlnet_per_layer(jnp.asarray(samples), depth, repeat)
            assert [float(x[0, 0, 0]) for x in got] == list(np.asarray(want)[:, 0, 0, 0])
        interval = t_dit._controlnet_per_layer(torch.arange(2.0)[:, None, None, None], 4, False)
        repeat = t_dit._controlnet_per_layer(torch.arange(2.0)[:, None, None, None], 4, True)
        assert [float(x) for x in interval] == [0, 0, 1, 1]
        assert [float(x) for x in repeat] == [0, 1, 0, 1]
        assert t_dit._controlnet_per_layer(None, 4, False) is None

    def test_zero_residuals_are_identity(self, dit):
        (cfg, params, kw), _, (b, p) = dit
        base, _ = t_dit.flux_forward(params, cfg, **kw)
        zeros = torch.zeros(2, b, p, cfg.hidden_size)
        same, _ = t_dit.flux_forward(params, cfg, **kw, controlnet_block_samples=zeros,
                                     controlnet_single_block_samples=zeros)
        np.testing.assert_allclose(same.numpy(), base.numpy(), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("which", ["double", "double_repeat", "single", "both"])
    def test_residuals_match_jax(self, dit, which):
        """Random residuals in each layout: the port's output equals the
        JAX package's, and moves away from the residual-free output."""
        (t_cfg, t_params, t_kw), (j_cfg, j_params, j_kw), (b, p) = dit
        cn = (0.1 * np.random.default_rng(9).standard_normal((2, b, p, 32))).astype(np.float32)
        args = {}
        if which in ("double", "double_repeat", "both"):
            args["controlnet_block_samples"] = cn
            args["controlnet_blocks_repeat"] = which == "double_repeat"
        if which in ("single", "both"):
            args["controlnet_single_block_samples"] = cn[::-1].copy()
        t_args = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in args.items()}
        j_args = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in args.items()}
        got, _ = t_dit.flux_forward(t_params, t_cfg, **t_kw, **t_args)
        want, _ = j_dit.flux_forward(j_params, j_cfg, **j_kw, **j_args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        base, _ = t_dit.flux_forward(t_params, t_cfg, **t_kw)
        assert not np.allclose(got.numpy(), base.numpy())

    def test_repeat_and_interval_layouts_differ(self, dit):
        (cfg, params, kw), _, (b, p) = dit
        cn = 0.1 * torch.from_numpy(np.random.default_rng(9).standard_normal((2, b, p, 32))
                                     .astype(np.float32))
        interval, _ = t_dit.flux_forward(params, cfg, **kw, controlnet_block_samples=cn)
        repeat, _ = t_dit.flux_forward(params, cfg, **kw, controlnet_block_samples=cn,
                                       controlnet_blocks_repeat=True)
        assert not np.allclose(interval.numpy(), repeat.numpy())

    def test_residuals_with_concepts_and_early_stop(self, dit):
        """With the concept stream: the double-block residuals reach the
        saliency maps (the image stream they are added to feeds the next
        block), and the early stop after the double blocks returns no pred."""
        (cfg, params, kw), _, (b, p) = dit
        concepts = torch.from_numpy(np.random.default_rng(3).standard_normal((b, 2, 8))
                                    .astype(np.float32))
        ckw = dict(concepts=concepts, concept_ids=torch.zeros(b, 2, 3),
                   concept_vec=torch.zeros(b, 8))
        cn = torch.from_numpy(np.random.default_rng(4).standard_normal((2, b, p, 32))
                              .astype(np.float32))
        _, plain = t_dit.flux_forward(params, cfg, **kw, **ckw)
        pred, sal = t_dit.flux_forward(params, cfg, **kw, **ckw, controlnet_block_samples=cn,
                                       stop_after_multimodal_attentions=True)
        assert pred is None and sal["output"].shape == plain["output"].shape
        assert torch.equal(sal["output"][0], plain["output"][0])  # layer 0 sees none yet
        assert not torch.allclose(sal["output"][1], plain["output"][1])
