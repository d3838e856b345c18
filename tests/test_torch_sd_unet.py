"""The port's SD2 / SDXL UNet and the DAAM-SD baselines against the JAX
package's, on the CPU.

Both packages hold the same weights (the JAX init carried across by
`weights/from_jax.py`, or one diffusers-keyed state dict read by each
package's converter) at the tiny layouts of `tests/test_sd_unet.py`: SD2's
(attention at level 0 only) and SDXL's (none at level 0, two blocks a
transformer at level 1, the text_time embedding). The DAAM models get the
same numpy noise in both packages: the port's `_noise` and the JAX module's
`jax.random.normal` are replaced for the test.

Tolerances: the UNet's output and every cross-attention map atol 1e-5
(measured up to 2.6e-6 against outputs of about 2); DAAM coefficient maps
atol 1e-6 (probabilities averaged over maps; measured up to 1.9e-7); the
converter bit for bit; the small helpers 1e-6 (the timestep embedding
1e-5: sin / cos of f32 arguments up to 999).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sd_unet import _TorchSD2UNetOracle

from conceptattention_torch.config import AutoEncoderConfig as TAEConfig
from conceptattention_torch.evals import segmentation as t_seg
from conceptattention_torch.models import sd_unet as t_unet
from conceptattention_torch.models.flux.params import tree_leaves
from conceptattention_torch.models.text.encoders import StubTextEncoders as TStub
from conceptattention_torch.weights import convert as t_convert
from conceptattention_torch.weights.from_jax import ae_params_from_numpy, unet_params_from_numpy
from conceptattention_tpu.config import AutoEncoderConfig as JAEConfig
from conceptattention_tpu.evals import segmentation as j_seg
from conceptattention_tpu.models import sd_unet as j_unet
from conceptattention_tpu.models.flux.autoencoder import init_autoencoder_params
from conceptattention_tpu.models.text.encoders import StubTextEncoders as JStub
from conceptattention_tpu.weights import convert as j_convert

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = 1e-5
DAAM_TOL = 1e-6
J_CFGS = {
    "sd2": j_unet.UNetConfig(block_out_channels=(32, 64), layers_per_block=2,
                             attention_heads=(2, 2), cross_attention_levels=(True, False),
                             context_dim=16, num_groups=4),
    "sdxl": j_unet.UNetConfig(block_out_channels=(32, 64), layers_per_block=2,
                              attention_heads=(2, 2), cross_attention_levels=(False, True),
                              context_dim=16, num_groups=4, transformer_layers_per_block=(1, 2),
                              addition_embed_type="text_time", addition_time_embed_dim=8,
                              projection_class_embeddings_input_dim=16 + 6 * 8),
}
T_CFGS = {k: t_unet.UNetConfig(**dataclasses.asdict(c)) for k, c in J_CFGS.items()}
N_MAPS = {"sd2": 6, "sdxl": 2 * 2 + 2 + 3 * 2}  # one map per transformer block
LAYOUTS = ["sd2", "sdxl"]
CAPTION = "a cat under the sky"


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    """{layout: (JAX params, the port's params)}, the JAX init carried across."""
    out = {}
    for i, name in enumerate(LAYOUTS):
        j = j_unet.init_unet_params(jax.random.PRNGKey(i), J_CFGS[name])
        out[name] = (j, unet_params_from_numpy(to_numpy(j)))
    return out


def inputs(name, seed=0, t=421.0):
    """Seeded numpy inputs: (latents, timesteps, context, added conditions)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((1, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 16)).astype(np.float32)
    added = {}
    if name == "sdxl":
        added = {"text_embeds": rng.standard_normal((1, 16)).astype(np.float32),
                 "time_ids": np.array([[512.0, 512, 0, 0, 512, 512]], np.float32)}
    return z, np.array([t], np.float32), ctx, added


def run_both(shared, name, seed=0, **over):
    z, t, ctx, added = inputs(name, seed)
    added.update(over)
    j, p = shared[name]
    jo, jm = j_unet.unet_forward(j, J_CFGS[name], jnp.asarray(z), jnp.asarray(t), jnp.asarray(ctx),
                                 **{k: jnp.asarray(v) for k, v in added.items()})
    to, tm = t_unet.unet_forward(p, T_CFGS[name], torch.from_numpy(z), torch.from_numpy(t),
                                 torch.from_numpy(ctx),
                                 **{k: torch.from_numpy(v) for k, v in added.items()})
    return (np.asarray(jo), [np.asarray(m) for m in jm]), (to.numpy(), [m.numpy() for m in tm])


@pytest.mark.parametrize("name", LAYOUTS)
def test_forward_and_maps_match_jax(shared, name):
    (jo, jm), (to, tm) = run_both(shared, name)
    assert to.shape == jo.shape == (1, 4, 16, 16)
    np.testing.assert_allclose(to, jo, rtol=0, atol=TOL)
    assert len(tm) == len(jm) == N_MAPS[name]
    for a, b in zip(tm, jm):
        assert a.shape == b.shape and a.shape[-1] == 5
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", LAYOUTS)
def test_maps_sum_to_one(shared, name):
    _, (_, maps) = run_both(shared, name, seed=1)
    for m in maps:
        np.testing.assert_allclose(m.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", LAYOUTS)
def test_convert_matches_jax_bit_for_bit(name):
    """One diffusers-keyed state dict (the torch oracle of
    `tests/test_sd_unet.py`) through both converters."""
    torch.manual_seed(3)
    sd = {k: v.detach() for k, v in _TorchSD2UNetOracle(J_CFGS[name]).state_dict().items()}
    want = j_convert.convert_sd_unet_state_dict({k: v.numpy() for k, v in sd.items()},
                                                J_CFGS[name])
    got = t_convert.convert_sd_unet_state_dict(sd, T_CFGS[name])
    want_leaves, want_def = jax.tree.flatten(want)
    got_leaves, got_def = jax.tree.flatten(got)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", LAYOUTS)
def test_init_matches_converted_structure(shared, name):
    mine = t_unet.init_unet_params(torch.Generator().manual_seed(0), T_CFGS[name])
    a, a_def = jax.tree.flatten(mine)
    b, b_def = jax.tree.flatten(shared[name][1])
    assert a_def == b_def
    assert [x.shape for x in a] == [x.shape for x in b]


@pytest.mark.parametrize("cfg, count", [(t_unet.SDXL_BASE_CONFIG, 2_567_463_684),
                                        (t_unet.UNetConfig(), 865_910_724)], ids=["sdxl", "sd2"])
def test_full_config_param_count_on_meta(cfg, count):
    """The published diffusers UNets' parameter counts, without drawing."""
    params = t_unet.init_unet_params(torch.Generator(), cfg, device="meta")
    leaves = tree_leaves(params)
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) == count


def test_missing_added_conds_raise(shared):
    z = torch.zeros((1, 4, 16, 16))
    ctx = torch.zeros((1, 3, 16))
    with pytest.raises(ValueError, match="text_time"):
        t_unet.unet_forward(shared["sdxl"][1], T_CFGS["sdxl"], z, torch.tensor([1.0]), ctx)


def test_time_ids_change_output(shared):
    _, (a, _) = run_both(shared, "sdxl")
    _, (b, _) = run_both(shared, "sdxl",
                         time_ids=np.array([[1024.0, 1024, 0, 0, 1024, 1024]], np.float32))
    assert np.abs(a - b).max() > 1e-3


def test_context_changes_output(shared):
    _, (a, _) = run_both(shared, "sd2", seed=0)
    z, t, ctx, _ = inputs("sd2", 0)
    ctx2 = np.random.default_rng(9).standard_normal(ctx.shape).astype(np.float32)
    b, _ = t_unet.unet_forward(shared["sd2"][1], T_CFGS["sd2"], torch.from_numpy(z),
                               torch.from_numpy(t), torch.from_numpy(ctx2))
    assert np.abs(a - b.numpy()).max() > 1e-3


def test_helpers_match_jax():
    """GroupNorm over gcd(groups, C) groups (6 channels, 4 groups: 2), the
    LayerNorm, the timestep embedding and the tanh-GELU feed-forward."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 5, 5)).astype(np.float32)
    p = {"scale": rng.standard_normal(6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(t_unet._gn(torch.from_numpy(x), tp, 4).numpy(),
                               np.asarray(j_unet._gn(jnp.asarray(x), p, 4)), atol=1e-6)
    seq = rng.standard_normal((2, 7, 6)).astype(np.float32)
    np.testing.assert_allclose(t_unet._ln(torch.from_numpy(seq), tp).numpy(),
                               np.asarray(j_unet._ln(jnp.asarray(seq), p)), atol=1e-6)
    t = np.array([0.0, 11.0, 421.0, 999.0], np.float32)
    # sin / cos of f32 arguments up to 999: the two libraries' f32 sin
    # differ by up to 1.7e-6 there
    np.testing.assert_allclose(t_unet._timesteps_embedding(torch.from_numpy(t), 32).numpy(),
                               np.asarray(j_unet._timesteps_embedding(jnp.asarray(t), 32)),
                               atol=1e-5)
    ff = {"ff_in": {"w": rng.standard_normal((6, 48)).astype(np.float32),
                    "b": rng.standard_normal(48).astype(np.float32)},
          "ff_out": {"w": rng.standard_normal((24, 6)).astype(np.float32),
                     "b": rng.standard_normal(6).astype(np.float32)}}
    tff = jax.tree.map(torch.from_numpy, ff)
    got = t_unet._geglu_ff(tff, torch.from_numpy(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_unet._geglu_ff(ff, jnp.asarray(seq))),
                               atol=1e-5)
    # the tanh GELU, not diffusers' erf form
    val, gate = (torch.from_numpy(seq) @ tff["ff_in"]["w"] + tff["ff_in"]["b"]).chunk(2, -1)
    erf = (val * torch.nn.functional.gelu(gate)) @ tff["ff_out"]["w"] + tff["ff_out"]["b"]
    assert (got - erf).abs().max() > 1e-4


# ----------------------------------------------------------- DAAM-SD ----
J_AE = JAEConfig(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, scale_factor=0.18215,
                 shift_factor=0.0)
T_AE = TAEConfig(**dataclasses.asdict(J_AE))


@pytest.fixture(scope="module")
def vae():
    j = init_autoencoder_params(jax.random.PRNGKey(1), J_AE)
    return j, ae_params_from_numpy(to_numpy(j))


def shared_noise(monkeypatch, seed=0):
    """One numpy draw in place of each package's forward-noising draw."""
    def draw(shape):
        return np.random.default_rng(100 + seed).standard_normal(tuple(shape)).astype(np.float32)

    monkeypatch.setattr(t_seg.DAAMStableDiffusionSegmentationModel, "_noise",
                        lambda self, z: torch.from_numpy(draw(z.shape)))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(draw(shape)))


def daam_pair(shared, vae, name, with_vae):
    j_cls = (j_seg.DAAMStableDiffusionXLSegmentationModel if name == "sdxl"
             else j_seg.DAAMStableDiffusionSegmentationModel)
    t_cls = (t_seg.DAAMStableDiffusionXLSegmentationModel if name == "sdxl"
             else t_seg.DAAMStableDiffusionSegmentationModel)
    clip_dim = J_CFGS[name].pooled_text_dim if name == "sdxl" else 768
    j_kw = dict(vae_params=vae[0], ae_cfg=J_AE) if with_vae else {}
    t_kw = dict(vae_params=vae[1], ae_cfg=T_AE) if with_vae else {}
    j = j_cls(shared[name][0], J_CFGS[name], JStub(t5_dim=16, clip_dim=clip_dim),
              latent_size=16, **j_kw)
    t = t_cls(shared[name][1], T_CFGS[name], TStub(t5_dim=16, clip_dim=clip_dim),
              latent_size=16, **t_kw)
    return j, t


@pytest.mark.parametrize("with_vae", [False, True], ids=["pseudo_latents", "vae"])
@pytest.mark.parametrize("name", LAYOUTS)
def test_daam_coefficients_match_jax(shared, vae, name, with_vae, monkeypatch):
    shared_noise(monkeypatch)
    j, t = daam_pair(shared, vae, name, with_vae)
    image = np.random.default_rng(0).integers(0, 255, size=(64, 64, 3), dtype=np.uint8)
    concepts = ["cat", "sky", "dog"]  # "dog" matches no word: the mean over words
    want, _ = j.segment_individual_image(image, concepts, CAPTION)
    got, recon = t.segment_individual_image(image, concepts, CAPTION)
    side = 16 if name == "sd2" else 8  # the finest map: SDXL has no attention at level 0
    assert recon is None and got.shape == np.asarray(want).shape == (3, side, side)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=DAAM_TOL)
    assert np.abs(got[0] - got[1]).max() > 1e-4  # the words' maps differ


@pytest.mark.parametrize("name", LAYOUTS)
def test_daam_masks_match_jax(shared, vae, name, monkeypatch):
    """The shared tail: masks and target coefficients of one call."""
    shared_noise(monkeypatch, seed=1)
    j, t = daam_pair(shared, vae, name, False)
    image = np.random.default_rng(2).integers(0, 255, size=(48, 48, 3), dtype=np.uint8)
    kw = dict(target_concepts=["cat"], concepts=["cat", "sky"], captions=[CAPTION])
    jm, jc, _ = j([image], **kw)
    tm, tc, _ = t([image], **kw)
    assert tm[0].dtype == bool
    np.testing.assert_allclose(tc[0], np.asarray(jc[0]), rtol=0, atol=DAAM_TOL)
    close = np.abs(tc[0] - tc[0].mean()) < 1e-5
    np.testing.assert_array_equal(tm[0][~close], np.asarray(jm[0])[~close])


def test_daam_noise_is_seeded_and_timestep_checked(shared):
    model = t_seg.DAAMStableDiffusionSegmentationModel(shared["sd2"][1], T_CFGS["sd2"],
                                                       TStub(t5_dim=16), latent_size=16, seed=3)
    z = torch.zeros((1, 4, 16, 16))
    torch.testing.assert_close(model._noise(z), model._noise(z), rtol=0, atol=0)
    image = np.zeros((32, 32, 3), np.uint8)
    model.timestep_idx = 50
    with pytest.raises(ValueError, match="timestep_idx"):
        model.segment_individual_image(image, ["cat"], "a cat")
