"""The port's CogVideoX path against the JAX package's, on the CPU.

Both packages hold the same weights (the JAX init of `tests/test_video.py`'s
TINY config, carried across by `weights/from_jax.py`) and f32 activations.
The JAX package draws its latents from threefry, which torch cannot
reproduce, so the latents are made with numpy and injected: into the CFG
denoise loop, and into `generate_video` through each package's normal draw.
Tolerances: 1e-5 for the schedulers' tables and steps (f32 arithmetic on the
same f64-built tables); 1e-4 for blocks, the forward, the denoise loop and
the maps (a few layers of the tiny DiT in f32, reduction order apart), and
for the VAE (f32 convolutions through a dozen layers).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import VideoConceptAttentionPipeline as TorchPipeline
from conceptattention_torch.kernels import flash_saliency as t_fs
from conceptattention_torch.models.flux.params import tree_leaves
from conceptattention_torch.models.video import dit as t_dit
from conceptattention_torch.models.video import vae as t_vae
from conceptattention_torch.ops.attention import ConceptAttentionSpec as TSpec
from conceptattention_torch.ops.rope import embed_nd as t_embed_nd
from conceptattention_torch.pipeline import video_pipeline as t_vp
from conceptattention_torch.sampling import ddim as t_ddim
from conceptattention_torch.sampling import dpm as t_dpm
from conceptattention_torch.weights.from_jax import params_from_numpy
from conceptattention_tpu.models.video import dit as j_dit
from conceptattention_tpu.models.video import vae as j_vae
from conceptattention_tpu.ops.attention import ConceptAttentionSpec as JSpec
from conceptattention_tpu.ops.rope import embed_nd as j_embed_nd
from conceptattention_tpu.pipeline import video_pipeline as j_vp
from conceptattention_tpu.sampling import ddim as j_ddim
from conceptattention_tpu.sampling import dpm as j_dpm

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)
SCHED = dict(rtol=1e-5, atol=1e-5)
TINY = dict(
    num_attention_heads=2, attention_head_dim=16, in_channels=4, out_channels=4,
    time_embed_dim=8, text_embed_dim=16, num_layers=2, sample_width=8, sample_height=8,
    sample_frames=9, patch_size=2, max_text_seq_length=6,
)
B, F_LAT, H_LAT, W_LAT = 2, 3, 8, 8
T_LEN, C_PAD = 6, 6
VAE_TINY = dict(block_out_channels=(8, 16, 16), latent_channels=4, layers_per_block=1,
                norm_num_groups=4)
PROMPT, CONCEPTS = "a dog running on grass", ["dog", "grass"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(got, want, tol=TOL, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **tol)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def configs(rotary, **over):
    kw = dict(TINY, use_rotary_positional_embeddings=rotary, **over)
    return t_dit.CogVideoXConfig(**kw), j_dit.CogVideoXConfig(**kw)


@pytest.fixture(scope="module", params=[True, False], ids=["rotary-5b", "sincos-2b"])
def model(request):
    t_cfg, j_cfg = configs(request.param)
    j_params = j_dit.init_video_dit_params(jax.random.PRNGKey(0), j_cfg, jnp.float32)
    t_params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    return t_cfg, j_cfg, t_params, j_params


@pytest.fixture(scope="module")
def inputs():
    return dict(video=rand(1, B, F_LAT, 4, H_LAT, W_LAT), text=rand(2, B, T_LEN, 16),
                concepts=rand(3, B, C_PAD, 16), timestep=np.array([999.0, 500.0], np.float32))


def both(x):
    return torch.from_numpy(np.array(x)), jnp.asarray(x)


@pytest.mark.parametrize("backend", ["fused", "sdpa"])
def test_video_block(model, inputs, backend):
    """One block on hidden states: video, text and concepts out, and both
    saliency taps, against the JAX block on its `xla` path."""
    t_cfg, j_cfg, t_params, j_params = model
    d = t_cfg.hidden_size
    p_tok = F_LAT * (H_LAT // 2) * (W_LAT // 2)
    video, text, con = (both(rand(10 + i, B, n, d)) for i, n in enumerate((p_tok, T_LEN, C_PAD)))
    temb = both(rand(13, B, t_cfg.time_embed_dim))
    ids = np.asarray(j_dit.make_video_ids(F_LAT, H_LAT // 2, W_LAT // 2, B))
    ids = ids if t_cfg.use_rotary_positional_embeddings else 0 * ids
    pes = []
    for front in (np.zeros((B, T_LEN, 3), np.float32), np.zeros((B, C_PAD, 3), np.float32)):
        all_ids = np.concatenate([front, ids], 1)
        pes.append((t_embed_nd(torch.from_numpy(all_ids), t_cfg.rope_axes_dim, 10_000),
                    j_embed_nd(jnp.asarray(all_ids), j_cfg.rope_axes_dim, 10_000)))
    got = t_dit._video_block(
        t_dit.layer(t_params["blocks"], 1), t_cfg, video[0], text[0], con[0], temb[0],
        pes[0][0], pes[1][0], TSpec(backend=backend))
    want = j_dit._video_block(
        jax.tree.map(lambda x: x[1], j_params["blocks"]), j_cfg, video[1], text[1], con[1],
        temb[1], pes[0][1], pes[1][1], JSpec(backend="xla"))
    for g, w, name in zip(got[:3], want[:3], ("video", "text", "concepts")):
        close(g, w, msg=name)
    assert set(got[3]) == {"output", "cross_attention"}
    for tap in got[3]:
        close(got[3][tap], want[3][tap], msg=tap)


@pytest.mark.parametrize("backend", ["fused", "sdpa"])
def test_video_dit_forward(model, inputs, backend):
    t_cfg, j_cfg, t_params, j_params = model
    args = [inputs[k] for k in ("video", "text", "timestep")]
    got_pred, got_sal = t_dit.video_dit_forward(
        t_params, t_cfg, *(both(a)[0] for a in args), concepts=both(inputs["concepts"])[0],
        spec=TSpec(backend=backend))
    want_pred, want_sal = j_dit.video_dit_forward(
        j_params, j_cfg, *(jnp.asarray(a) for a in args), concepts=jnp.asarray(inputs["concepts"]),
        spec=JSpec(backend="xla"))
    assert got_pred.shape == (B, F_LAT, 4, H_LAT, W_LAT)
    close(got_pred, want_pred, msg="pred")
    for tap in ("output", "cross_attention"):
        assert got_sal[tap].shape == (TINY["num_layers"], B, C_PAD, F_LAT * 16)
        close(got_sal[tap], want_sal[tap], msg=tap)


def test_concepts_leave_video_unchanged(model, inputs):
    t_cfg, _, t_params, _ = model
    args = [both(inputs[k])[0] for k in ("video", "text", "timestep")]
    with_c, _ = t_dit.video_dit_forward(t_params, t_cfg, *args,
                                        concepts=both(inputs["concepts"])[0])
    without, sal = t_dit.video_dit_forward(t_params, t_cfg, *args)
    np.testing.assert_allclose(with_c.numpy(), without.numpy(), rtol=1e-5, atol=1e-6)
    assert sal == {}


def test_forward_with_paired_heads(monkeypatch):
    """Head dim 64 with PAIR_HEADS set: every layer's attention goes through
    K3's wrapper (its plain version on CPU tensors) and the forward still
    matches JAX."""
    t_cfg, j_cfg = configs(True, attention_head_dim=64, num_layers=2)
    j_params = j_dit.init_video_dit_params(jax.random.PRNGKey(1), j_cfg, jnp.float32)
    t_params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    calls = []
    paired = t_fs.fused_concept_flash_attention_paired
    monkeypatch.setattr(t_fs, "fused_concept_flash_attention_paired",
                        lambda *a, **k: calls.append(1) or paired(*a, **k))
    monkeypatch.setattr(t_fs, "PAIR_HEADS", True)
    video, text, con = rand(20, 1, 2, 4, 4, 4), rand(21, 1, T_LEN, 16), rand(22, 1, C_PAD, 16)
    ts = np.array([700.0], np.float32)
    got, got_sal = t_dit.video_dit_forward(
        t_params, t_cfg, *(both(x)[0] for x in (video, text, ts)), concepts=both(con)[0])
    want, want_sal = j_dit.video_dit_forward(
        j_params, j_cfg, *(jnp.asarray(x) for x in (video, text, ts)), concepts=jnp.asarray(con))
    close(got, want)
    close(got_sal["output"], want_sal["output"])
    assert len(calls) == t_cfg.num_layers


def test_position_helpers():
    """Timestep embedding (raw 0..999, flip_sin_to_cos), the video id grid,
    patchify / unpatchify, and the 2B absolute embedding with its w-axis-first
    quirk on a non-square grid."""
    t = np.array([0.0, 17.0, 999.0], np.float32)
    close(t_dit._timestep_embedding(torch.from_numpy(t), 32, True, 0),
          j_dit._timestep_embedding(jnp.asarray(t), 32, True, 0), tol=SCHED)
    close(t_dit._timestep_embedding(torch.from_numpy(t), 32, False, 1),
          j_dit._timestep_embedding(jnp.asarray(t), 32, False, 1), tol=SCHED)
    np.testing.assert_array_equal(t_dit.make_video_ids(2, 3, 4, 2).numpy(),
                                  np.asarray(j_dit.make_video_ids(2, 3, 4, 2)))
    x = rand(30, 2, 3, 4, 6, 8)
    tok = t_dit.patchify_latents(torch.from_numpy(x))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_dit.patchify_latents(jnp.asarray(x))))
    np.testing.assert_array_equal(t_dit.unpatchify_latents(tok, 3, 6, 8, 4).numpy(), x)
    cfg_kw = dict(num_layers=1, num_attention_heads=2, attention_head_dim=8, time_embed_dim=8,
                  text_embed_dim=8, sample_height=12, sample_width=8, sample_frames=9,
                  max_text_seq_length=3)
    close(t_dit.cogvideox_pos_embedding(t_dit.CogVideoXConfig(**cfg_kw)),
          j_dit.cogvideox_pos_embedding(j_dit.CogVideoXConfig(**cfg_kw)), tol=SCHED)


# ------------------------------------------------------------ schedulers --


@pytest.mark.parametrize("steps", [1, 4, 50])
def test_ddim_schedule(steps):
    got, want = t_ddim.make_ddim_schedule(steps), j_ddim.make_ddim_schedule(steps)
    np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod))
    assert got.final_alpha_cumprod == want.final_alpha_cumprod
    plain = t_ddim.make_ddim_schedule(steps, snr_shift_scale=1.0, rescale_betas_zero_snr=False,
                                      set_alpha_to_one=False, beta_schedule="linear")
    plain_j = j_ddim.make_ddim_schedule(steps, snr_shift_scale=1.0, rescale_betas_zero_snr=False,
                                        set_alpha_to_one=False, beta_schedule="linear")
    np.testing.assert_array_equal(plain.alphas_cumprod.numpy(), np.asarray(plain_j.alphas_cumprod))
    assert plain.final_alpha_cumprod == pytest.approx(plain_j.final_alpha_cumprod, rel=1e-6)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_ddim_steps_and_add_noise(prediction_type):
    t_s = t_ddim.make_ddim_schedule(5, prediction_type=prediction_type)
    j_s = j_ddim.make_ddim_schedule(5, prediction_type=prediction_type)
    x, out = rand(40, 1, 3, 4, 4), rand(41, 1, 3, 4, 4)
    for t in [int(t) for t in t_s.timesteps]:
        got = t_ddim.ddim_step(t_s, torch.from_numpy(out), t, t - 200, torch.from_numpy(x))
        want = j_ddim.ddim_step(j_s, jnp.asarray(out), jnp.asarray(t), jnp.asarray(t - 200),
                                jnp.asarray(x))
        close(got, want, tol=SCHED, msg=f"t={t}")
    close(t_ddim.add_noise(t_s, torch.from_numpy(x), torch.from_numpy(out), 600),
          j_ddim.add_noise(j_s, jnp.asarray(x), jnp.asarray(out), 600), tol=SCHED)


def test_ddim_stochastic_step_needs_a_generator():
    s = t_ddim.make_ddim_schedule(4)
    x = torch.from_numpy(rand(42, 1, 8))
    with pytest.raises(ValueError):
        t_ddim.ddim_step(s, x, 750, 500, x, eta=1.0)
    draws = [t_ddim.ddim_step(s, x, 750, 500, x, eta=1.0,
                              generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1])
    assert not torch.allclose(draws[0], t_ddim.ddim_step(s, x, 750, 500, x))


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_dpm_steps(prediction_type):
    """Four DPM-Solver++ 2M steps (first order first, second order between,
    first order at the t < 0 boundary) with injected model outputs."""
    t_s = t_dpm.make_dpm_schedule(4, prediction_type=prediction_type)
    j_s = j_dpm.make_dpm_schedule(4, prediction_type=prediction_type)
    x = rand(50, 1, 2, 4, 4)
    t_state, j_state = t_dpm.dpm_init(torch.from_numpy(x)), j_dpm.dpm_init(jnp.asarray(x))
    for i, t in enumerate(int(t) for t in t_s.timesteps):
        out = rand(51 + i, *x.shape)
        t_state = t_dpm.dpm_step(t_s, t_state, torch.from_numpy(out), t, t - 250)
        j_state = j_dpm.dpm_step(j_s, j_state, jnp.asarray(out), jnp.asarray(t),
                                 jnp.asarray(t - 250))
        close(t_state.sample, j_state.sample, tol=SCHED, msg=f"step {i}")
        close(t_state.prev_x0, j_state.prev_x0, tol=SCHED)
        close(t_state.prev_lambda, j_state.prev_lambda, tol=SCHED)
    assert t_state.step_index == 4


# --------------------------------------------------------------- pipeline --


@pytest.fixture(scope="module")
def pipes():
    t_cfg, j_cfg = configs(True)
    j = j_vp.VideoConceptAttentionPipeline(
        cfg=j_cfg, dtype=jnp.float32, vae_cfg=j_vae.CogVideoXVAEConfig(**VAE_TINY))
    j._vae()
    t = TorchPipeline(
        cfg=t_cfg, dtype=torch.float32, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, j.params)),
        vae_cfg=t_vae.CogVideoXVAEConfig(**VAE_TINY),
        vae_params=params_from_numpy(jax.tree.map(np.asarray, j.vae_params)),
    )
    return t, j


def test_reduce_step_maps():
    maps = rand(60, 3, 2, C_PAD, 48)
    for layers, n in [((0, 1, 2), 2), ((2,), 4), ((1, 0), 6)]:
        close(t_vp._reduce_step_maps(torch.from_numpy(maps), layers, n),
              j_vp._reduce_step_maps(jnp.asarray(maps), layers, n))


@pytest.mark.parametrize("scheduler", ["ddim", "dpm"])
def test_cfg_denoise_loop(pipes, scheduler):
    """The CFG loop with injected latents: final latents and the per-step
    reduced maps of both taps."""
    t, j = pipes
    lat = rand(70, 1, F_LAT, 4, H_LAT, W_LAT)
    sched = t_ddim.make_ddim_schedule(3)
    j_sched = j_ddim.make_ddim_schedule(3)
    t_args = (t._encode_text(PROMPT), t._encode_text(""), t.encode_concepts(CONCEPTS))
    j_args = (j._encode_text(PROMPT), j._encode_text(""), j.encode_concepts(CONCEPTS))
    layers = (1, 0)
    got_lat, got_maps = t_vp._cfg_denoise(
        t.params, t.cfg, torch.from_numpy(lat), *t_args, sched.timesteps, sched.alphas_cumprod,
        sched.final_alpha_cumprod, 6.0, TSpec(), 1000, scheduler, layers, len(CONCEPTS))
    want_lat, want_maps = j_vp._cfg_denoise(
        j.params, j.cfg, jnp.asarray(lat), *j_args, j_sched.timesteps, j_sched.alphas_cumprod,
        j_sched.final_alpha_cumprod, 6.0, JSpec(backend="xla"), 1000, scheduler, layers,
        len(CONCEPTS))
    close(got_lat, want_lat, msg="latents")
    for tap in ("output", "cross_attention"):
        assert got_maps[tap].shape == (3, len(CONCEPTS), F_LAT * 16)
        close(got_maps[tap], want_maps[tap], msg=tap)


@pytest.mark.parametrize("options", [
    dict(),
    dict(concept_timesteps=[1], layer_indices=[1], return_cross_attention=True),
    dict(concept_timesteps=[0, 1], return_cross_attention=True, scheduler="dpm"),
])
def test_generate_video_matches_jax(pipes, monkeypatch, options):
    """`generate_video` end to end on the same injected latents: the heatmaps
    after step and layer selection (and the cross maps' second softmax)."""
    t, j = pipes
    lat = rand(80, 1, F_LAT, 4, H_LAT, W_LAT)
    monkeypatch.setattr(t_vp.torch, "randn", lambda *a, **k: torch.from_numpy(lat.copy()))
    monkeypatch.setattr(j_vp.jax.random, "normal", lambda *a, **k: jnp.asarray(lat))
    kw = dict(num_frames=F_LAT, height=H_LAT, width=W_LAT, num_inference_steps=2) | options
    got = t.generate_video(PROMPT, CONCEPTS, **kw)
    want = j.generate_video(PROMPT, CONCEPTS, **kw)
    close(got.video_latents, want.video_latents, msg="latents")
    close(got.concept_heatmaps, want.concept_heatmaps, msg="output")
    assert got.concept_heatmaps.shape == (len(CONCEPTS), F_LAT, H_LAT // 2, W_LAT // 2)
    if options.get("return_cross_attention"):
        close(got.cross_attention_maps, want.cross_attention_maps, msg="cross_attention")
    else:
        assert got.cross_attention_maps is None


@pytest.mark.parametrize("bad", [dict(layer_indices=[-1]), dict(layer_indices=[2]),
                                 dict(concept_timesteps=[-1]), dict(concept_timesteps=[2]),
                                 dict(height=7), dict(scheduler="euler")])
def test_generate_video_rejects_bad_arguments(pipes, bad):
    """Tensor indexing would wrap -1; the port refuses out-of-range layers and
    steps (before the loop) as the JAX package does, odd latent sizes, and an
    unknown scheduler."""
    t, _ = pipes
    kw = dict(num_frames=F_LAT, height=H_LAT, width=W_LAT, num_inference_steps=2) | bad
    with pytest.raises(ValueError):
        t.generate_video(PROMPT, CONCEPTS, **kw)


def test_generate_video_on_cpu_end_to_end(pipes):
    """The public entry point on the CPU with its own draw: shapes, finite
    maps that are sub-distributions over the concepts, a decode, and no
    kernel launch."""
    t, _ = pipes
    before = (t_fs.fused_concept_flash_attention.launches,
              t_fs.fused_concept_flash_attention_paired.launches)
    out = t.generate_video(PROMPT, CONCEPTS, num_frames=F_LAT, height=H_LAT, width=W_LAT,
                           num_inference_steps=2, return_cross_attention=True, decode=True)
    for maps in (out.concept_heatmaps, out.cross_attention_maps):
        assert maps.shape == (len(CONCEPTS), F_LAT, H_LAT // 2, W_LAT // 2)
        assert np.isfinite(maps).all()
    assert (out.concept_heatmaps >= 0).all() and out.concept_heatmaps.sum(0).max() <= 1 + 1e-5
    assert out.video_latents.shape == (1, F_LAT, 4, H_LAT, W_LAT)
    assert out.video_frames.shape == (1 + (F_LAT - 1) * 4, H_LAT * 4, W_LAT * 4, 3)
    assert out.video_frames.dtype == np.uint8
    assert (t_fs.fused_concept_flash_attention.launches,
            t_fs.fused_concept_flash_attention_paired.launches) == before


def test_generate_video_scopes_tf32_off(pipes, monkeypatch):
    t, _ = pipes
    seen = []
    forward = t_vp.video_dit_forward

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return forward(*args, **kwargs)

    monkeypatch.setattr(t_vp, "video_dit_forward", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    t.generate_video(PROMPT, CONCEPTS, num_frames=1, height=4, width=4, num_inference_steps=1)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


# -------------------------------------------------------------------- VAE --


@pytest.fixture(scope="module")
def vae_pair():
    j_cfg = j_vae.CogVideoXVAEConfig(**VAE_TINY)
    j_params = j_vae.init_video_vae_params(jax.random.PRNGKey(4), j_cfg)
    return (t_vae.CogVideoXVAEConfig(**VAE_TINY), j_cfg,
            params_from_numpy(jax.tree.map(np.asarray, j_params)), j_params)


def test_vae_encode(vae_pair):
    """Nine frames of 16x16 -> 3 latent frames of 4x4 (posterior mean)."""
    t_cfg, j_cfg, t_params, j_params = vae_pair
    x = np.tanh(rand(90, 1, 3, 9, 16, 16))
    got = t_vae.encode(t_params, t_cfg, torch.from_numpy(x))
    assert got.shape == (1, 4, 3, 4, 4)
    close(got, j_vae.encode(j_params, j_cfg, jnp.asarray(x)))


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_vae_decode(vae_pair, frames):
    """Odd latent frame counts decode the first frame alone (1 + 4k frames);
    an even count doubles every frame."""
    t_cfg, j_cfg, t_params, j_params = vae_pair
    z = rand(91, 1, 4, frames, 4, 4)
    got = t_vae.decode(t_params, t_cfg, torch.from_numpy(z))
    want = j_vae.decode(j_params, j_cfg, jnp.asarray(z))
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("chunk", [1, 3])
def test_vae_decode_in_frame_pieces(vae_pair, chunk, monkeypatch):
    """The frame-wise steps computed a few frames at a time (1 and 3
    output frames; the upsamplers 1 input frame) give JAX's whole-clip
    decode: 3 latent frames, 9 output frames."""
    monkeypatch.setattr(t_vae, "FRAME_CHUNK", chunk)
    t_cfg, j_cfg, t_params, j_params = vae_pair
    z = rand(93, 1, 4, 3, 4, 4)
    got = t_vae.decode(t_params, t_cfg, torch.from_numpy(z))
    want = j_vae.decode(j_params, j_cfg, jnp.asarray(z))
    assert got.shape == want.shape
    close(got, want)


def test_decode_latents_uint8(pipes):
    t, j = pipes
    lat = rand(92, 1, F_LAT, 4, H_LAT, W_LAT)
    got = t.decode_latents(torch.from_numpy(lat))
    want = j.decode_latents(jnp.asarray(lat))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------- surface --


def test_video_imports_leave_out_jax():
    code = ("import sys, conceptattention_torch.pipeline.video_pipeline, "
            "conceptattention_torch.models.video.vae, conceptattention_torch.sampling.dpm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'conceptattention_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchPipeline(cfg=configs(True)[0])


@pytest.mark.parametrize("option", [dict(lora={}), dict(lora=[{}], lora_strength=[0.5])])
def test_unported_options_raise(option):
    """LoRA adapters, one or a list with strengths, are ported now
    (`tests/test_torch_lora.py`): an adapter that targets nothing leaves
    the DiT as it is, and strengths that do not match the adapters raise."""
    plain = TorchPipeline(cfg=configs(True)[0], device="cpu")
    adapted = TorchPipeline(cfg=configs(True)[0], device="cpu", **option)
    for a, b in zip(tree_leaves(plain.params), tree_leaves(adapted.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="strengths"):
        TorchPipeline(cfg=configs(True)[0], device="cpu", lora=option["lora"],
                      lora_strength=[0.5, 0.5])
