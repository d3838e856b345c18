"""The port's video writers and video experiment, on the CPU.

The writers' frames are held to `utils/colormaps.apply` over the shared
range of all concepts (the JAX package's matplotlib `imshow(vmin, vmax)`
normalization) exactly, and read back from the GIF written (PIL keeps
every colour of a frame of at most 256). The experiment's `--tiny --device
cpu` run writes its GIFs and returns the heatmaps of the direct
`generate_video` call with the same arguments (bit for bit), and, with the
JAX package's tiny weights carried across and the same latents injected
into both packages' normal draws (in f32), the JAX script's heatmaps to
1e-4 (as `tests/test_torch_video.py`).
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from conceptattention_torch.experiments import run_video_concept_attention as t_exp
from conceptattention_torch.pipeline import video_pipeline as t_vp
from conceptattention_torch.utils import colormaps
from conceptattention_torch.utils import video_utils as t_vu
from conceptattention_torch.weights.from_jax import params_from_numpy
from conceptattention_tpu.pipeline import video_pipeline as j_vp
from conceptattention_tpu.utils import video_utils as j_vu

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def maps(seed=0, c=3, f=4, h=3, w=5):
    return np.random.default_rng(seed).standard_normal((c, f, h, w)).astype(np.float32)


def gif_frames(path):
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
    return np.stack(out)


def test_frames_are_the_colormap_over_the_shared_range():
    heat = maps()
    frames = t_vu.concept_video_frames(heat, "plasma", scale=2)
    lo, hi = heat.min(), heat.max()
    want = np.round(colormaps.apply("plasma", (heat - lo) / (hi - lo)) * 255).astype(np.uint8)
    assert frames.shape == (4, 6, 3 * 10, 3)
    for c in range(3):
        panel = frames[:, :, 10 * c:10 * (c + 1)]
        np.testing.assert_array_equal(panel[:, ::2, ::2], want[c])
        np.testing.assert_array_equal(panel[:, 1::2, 1::2], want[c])


def test_concept_video_gif_round_trips(tmp_path):
    heat = maps(1)
    path = t_vu.make_concept_attention_video(heat, ["a", "b", "c"], str(tmp_path / "c.gif"), fps=4)
    np.testing.assert_array_equal(gif_frames(path), t_vu.concept_video_frames(heat))
    # one file per concept, each in its own range
    paths = t_vu.make_individual_videos(heat, ["a b", "c", "d"], str(tmp_path / "each"))
    assert [os.path.basename(p) for p in paths] == ["a_b.gif", "c.gif", "d.gif"]
    np.testing.assert_array_equal(gif_frames(paths[1]), t_vu.concept_video_frames(heat[1:2]))
    with pytest.raises(ValueError, match="concepts"):
        t_vu.make_concept_attention_video(heat, ["a"], str(tmp_path / "x.gif"))


def test_non_gif_without_ffmpeg_degrades_to_gif(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(t_vu.shutil, "which", lambda name: None)
    frames = (np.random.default_rng(2).random((3, 8, 8, 3)) * 255).astype(np.uint8)
    path = t_vu.write_video(frames, str(tmp_path / "clip.mp4"))
    assert path == str(tmp_path / "clip.gif") and os.path.exists(path)
    assert "ffmpeg unavailable" in capsys.readouterr().err
    np.testing.assert_array_equal(gif_frames(path), frames)
    # the JAX package's writer takes the same fall-back with the same path
    writer, j_path = j_vu._pick_writer(8, str(tmp_path / "clip.mp4"))
    if not type(writer).__name__.startswith("FFMpeg"):
        assert j_path == path


def distinct(frames):
    """The frames a GIF keeps: PIL folds a frame equal to the one before it
    into that frame's duration."""
    keep = [0] + [i for i in range(1, len(frames)) if not np.array_equal(frames[i], frames[i - 1])]
    return frames[keep]


def load_jax_script():
    path = os.path.join(REPO, "experiments", "video_model", "run_video_concept_attention.py")
    spec = importlib.util.spec_from_file_location("j_run_video", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_experiment_tiny_matches_jax_and_the_direct_call(tmp_path, monkeypatch):
    args = t_exp.parse_args(["--tiny", "--device", "cpu", "--num_steps", "2", "--decode",
                             "--output_dir", str(tmp_path)])
    cfg, vae_cfg = t_exp.tiny_configs()
    j_cfg, j_vae_cfg = load_jax_configs()
    j_pipe = j_vp.VideoConceptAttentionPipeline(cfg=j_cfg, dtype=jnp.float32, vae_cfg=j_vae_cfg)
    j_pipe._vae()
    t_pipe = t_vp.VideoConceptAttentionPipeline(
        cfg=cfg, dtype=torch.float32, device="cpu", vae_cfg=vae_cfg,
        params=params_from_numpy(jax.tree.map(np.asarray, j_pipe.params)),
        vae_params=params_from_numpy(jax.tree.map(np.asarray, j_pipe.vae_params)))

    def latents(shape):
        return np.random.default_rng(5).standard_normal(tuple(shape)).astype(np.float32)

    monkeypatch.setattr(t_vp.torch, "randn", lambda *a, **k: torch.from_numpy(latents(
        a[0] if len(a) == 1 and isinstance(a[0], (tuple, list, torch.Size)) else a)))
    monkeypatch.setattr(j_vp.jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(latents(shape)))

    out = t_exp.main(["--tiny", "--device", "cpu", "--num_steps", "2", "--decode",
                      "--output_dir", str(tmp_path)], pipeline=t_pipe)
    assert args.num_frames == 4 and args.height == args.width == 8
    for name in ("concepts.gif", "video.gif"):
        assert os.path.exists(tmp_path / name)
    np.testing.assert_array_equal(gif_frames(tmp_path / "video.gif"), distinct(out.video_frames))
    direct = t_pipe.generate_video(args.prompt, args.concepts, num_frames=4, height=8, width=8,
                                   num_inference_steps=2, guidance_scale=args.guidance_scale,
                                   seed=0, decode=True)
    np.testing.assert_array_equal(out.concept_heatmaps, direct.concept_heatmaps)

    captured = {}
    monkeypatch.setattr(j_vu, "make_concept_attention_video",
                        lambda heatmaps, concepts, path, **kw: captured.update(maps=heatmaps))
    monkeypatch.setattr(j_vu, "write_video", lambda frames, path, **kw: captured.update(frames=frames))
    script = load_jax_script()
    monkeypatch.setattr(j_vp, "VideoConceptAttentionPipeline", lambda **kw: j_pipe)
    monkeypatch.setattr(sys, "argv", ["run", "--tiny", "--num_steps", "2", "--decode",
                                      "--output_dir", str(tmp_path / "jax")])
    script.main()
    np.testing.assert_allclose(out.concept_heatmaps, np.asarray(captured["maps"]), rtol=1e-4,
                               atol=1e-4)
    assert np.asarray(captured["frames"]).shape == out.video_frames.shape


def load_jax_configs():
    from conceptattention_tpu.models.video.dit import CogVideoXConfig
    from conceptattention_tpu.models.video.vae import CogVideoXVAEConfig

    cfg = CogVideoXConfig(num_attention_heads=4, attention_head_dim=16, time_embed_dim=32,
                          text_embed_dim=64, num_layers=2, max_text_seq_length=16,
                          use_rotary_positional_embeddings=True)
    return cfg, CogVideoXVAEConfig(block_out_channels=(8, 16), latent_channels=cfg.in_channels,
                                   layers_per_block=1, norm_num_groups=4)
