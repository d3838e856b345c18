"""The port's ViT baseline zoo against the JAX package's: the segmentation
methods, the relevance propagation, the TextSpan models, the preprocessing,
the model factory and the ImageNet harness with a ViT baseline.

Both packages hold the same weights (the JAX init carried across by
`weights/from_jax.py`, or the same `.safetensors` file read by each
package's loader) at the JAX model zoo's tiny shapes, in f32 on the CPU.
The relevance propagation also runs at depth 3 with the Chefer final-norm
eps 1e-5, so "second_layer" and "last_layer" differ.

Tolerances: saliency maps and relevance by `assert_maps_close`, rtol 1e-4
and atol 1e-4 of the map's largest |value| (the packages differ by up to
3e-5 of it on the pixel relevance, whose divisions amplify
reduction-order differences, and by 1e-6 elsewhere), 1e-3 of it for the
gradient-weighted last-layer relevance (each package lies 3e-4 to 5e-4 of
it from the same computation in f64); the attention gradients to 1e-5 of
their largest |value|; the
preprocessing to 2e-5 (normalised pixels up to 2.6); the harness's FINAL
metrics, printed to 4 decimals, within 2e-4 as in
`tests/test_torch_eval_harness.py`.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval_harness import ROOT, final_numbers, make_mat
from test_torch_vit import open_clip_state_dict, vit_state_dict

from conceptattention_torch.evals import baselines as t_base
from conceptattention_torch.evals import lrp as t_lrp
from conceptattention_torch.evals import model_zoo as t_zoo
from conceptattention_torch.evals import textspan as t_ts
from conceptattention_torch.experiments import imagenet_segmentation as t_imagenet
from conceptattention_torch.models import clip_vit as t_clip
from conceptattention_torch.models.text.encoders import StubTextEncoders as TStub
from conceptattention_torch.weights.from_jax import (
    open_clip_params_from_numpy,
    vit_params_from_numpy,
)
from conceptattention_tpu.evals import baselines as j_base
from conceptattention_tpu.evals import lrp as j_lrp
from conceptattention_tpu.evals import model_zoo as j_zoo
from conceptattention_tpu.evals import textspan as j_ts
from conceptattention_tpu.models import clip_vit as j_clip
from conceptattention_tpu.models import vit as j_vit
from conceptattention_tpu.models.text.encoders import StubTextEncoders as JStub

torch.set_num_threads(2)  # six test workers share the host's cores

FINAL_TOL = 2e-4
T_VIT, J_VIT = t_zoo.tiny_configs("DINO")["vit_cfg"], j_zoo.tiny_configs("DINO")["vit_cfg"]
T_DEEP = dataclasses.replace(T_VIT, depth=3, final_norm_eps=1e-5)
J_DEEP = dataclasses.replace(J_VIT, depth=3, final_norm_eps=1e-5)
T_CLIP, J_CLIP = t_zoo.tiny_configs("TextSpan"), j_zoo.tiny_configs("TextSpan")
CHEFER = ["CheferLRP", "CheferRollout", "CheferLastLayerAttention", "CheferAttentionGradCAM",
          "CheferTransformerAttribution", "CheferFullLRP", "CheferLastLayerLRP"]


def assert_maps_close(got, want, scale=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=scale * np.abs(want).max())


def shared_vit(j_cfg, seed):
    j = j_vit.init_vit_params(jax.random.PRNGKey(seed), j_cfg)
    return j, vit_params_from_numpy(jax.tree.map(np.asarray, j))


@pytest.fixture(scope="module")
def vit():
    return shared_vit(J_VIT, 1)  # seed 1: GradCAM's map is not all zero on `image()`


@pytest.fixture(scope="module")
def deep_vit():
    return shared_vit(J_DEEP, 13)


def image(size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (size, size, 3), dtype=np.uint8)


def pixels(batch=1, seed=21):
    return np.random.default_rng(seed).standard_normal((batch, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("method", t_base.METHODS)
def test_segmentation_methods_match_jax(vit, method):
    j, t = vit
    concepts = ["cat", "dog"]
    got, recon = t_base.ViTAttentionSegmentationModel(t, T_VIT, method).segment_individual_image(
        image(), concepts, "a cat")
    want, _ = j_base.ViTAttentionSegmentationModel(j, J_VIT, method).segment_individual_image(
        image(), concepts, "a cat")
    assert recon is None and got.shape == (2, T_VIT.grid, T_VIT.grid) and got.dtype == np.float32
    assert np.abs(got).max() > 0
    np.testing.assert_array_equal(got[0], got[1])  # concept-agnostic
    assert_maps_close(got, want)
    masks, coeffs, _ = t_base.ViTAttentionSegmentationModel(t, T_VIT, method)(
        [image()], target_concepts=["cat"], concepts=concepts, captions=["a cat"])
    assert masks[0].dtype == bool and masks[0].shape == (T_VIT.grid, T_VIT.grid)


def test_unknown_method_is_refused(vit):
    with pytest.raises(ValueError, match="method"):
        t_base.ViTAttentionSegmentationModel(vit[1], T_VIT, "saliency")


@pytest.mark.parametrize("method", ["transformer_attribution", "rollout", "full", "last_layer",
                                    "last_layer_attn", "second_layer"])
def test_vit_relprop_matches_jax(deep_vit, method):
    j, t = deep_vit
    x, index = pixels(), np.array([3])
    want = np.asarray(j_lrp.vit_relprop(j, J_DEEP, jnp.asarray(x), index=jnp.asarray(index),
                                        method=method))
    got = t_lrp.vit_relprop(t, T_DEEP, torch.from_numpy(x), index=torch.from_numpy(index),
                            method=method).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert_maps_close(got, want)


def test_vit_relprop_ablation_and_default_index(deep_vit):
    """`is_ablation` weights the last layer's relevance by its gradient; no
    index takes the argmax logit."""
    j, t = deep_vit
    x = pixels(seed=4)
    want = j_lrp.vit_relprop(j, J_DEEP, jnp.asarray(x), method="last_layer", is_ablation=True)
    got = t_lrp.vit_relprop(t, T_DEEP, torch.from_numpy(x), method="last_layer",
                            is_ablation=True)
    assert_maps_close(got.numpy(), want, scale=1e-3)
    with pytest.raises(ValueError, match="unknown method"):
        t_lrp.vit_relprop(t, T_DEEP, torch.from_numpy(x), method="nope")


def test_attention_gradients_match_jax_grad(vit):
    """GradCAM's d(logit)/dA from autograd against `jax.grad`, also when the
    caller runs under `torch.inference_mode`."""
    j, t = vit
    x = pixels(batch=2)
    index = np.array([1, 4])
    want = np.asarray(j_lrp._attn_gradients(j, J_VIT, jnp.asarray(x), jnp.asarray(index)))
    assert np.abs(want).max() > 0
    got = t_lrp._attn_gradients(t, T_VIT, torch.from_numpy(x), torch.from_numpy(index))
    assert_maps_close(got.numpy(), want, scale=1e-5)
    with torch.inference_mode():
        sal = t_base.ViTAttentionSegmentationModel(t, T_VIT, "gradcam").saliency(
            torch.from_numpy(x))
        again = t_lrp._attn_gradients(t, T_VIT, torch.from_numpy(x), torch.from_numpy(index))
    assert torch.equal(again, got) and sal.shape == (2, T_VIT.grid, T_VIT.grid)


def test_lrp_conservation_direction(deep_vit):
    """Transformer-attribution relevance is non-negative and non-trivial."""
    sal = t_lrp.vit_relprop(deep_vit[1], T_DEEP, torch.from_numpy(pixels()),
                            method="transformer_attribution")
    assert (sal >= 0).all() and sal.max() > 0


def test_batched_lrp_equals_per_image(deep_vit):
    """The residual-add rule normalises per sample: a batch does not couple
    its images."""
    t = deep_vit[1]
    img0 = torch.from_numpy(pixels())
    batch = torch.cat([img0, img0.flip(2)])
    idx = torch.zeros(2, dtype=torch.long)
    got = t_lrp.vit_relprop(t, T_DEEP, batch, index=idx, method="full")
    for i in range(2):
        want = t_lrp.vit_relprop(t, T_DEEP, batch[i:i + 1], index=idx[:1], method="full")
        np.testing.assert_allclose(got[i].numpy(), want[0].numpy(), rtol=1e-4, atol=1e-6)


def test_rollouts_match_jax(vit):
    j, t = vit
    x = pixels(batch=2, seed=3)
    _, attns = t_base.vit_forward(t, T_VIT, torch.from_numpy(x), return_attn=True)
    rolled = t_base.attention_rollout(attns)
    np.testing.assert_allclose(rolled.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(rolled.numpy(), np.asarray(j_base.attention_rollout(
        jnp.asarray(attns.numpy()))), rtol=1e-5, atol=1e-7)
    cams = torch.rand(3, 2, 5, 5, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(t_lrp._rollout(cams, 1).numpy(), np.asarray(
        j_lrp._rollout(jnp.asarray(cams.numpy()), 1)), rtol=1e-5, atol=1e-7)


def test_safe_divide_matches_jax():
    b = np.array([0.0, 1e-12, -1e-12, 1e-9, -1e-9, 0.5, -2.0, 1e-10], np.float32)
    a = np.linspace(-1, 1, b.size).astype(np.float32)
    got = t_lrp.safe_divide(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_lrp.safe_divide(jnp.asarray(a),
                                                                    jnp.asarray(b))))
    assert got[0] == 0.0


def test_clip_textspan_over_vit_matches_jax(vit):
    j, t = vit
    concepts = ["cat", "sky"]
    got, _ = t_ts.CLIPTextSpanSegmentationModel(t, T_VIT, TStub(clip_dim=32)) \
        .segment_individual_image(image(seed=4), concepts, "a cat")
    want, _ = j_ts.CLIPTextSpanSegmentationModel(j, J_VIT, JStub(clip_dim=32)) \
        .segment_individual_image(image(seed=4), concepts, "a cat")
    assert not np.allclose(got[0], got[1])  # concept-specific
    assert_maps_close(got, want)
    x = pixels()
    np.testing.assert_allclose(
        t_ts.head_token_decomposition(t, T_VIT, torch.from_numpy(x)).numpy(),
        np.asarray(j_ts.head_token_decomposition(j, J_VIT, jnp.asarray(x))), rtol=1e-4, atol=1e-6)


def test_open_clip_textspan_matches_jax():
    j = j_clip.init_open_clip_params(jax.random.PRNGKey(2), J_CLIP["vit_cfg"],
                                     J_CLIP["clip_txt_cfg"])
    t = open_clip_params_from_numpy(jax.tree.map(np.asarray, j))
    concepts = ["cat", "sky", "dog"]
    for size in (28, 40, 20):  # at the tower's size, downsampled, upsampled
        got, _ = t_ts.OpenCLIPTextSpanSegmentationModel(t, T_CLIP["vit_cfg"], T_CLIP[
            "clip_txt_cfg"]).segment_individual_image(image(size, seed=5), concepts, "a cat")
        want, _ = j_ts.OpenCLIPTextSpanSegmentationModel(j, J_CLIP["vit_cfg"], J_CLIP[
            "clip_txt_cfg"]).segment_individual_image(image(size, seed=5), concepts, "a cat")
        assert got.shape == (3, 2, 2)
        assert_maps_close(got, want)


def test_hash_tokenizer_ids_match_jax():
    texts = [t.format(c) for c in ("cat", "golden retriever", "sky") for t in t_ts.PROMPT_TEMPLATES]
    assert t_ts.PROMPT_TEMPLATES == j_ts.PROMPT_TEMPLATES and len(t_ts.PROMPT_TEMPLATES) == 80
    for cfg_t, cfg_j in ((T_CLIP["clip_txt_cfg"], J_CLIP["clip_txt_cfg"]),
                         (t_clip.VIT_H_14_TEXT, j_clip.VIT_H_14_TEXT)):
        got = t_ts._hash_tokenize(cfg_t)(texts)
        np.testing.assert_array_equal(got, j_ts._hash_tokenize(cfg_j)(texts))
        assert got.dtype == np.int32 and (got.argmax(-1) > 0).all()


class TestPreprocess:
    """The cases of `tests/test_baselines.py::TestPreprocessDtype`, and the
    resize against `jax.image.resize` up and down."""

    def test_dark_uint8_matches_float(self):
        dark_u8 = np.ones((16, 16, 3), dtype=np.uint8)  # max == 1
        dark_f = np.full((16, 16, 3), 1.0 / 255.0, dtype=np.float32)
        np.testing.assert_allclose(t_base._preprocess(dark_u8, 16).numpy(),
                                   t_base._preprocess(dark_f, 16).numpy(), atol=1e-6)

    def test_float01_not_rescaled(self):
        from conceptattention_torch.utils.images import as_float01_chw

        out = as_float01_chw(np.full((8, 8, 3), 0.75, dtype=np.float32))
        assert out.shape == (3, 8, 8)
        np.testing.assert_allclose(out, 0.75)

    def test_uint8_scaled(self):
        from conceptattention_torch.utils.images import as_float01_chw

        np.testing.assert_allclose(as_float01_chw(np.full((8, 8, 3), 255, np.uint8)), 1.0)

    @pytest.mark.parametrize("size", [64, 512, 224], ids=["up", "down", "same"])
    def test_resize_matches_jax(self, size):
        img = image(size, seed=size)
        got = t_base._preprocess(img, 224)
        assert got.shape == (1, 3, 224, 224) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(j_base._preprocess(img, 224)),
                                   rtol=0, atol=2e-5)


class TestModelZoo:
    """The cases of `tests/test_model_zoo.py`."""

    def test_choices_cover_reference_switch(self):
        assert t_zoo.MODEL_CHOICES == j_zoo.MODEL_CHOICES and len(t_zoo.MODEL_CHOICES) == 15

    def test_unknown_name_rejected(self):
        with pytest.raises(ValueError, match="unknown model"):
            t_zoo.build_segmentation_model("NotAModel")

    def test_flux_models_need_pipeline(self):
        with pytest.raises(ValueError, match="pipeline"):
            t_zoo.build_segmentation_model("RawOutputSpace")

    def test_missing_checkpoint_message(self, monkeypatch):
        monkeypatch.delenv("CHEFER_VITB16", raising=False)
        with pytest.raises(FileNotFoundError, match="CHEFER_VITB16"):
            t_zoo.build_segmentation_model("CheferRollout", vit_cfg=T_VIT, device="cpu")

    @pytest.mark.parametrize("name", ["DAAMSD2", "DAAMSDXL"])
    def test_daam_sd_segments(self, name, monkeypatch):
        """The zoo's tiny UNets with random weights: one coefficient map per
        concept at the finest attention level (SD2 attends at level 0 of an
        8x8 latent, SDXL only at level 1, 4x4), and boolean masks."""
        monkeypatch.delenv("SDXL_UNET" if name == "DAAMSDXL" else "SD2_UNET", raising=False)
        model = t_zoo.build_segmentation_model(name, random_weights=True, tiny=True,
                                               device="cpu", latent_size=8)
        masks, coeffs, _ = model([image()], target_concepts=["cat"], concepts=["cat", "sky"],
                                 captions=["a cat under the sky"])
        side = 8 if name == "DAAMSD2" else 4
        assert masks[0].dtype == bool and masks[0].shape == (side, side)
        assert np.isfinite(np.asarray(coeffs[0])).all()

    @pytest.mark.parametrize("name", ["DINO", *CHEFER])
    def test_vit_baselines_segment(self, name):
        model = t_zoo.build_segmentation_model(name, random_weights=True, vit_cfg=T_VIT,
                                               device="cpu")
        masks, coeffs, _ = model([image()], target_concepts=["cat"], concepts=["cat", "sky"],
                                 captions=["a cat"])
        assert masks[0].dtype == bool
        assert np.isfinite(np.asarray(coeffs[0])).all()

    def test_textspan_baseline_segments(self):
        model = t_zoo.build_segmentation_model("TextSpan", random_weights=True, tiny=True,
                                               device="cpu")
        masks, coeffs, _ = model([image(28, seed=2)], target_concepts=["cat"],
                                 concepts=["cat", "sky"], captions=["a cat"])
        assert masks[0].shape == (2, 2) and np.isfinite(np.asarray(coeffs[0])).all()

    def test_flux_tap_via_factory(self):
        from conceptattention_torch import ConceptAttentionFluxPipeline

        pipe = ConceptAttentionFluxPipeline("flux-tiny", dtype=torch.float32, device="cpu")
        model = t_zoo.build_segmentation_model(
            "RawCrossAttention", pipeline=pipe, num_steps=2, noise_timestep=1, width=64,
            height=64, layer_indices=[0, 1])
        coeff, _ = model.segment_individual_image(image(64, seed=3), ["cat", "sky"], "a cat")
        assert coeff.shape[0] == 2 and np.isfinite(coeff).all()

    @pytest.mark.parametrize("name", ["CheferTransformerAttribution", "DINO", "TextSpan"])
    def test_checkpoints_load_as_jax(self, name, tmp_path, monkeypatch):
        """The environment variable's checkpoint, read by each package's
        loader and converter, gives the same maps."""
        from safetensors.torch import save_file

        path = str(tmp_path / "ckpt.safetensors")
        if name == "TextSpan":
            save_file(open_clip_state_dict(T_CLIP["vit_cfg"], T_CLIP["clip_txt_cfg"], seed=6), path)
            monkeypatch.setenv("OPENCLIP_VITH14", path)
        else:
            save_file(vit_state_dict(T_VIT, seed=6), path)
            monkeypatch.setenv("DINO_VITB16" if name == "DINO" else "CHEFER_VITB16", path)
        img = image(36, seed=7)
        got, _ = t_zoo.build_segmentation_model(name, tiny=True, device="cpu") \
            .segment_individual_image(img, ["cat", "sky"], "a cat")
        want, _ = j_zoo.build_segmentation_model(name, tiny=True).segment_individual_image(
            img, ["cat", "sky"], "a cat")
        assert_maps_close(got, np.asarray(want))


# The JAX harness with the zoo's tiny configs, once per model, its
# checkpoints named by the environment as in the port's run.
JAX_HARNESS = """
import functools
import sys
import conceptattention_tpu.evals.model_zoo as zoo
zoo.build_segmentation_model = functools.partial(zoo.build_segmentation_model, tiny=True)
import run_experiment

mat, *names = sys.argv[1:]
for name in names:
    sys.argv = ["run_experiment.py", "--mat_path", mat, "--segmentation_model", name]
    run_experiment.main()
"""
HARNESS_MODELS = ["CheferLRP", "CheferAttentionGradCAM", "DINO", "TextSpan"]


def test_imagenet_harness_with_vit_baselines_matches_jax(tmp_path, monkeypatch, capsys):
    from safetensors.torch import save_file

    mat = make_mat(str(tmp_path / "gtsegs.mat"))
    env = {}
    for var, sd in (("CHEFER_VITB16", vit_state_dict(T_VIT, seed=8)),
                    ("DINO_VITB16", vit_state_dict(T_VIT, seed=9)),
                    ("OPENCLIP_VITH14", open_clip_state_dict(T_CLIP["vit_cfg"],
                                                             T_CLIP["clip_txt_cfg"], seed=10))):
        env[var] = str(tmp_path / f"{var}.safetensors")
        save_file(sd, env[var])
        monkeypatch.setenv(var, env[var])
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu", **env,
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "experiments",
                                                                  "imagenet_segmentation")]))
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_HARNESS, mat, *HARNESS_MODELS],
                               cwd=ROOT, env=jax_env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    monkeypatch.setattr(t_zoo, "build_segmentation_model",
                        functools.partial(t_zoo.build_segmentation_model, tiny=True))
    for name in HARNESS_MODELS:
        assert t_imagenet.main(["--mat_path", mat, "--segmentation_model", name,
                                "--device", "cpu"]) == 0
    got = final_numbers(capsys.readouterr().out)
    out, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-3000:]
    want = final_numbers(out)
    assert len(got) == len(want) == len(HARNESS_MODELS)
    for name, g, w in zip(HARNESS_MODELS, got, want):
        assert g.keys() == w.keys() == {"pixAcc", "mIoU", "mAP"}
        for key in g:
            assert abs(g[key] - w[key]) <= FINAL_TOL, (name, key, got, want)


def test_imagenet_harness_refuses_what_it_cannot_run(tmp_path, monkeypatch, capsys):
    absent = ["--mat_path", str(tmp_path / "absent.mat"), "--device", "cpu"]
    with pytest.raises(ValueError, match="image_batch"):
        t_imagenet.main([*absent, "--segmentation_model", "DINO", "--image_batch", "4"])
    with pytest.raises(ValueError, match="unknown segmentation model"):
        t_imagenet.main([*absent, "--segmentation_model", "Chefer"])
    # DAAMSDXL, once refused, now builds and runs (the zoo's tiny UNet)
    monkeypatch.delenv("SDXL_UNET", raising=False)
    monkeypatch.setattr(t_zoo, "build_segmentation_model",
                        functools.partial(t_zoo.build_segmentation_model, tiny=True))
    mat = make_mat(str(tmp_path / "gtsegs.mat"), n=2)
    assert t_imagenet.main(["--mat_path", mat, "--device", "cpu", "--segmentation_model",
                            "DAAMSDXL", "--random_weights"]) == 0
    assert len(final_numbers(capsys.readouterr().out)) == 1


@pytest.mark.parametrize("script", ["run_ablations.sh", "run_baselines.sh"])
def test_shell_scripts_use_harness_flags(script):
    """Every run of the port's shell scripts parses with the harness's
    flags, and names only models the harness builds."""
    import re
    import shlex

    text = open(os.path.join(ROOT, "conceptattention_torch", "experiments", script)).read()
    assert "python -m conceptattention_torch.experiments.imagenet_segmentation" in text
    runs = [shlex.split(line.split("$RUN", 1)[1].replace('"$m"', m))
            for line in text.splitlines() if line.strip().startswith("$RUN")
            for m in (re.findall(r"\b(Chefer\w+)", text) if '"$m"' in line else [""])]
    assert len(runs) == {"run_ablations.sh": 10, "run_baselines.sh": 11}[script]
    base = "--segmentation_model" if script == "run_baselines.sh" else ""
    for args in runs:
        parsed = t_imagenet.parse_args(["--mat_path", "x", *base.split(), *args])
        t_imagenet.check_segmentation_model(parsed.segmentation_model, parsed.image_batch)
