"""The port's perturbation test, its data path, the qualitative comparison
and the figures against the JAX package's, on the CPU.

The ViT is the model zoo's tiny one (32x32 images, 8x8 patches, 5 classes)
with the JAX init carried across. Relevance that ties is the hard case: an
upsampled token map gives blocks of equal pixels, the mask's cut runs
through them, and only the JAX package's tie order masks the same pixels.

Tolerances: ranks, masks and accuracies exactly equal; the AUC, the
probability drops, the logit drift and the dissimilarity within 1e-6
(measured up to 4.8e-7, on the dissimilarity's log); relevance by `assert_maps_close` of
`tests/test_torch_baselines.py` (rtol 1e-4 and atol 1e-4 of the map's
largest value, 1e-3 for the gradient-weighted last-layer LRP); the overlay
bit for bit.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_baselines import J_VIT, T_VIT, assert_maps_close, shared_vit
from test_torch_vit import vit_state_dict

from conceptattention_torch.evals import imagenet_data as t_data
from conceptattention_torch.evals import perturbation as t_pert
from conceptattention_torch.evals.imagenet_classes import IMAGENET_CLASSES as T_CLASSES
from conceptattention_torch.evals.model_zoo import MODEL_CHOICES
from conceptattention_torch.experiments import compare_methods
from conceptattention_torch.experiments import perturbation as t_experiment
from conceptattention_torch.models.vit import vit_forward as t_vit_forward
from conceptattention_torch.utils import colormaps
from conceptattention_torch.utils import data as t_udata
from conceptattention_torch.utils import plotting as t_plot
from conceptattention_tpu.evals import perturbation as j_pert
from conceptattention_tpu.evals.imagenet_classes import IMAGENET_CLASSES as J_CLASSES
from conceptattention_tpu.models.vit import vit_forward as j_vit_forward
from conceptattention_tpu.utils import plotting as j_plot

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = 1e-6
FILL = -np.array([0.485, 0.456, 0.406], np.float32) / np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def vit():
    return shared_vit(J_VIT, 1)


def batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 3, 32, 32)).astype(np.float32)


def tied_relevance(seed=0, b=4, grid=4, size=32, levels=3):
    """Token relevance of few distinct values, upsampled nearest to pixels."""
    tok = np.random.default_rng(seed).integers(0, levels, (b, grid, grid)).astype(np.float32)
    return tok, np.array(j_pert.upsample_token_relevance(jnp.asarray(tok), size))


# ------------------------------------------------------------- masking ----
def test_mask_top_pixels_removes_exactly_k():
    rel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32))
    masked = t_pert._mask_top_pixels(torch.ones((2, 3, 8, 8)), t_pert._pixel_ranks(rel), 10)
    np.testing.assert_array_equal((masked[:, 0] == 0).sum(dim=(1, 2)).numpy(), [10, 10])
    for b in range(2):
        top = set(np.argsort(rel[b].numpy())[::-1][:10].tolist())
        gone = set(np.flatnonzero(masked[b, 0].numpy().reshape(-1) == 0).tolist())
        assert top == gone


@pytest.mark.parametrize("case", ["upsampled_tokens", "all_equal", "few_levels"])
def test_pixel_ranks_match_jax_on_ties(case):
    rng = np.random.default_rng(1)
    if case == "upsampled_tokens":
        rel = tied_relevance()[1].reshape(4, -1)
    elif case == "all_equal":
        rel = np.zeros((2, 100), np.float32)
    else:
        rel = rng.integers(0, 4, (3, 256)).astype(np.float32)
    got = t_pert._pixel_ranks(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pert._pixel_ranks(jnp.asarray(rel))))
    # the control: ties in ascending index order rank differently
    other = torch.argsort(torch.argsort(torch.from_numpy(-rel), dim=-1, stable=True), dim=-1)
    assert (other.numpy() != got).any()


def test_fill_value_applied():
    img = torch.ones((1, 3, 4, 4))
    ranks = t_pert._pixel_ranks(torch.arange(16.0)[None])
    out = t_pert._mask_top_pixels(img, ranks, 4, torch.tensor([-2.0, 0.5, 3.0])).numpy()
    np.testing.assert_allclose(out.reshape(3, 16)[:, 12:],
                               np.broadcast_to(np.array([-2.0, 0.5, 3.0])[:, None], (3, 4)))
    np.testing.assert_allclose(out.reshape(3, 16)[:, :12], 1.0)


@pytest.mark.parametrize("grid, size", [(2, 4), (14, 224), (3, 7), (14, 32), (5, 3)])
def test_upsample_token_relevance_matches_jax(grid, size):
    """Integer and non-integer scale factors, and a downsample: samples at
    pixel centres, as `jax.image.resize(..., "nearest")`."""
    tok = np.random.default_rng(grid).standard_normal((2, grid, grid)).astype(np.float32)
    got = t_pert.upsample_token_relevance(torch.from_numpy(tok), size).numpy()
    assert got.shape == (2, size, size)
    np.testing.assert_array_equal(got, np.asarray(j_pert.upsample_token_relevance(
        jnp.asarray(tok), size)))


# --------------------------------------------------------------- sweep ----
def linear_classifier(seed=1, size=16, classes=5, gate=None):
    """A linear classifier of the pixels, optionally gated to a region."""
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((3 * size * size, classes))
                         .astype(np.float32))
    g = torch.ones((size, size)) if gate is None else torch.from_numpy(gate)
    return lambda x: (x * g).reshape(x.shape[0], -1) @ w


def test_relevant_masking_hurts_more_than_random():
    gate = np.zeros((16, 16), np.float32)
    gate[:8, :8] = 1.0
    classify = linear_classifier(gate=gate)
    images = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 3, 16, 16))
                              .astype(np.float32) + 1.0)
    labels = classify(images).argmax(dim=-1)
    true_rel = torch.from_numpy(gate.reshape(1, -1)).expand(8, 256)
    good = t_pert.run_perturbation_eval(classify, images, labels, true_rel)
    bad = t_pert.run_perturbation_eval(classify, images, labels, 1.0 - true_rel)
    assert good.auc < bad.auc
    assert good.accuracy[-1] <= bad.accuracy[0] + 1e-6
    assert len(good.accuracy) == len(t_pert.PERTURBATION_STEPS)
    assert set(good.as_dict()) == {"steps", "accuracy", "target_prob_drop", "auc",
                                   "logit_diff", "dissimilarity"}
    slim = t_pert.PerturbationResult(good.steps, good.accuracy, good.target_prob_drop, good.auc)
    assert set(slim.as_dict()) == {"steps", "accuracy", "target_prob_drop", "auc"}


def test_negative_mode_flips_order():
    classify = linear_classifier(seed=5, size=8, classes=4)
    images = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 8, 8))
                              .astype(np.float32))
    rel = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64)).astype(np.float32))
    labels = torch.zeros(2, dtype=torch.long)
    pos = t_pert.run_perturbation_eval(classify, images, labels, rel)
    neg = t_pert.run_perturbation_eval(classify, images, labels, rel, negative=True)
    assert pos.accuracy.shape == neg.accuracy.shape
    assert not np.allclose(pos.target_prob_drop, neg.target_prob_drop)


def assert_results_equal(got, want):
    np.testing.assert_array_equal(got.accuracy, want.accuracy)
    assert abs(got.auc - want.auc) <= TOL
    for key in ("target_prob_drop", "logit_diff", "dissimilarity"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0, atol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("negative", [False, True], ids=["positive", "negative"])
def test_run_perturbation_eval_matches_jax_with_ties(vit, negative):
    """The tiny ViT of both packages, tie-heavy upsampled relevance, the
    -mean/std fill; labels the unmasked predictions."""
    j, p = vit
    x = batch()
    labels = np.array(j_vit_forward(j, J_VIT, jnp.asarray(x))[0].argmax(-1))
    _, rel = tied_relevance()
    want = j_pert.run_perturbation_eval(lambda a: j_vit_forward(j, J_VIT, a)[0], jnp.asarray(x),
                                        jnp.asarray(labels), jnp.asarray(rel), negative=negative,
                                        fill=jnp.asarray(FILL))
    got = t_pert.run_perturbation_eval(lambda a: t_vit_forward(p, T_VIT, a)[0],
                                       torch.from_numpy(x), torch.from_numpy(labels),
                                       torch.from_numpy(rel), negative=negative,
                                       fill=torch.from_numpy(FILL))
    assert_results_equal(got, want)
    assert want.accuracy.min() < 1.0  # the masks move the predictions


def test_extra_metrics_present_and_finite():
    classify = linear_classifier(seed=0, size=8)
    imgs = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 8, 8))
                            .astype(np.float32))
    rel = torch.from_numpy(np.random.default_rng(2).random((2, 8, 8)).astype(np.float32))
    res = t_pert.run_perturbation_eval(classify, imgs, torch.tensor([0, 3]), rel,
                                       fill=torch.tensor([-1.0, -1.0, -1.0]))
    assert res.logit_diff.shape == res.dissimilarity.shape == (9,)
    assert np.isfinite(res.logit_diff).all() and np.isfinite(res.dissimilarity).all()


@pytest.mark.parametrize("method", t_pert.CHEFER_METHODS)
def test_compute_vit_relevance_matches_jax(vit, method):
    j, p = vit
    x = batch(seed=4, b=2)
    labels = np.array([1, 3])
    want = np.asarray(j_pert.compute_vit_relevance(j, J_VIT, jnp.asarray(x), method,
                                                   index=jnp.asarray(labels)))
    got = t_pert.compute_vit_relevance(p, T_VIT, torch.from_numpy(x), method,
                                       index=torch.from_numpy(labels))
    expect = (2, 32, 32) if method in ("lrp", "full_lrp") else (2, 4, 4)
    assert got.shape == want.shape == expect
    assert_maps_close(got.numpy(), want, 1e-3 if method == "last_layer_lrp" else 1e-4)


# ---------------------------------------------------------- data path ----
def make_folder(root, n_classes=2, per_class=2, size=32):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(n_classes):
        d = os.path.join(root, f"n{c:08d}")
        os.makedirs(d)
        for i in range(per_class):
            arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img_{i}.JPEG"))


def test_imagenet_folder(tmp_path):
    make_folder(str(tmp_path))
    ds = t_data.ImageNetFolder(str(tmp_path))
    assert len(ds) == 4
    img, label = ds[0]
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8 and label == 0
    assert ds[3][1] == 1
    assert t_data.ImageNetFolder.available(str(tmp_path))
    assert not t_data.ImageNetFolder.available(str(tmp_path / "missing"))


def test_class_table_equals_jax():
    assert T_CLASSES == J_CLASSES and len(T_CLASSES) == 1000
    assert t_data.imagenet_class_name(0).startswith("tench")
    assert t_data.imagenet_class_name(207).startswith("golden retriever")


def test_prefetch_loader_keeps_order_and_raises():
    out = list(t_udata.make_loader(list(range(10)), 3, lambda xs: np.asarray(xs) * 2,
                                   buffer_size=2, num_threads=3))
    assert [o.tolist() for o in out] == [[0, 2, 4], [6, 8, 10], [12, 14, 16], [18]]
    assert list(t_udata.batched_indices(5, 2, drop_remainder=True)) == [[0, 1], [2, 3]]

    def bad(i):
        if i == 2:
            raise KeyError(i)
        return i

    it = t_udata.PrefetchIterator(range(4), bad, num_threads=2)
    assert [next(it), next(it)] == [0, 1]
    with pytest.raises(KeyError):
        next(it)
    it.close()


def test_prefetch_to_device_moves_every_leaf():
    batches = [(np.full((2,), i, np.float32), {"label": i}) for i in range(3)]
    out = list(t_udata.prefetch_to_device(batches, size=2, device="cpu"))
    assert len(out) == 3
    for i, (x, d) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.tolist() == [i, i]
        assert isinstance(d["label"], torch.Tensor) and int(d["label"]) == i


def test_perturbation_experiment_matches_jax(tmp_path, vit, monkeypatch):
    """The port's experiment on a synthetic ImageNet folder and a ViT checkpoint
    file; its CSV rows against the JAX functions on the same weights."""
    from safetensors.torch import save_file

    from conceptattention_tpu.evals.baselines import _preprocess as j_preprocess
    from conceptattention_tpu.weights.convert import convert_vit_state_dict, load_safetensors

    root = tmp_path / "val"
    os.makedirs(root)
    make_folder(str(root), size=40)
    ckpt = str(tmp_path / "vit.safetensors")
    save_file(vit_state_dict(T_VIT, seed=3), ckpt)
    out_csv = str(tmp_path / "auc.csv")
    methods = ["rollout", "gradcam", "transformer_attribution"]
    assert t_experiment.main([
        "--imagenet_dir", str(root), "--num_images", "4", "--batch_size", "2",
        "--image_size", "32", "--vit_depth", "2", "--vit_hidden", "32", "--vit_heads", "2",
        "--vit_patch", "8", "--vit_classes", "5", "--ckpt", ckpt, "--device", "cpu",
        "--methods", *methods, "--output_csv", out_csv]) == 0
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["method", "mode", "auc"] + [f"acc@{s:.1f}" for s in np.linspace(0.1, 0.9, 9)]
    assert len(rows) == 1 + 2 * len(methods)

    j = convert_vit_state_dict(load_safetensors(ckpt), J_VIT)
    ds = t_data.ImageNetFolder(str(root))
    items = [ds[i] for i in range(4)]

    def classify(a):
        return j_vit_forward(j, J_VIT, a)[0]

    for k, method in enumerate(methods):
        accs = {False: [], True: []}
        for start in (0, 2):
            x = jnp.concatenate([j_preprocess(im, 32) for im, _ in items[start:start + 2]])
            labels = jnp.asarray([lab for _, lab in items[start:start + 2]])
            rel = j_pert.upsample_token_relevance(j_pert.compute_vit_relevance(j, J_VIT, x, method),
                                                  32)
            for negative in (False, True):
                accs[negative].append(j_pert.run_perturbation_eval(
                    classify, x, labels, rel, negative=negative, fill=FILL).accuracy)
        for negative in (False, True):
            row = rows[1 + 2 * k + negative]
            assert row[:2] == [method, "negative" if negative else "positive"]
            want = np.mean(accs[negative], axis=0)
            np.testing.assert_allclose([float(v) for v in row[3:]], want, rtol=0, atol=1e-12)
            assert abs(float(row[2]) - np.trapezoid(want, np.linspace(0.1, 0.9, 9))) <= TOL


def test_perturbation_experiment_refuses_unknown_method(tmp_path, capsys):
    assert t_experiment.main(["--imagenet_dir", str(tmp_path), "--methods", "nope",
                              "--device", "cpu"]) == 2
    assert "unknown methods" in capsys.readouterr().err


# ------------------------------------------------- figures, comparison ----
def test_colormaps_are_matplotlibs():
    from matplotlib import colormaps as mpl

    x = np.random.default_rng(0).random((40, 40))
    x[0, :3] = [0.0, 1.0, 1.5]
    for name in ("plasma", "viridis"):
        np.testing.assert_array_equal(colormaps.apply(name, x), mpl[name](x)[..., :3])
    with pytest.raises(ValueError, match="colormap"):
        colormaps.lut("jet")


def test_overlay_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)
    heat = rng.standard_normal((6, 5))
    got = np.asarray(t_plot.overlay_heatmap_on_image(heat, image))
    np.testing.assert_array_equal(got, np.asarray(j_plot.overlay_heatmap_on_image(heat, image)))


def test_figures_draw_and_save(tmp_path):
    image = np.random.default_rng(2).random((30, 30, 3))
    maps = np.random.default_rng(3).random((3, 7, 7))
    fig = t_plot.plot_concept_heatmaps(image, maps, ["a", "b", "c"])
    assert fig.size == (4 * t_plot.PANEL, t_plot.PANEL + t_plot.TITLE)
    path = str(tmp_path / "f.png")
    assert t_plot.plot_concept_heatmaps(image, maps, ["a", "b", "c"], save_path=path) is None
    assert os.path.getsize(path) > 1000
    assert t_plot.plot_coefficients_heatmap(maps[0]).size[1] == t_plot.PANEL + t_plot.TITLE


def test_compare_methods_all_15_write_the_figure(tmp_path, monkeypatch, capsys):
    from PIL import Image

    for var in ("CHEFER_VITB16", "DINO_VITB16", "SD2_UNET", "SDXL_UNET", "OPENCLIP_VITH14"):
        monkeypatch.delenv(var, raising=False)
    img = str(tmp_path / "input.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(img)
    out = str(tmp_path / "cmp.png")
    assert compare_methods.main([
        "--image", img, "--caption", "a cat", "--concepts", "cat", "sky", "--methods", "all",
        "--random_weights", "--tiny", "--hard_masks", "--device", "cpu", "--dtype", "float32",
        "--model_name", "flux-tiny", "--width", "64", "--output", out]) == 0
    printed = capsys.readouterr().out
    assert os.path.getsize(out) > 1000
    for name in MODEL_CHOICES:
        assert f"{name}: coeff range" in printed
    assert "15 methods" in printed
    assert Image.open(out).size[0] == (1 + 2 * 15) * t_plot.PANEL


def test_compare_methods_refuses_before_building(tmp_path):
    args = ["--image", str(tmp_path / "absent.png"), "--concepts", "cat", "--device", "cpu"]
    with pytest.raises(SystemExit, match="NotAMethod"):
        compare_methods.main(args + ["--methods", "NotAMethod"])
    with pytest.raises(SystemExit, match="--target"):
        compare_methods.main(args + ["--target", "dog"])
