"""The port's eval host code against the JAX package's, on the CPU.

Metrics, the resumable state, the resizes and the blur, the dataset loaders
on synthetic fixtures (a gtsegs-style .mat and a mini VOC tree, built as
`tests/test_datasets.py` builds them), and the port's host library
(`native.py`, g++-built) against its numpy versions and against the JAX
package's library. Counts are held exactly; the blur to the tolerance
`tests/test_native.py` uses (rtol 1e-4, atol 1e-5), resizes bit for bit.
"""

import json

import numpy as np
import pytest

from conceptattention_torch import native as t_native
from conceptattention_torch.evals import datasets as t_data
from conceptattention_torch.evals import metrics as t_metrics
from conceptattention_torch.evals.segmentation import gaussian_blur_3x3 as t_blur
from conceptattention_torch.utils.eval_state import SegEvalState as TState
from conceptattention_torch.utils.plotting import upsample_nearest as t_upsample
from conceptattention_tpu import native as j_native
from conceptattention_tpu.evals import datasets as j_data
from conceptattention_tpu.evals import metrics as j_metrics
from conceptattention_tpu.evals.segmentation import gaussian_blur_3x3 as j_blur
from conceptattention_tpu.utils.eval_state import SegEvalState as JState
from conceptattention_tpu.utils.plotting import upsample_nearest as j_upsample

BLUR = dict(rtol=1e-4, atol=1e-5)


def label_maps(seed, shape, nclass, ignore=True):
    """Random prediction and target class maps; with `ignore` the target
    has unlabelled (-1) pixels."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, nclass, shape)
    target = rng.integers(-1 if ignore else 0, nclass, shape)
    return pred, target


@pytest.mark.parametrize("nclass,shape", [(2, (2, 37, 41)), (3, (50, 50)), (21, (64, 48))])
def test_metrics_match_jax(nclass, shape):
    pred, target = label_maps(nclass, shape, nclass)
    assert t_metrics.batch_pix_accuracy(pred, target) == j_metrics.batch_pix_accuracy(pred, target)
    for got, want in zip(t_metrics.batch_intersection_union(pred, target, nclass),
                         j_metrics.batch_intersection_union(pred, target, nclass)):
        np.testing.assert_array_equal(got, want)


def test_average_precision_matches_jax():
    rng = np.random.default_rng(1)
    target = (rng.random(500) > 0.6).astype(np.float64)
    scores = np.round(rng.random(500), 2)  # ties: one point per distinct score
    scores[3] = np.nan
    assert t_metrics.average_precision(target, scores) == j_metrics.average_precision(target,
                                                                                      scores)
    assert t_metrics.average_precision(np.zeros(5), scores[:5]) == 0.0
    soft = rng.random((3, 2, 16, 16))
    labels = rng.integers(-1, 2, (3, 16, 16))
    assert t_metrics.get_ap_scores(soft, labels) == j_metrics.get_ap_scores(soft, labels)
    assert (t_metrics.get_ap_scores(soft, labels, ignore_index=0)
            == j_metrics.get_ap_scores(soft, labels, ignore_index=0))


def test_seg_eval_state_matches_jax_and_resumes(tmp_path, capsys):
    rng = np.random.default_rng(2)
    t_st, j_st = TState(), JState()
    for i in range(3):
        pred, target = label_maps(10 + i, (2, 20, 20), 2, ignore=False)
        correct, labeled = t_metrics.batch_pix_accuracy(pred, target)
        inter, union = t_metrics.batch_intersection_union(pred, target, 2)
        ap = list(rng.random(2))
        for st in (t_st, j_st):
            st.update(correct, labeled, inter, union, ap, i + 1)
    assert t_st.summary() == j_st.summary()
    assert (t_st.pix_acc, t_st.miou, t_st.mean_ap) == (j_st.pix_acc, j_st.miou, j_st.mean_ap)
    assert np.isnan(TState().mean_ap) and TState().summary() == JState().summary()
    path = str(tmp_path / "state.json")
    t_st.save(path)
    j_path = str(tmp_path / "jax_state.json")
    j_st.save(j_path)
    assert json.load(open(path)) == json.load(open(j_path))
    back = TState.load(path)
    assert "resuming from image 3" in capsys.readouterr().out
    assert back.summary() == t_st.summary() and back.next_index == 3
    assert JState.load(path).summary() == back.summary()  # the same file format
    assert TState.load(str(tmp_path / "absent.json")).next_index == 0
    TState().save(None)  # no path: nothing written


@pytest.mark.parametrize("src,out", [((17, 23), (64, 48)), ((64, 64), (14, 14)), ((8, 8), (8, 8))])
def test_resizes_match_jax_bit_for_bit(src, out):
    x = np.random.default_rng(3).standard_normal(src)
    np.testing.assert_array_equal(t_upsample(x, *out), j_upsample(x, *out))
    mask = np.random.default_rng(4).integers(0, 256, src, dtype=np.uint8)
    got = t_data.resize_mask_nearest(mask, *out)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_data.resize_mask_nearest(mask, *out))
    np.testing.assert_array_equal(t_native.nearest_resize(x, *out), j_native.nearest_resize(x, *out))
    np.testing.assert_array_equal(t_native.nearest_resize(x, *out),
                                  t_native.nearest_resize_plain(x, *out))


@pytest.mark.parametrize("shape", [(16, 16), (3, 9, 7), (2, 2, 5, 1), (1, 1)])
def test_gaussian_blur_matches_jax(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    if min(shape[-2:]) > 1:  # numpy's reflect padding needs two pixels
        np.testing.assert_allclose(t_blur(x), j_blur(x), rtol=1e-12, atol=0)
        np.testing.assert_allclose(t_native.gaussian_blur3(x), t_blur(x), **BLUR)
    got = t_native.gaussian_blur3(x, sigma=0.7)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, j_native.gaussian_blur3(x, sigma=0.7), **BLUR)


@pytest.mark.parametrize("nclass", [2, 5])
def test_native_counts_match_plain_and_jax(nclass):
    pred, target = label_maps(20 + nclass, (3, 31, 29), nclass)
    pred[0, 0, :4] = nclass + 2  # out-of-range predictions fall in no bin
    assert t_native.pix_acc(pred, target) == t_native.pix_acc_plain(pred, target)
    assert t_native.pix_acc(pred, target) == j_native.pix_acc(pred, target)
    got = t_native.hist_iou(pred, target, nclass)
    for want in (t_native.hist_iou_plain(pred, target, nclass),
                 j_native.hist_iou(pred, target, nclass)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_native_refuses_mismatched_inputs():
    with pytest.raises(ValueError, match="pixels"):
        t_native.pix_acc(np.zeros((4, 4), np.int64), np.zeros((4, 5), np.int64))
    with pytest.raises(ValueError, match="pixels"):
        t_native.hist_iou(np.zeros(6, np.int64), np.zeros(5, np.int64), 2)
    with pytest.raises(ValueError, match="nclass"):
        t_native.hist_iou(np.zeros(5, np.int64), np.zeros(5, np.int64), 0)
    with pytest.raises(ValueError, match=r"\[h, w\]"):
        t_native.nearest_resize(np.zeros((2, 3, 4)), 4, 4)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source the compiler refuses, or no compiler, raises: no numpy
    fallback."""
    bad = tmp_path / "eval_ops.cpp"
    bad.write_text("extern \"C\" { void nearest_resize_f32( }\n")
    monkeypatch.setattr(t_native, "SOURCE", bad)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_native.pix_acc(np.zeros(4, np.int64), np.zeros(4, np.int64))
    monkeypatch.setattr(t_native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(OSError):
        t_native.gaussian_blur3(np.zeros((4, 4), np.float32))
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_library_is_hash_named_beside_the_cuda_libraries():
    path = t_native.library_path()
    assert path.parent.name == "torch_kernels" and path.name.startswith("libeval_ops-")
    t_native.get_lib()
    assert path.exists()


@pytest.fixture()
def synthetic_mat(tmp_path):
    import h5py

    path = str(tmp_path / "gtsegs.mat")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        g = f.create_group("value")
        img_refs, gt_refs, name_refs = [], [], []
        for i in range(3):
            img = f.create_dataset(f"im{i}", data=rng.integers(0, 255, (3, 32, 24), dtype=np.uint8))
            img_refs.append(img.ref)
            mask = f.create_dataset(f"mk{i}", data=(rng.random((32, 24)) > 0.5).astype(np.uint8))
            cell = f.create_dataset(f"gc{i}", data=np.array([[mask.ref]], dtype=h5py.ref_dtype))
            gt_refs.append(cell.ref)
            name = f.create_dataset(
                f"nm{i}", data=np.array([ord(c) for c in f"gold-fish_{i}"], dtype=np.uint16))
            name_refs.append(name.ref)
        g.create_dataset("img", data=np.array(img_refs, dtype=h5py.ref_dtype))
        g.create_dataset("gt", data=np.array(gt_refs, dtype=h5py.ref_dtype))
        g.create_dataset("name", data=np.array(name_refs, dtype=h5py.ref_dtype))
    return path


def test_imagenet_segmentation_matches_jax(synthetic_mat, tmp_path):
    assert t_data.ImagenetSegmentation.available(synthetic_mat)
    assert not t_data.ImagenetSegmentation.available(str(tmp_path / "absent.mat"))
    got = t_data.ImagenetSegmentation(synthetic_mat, cache_dir=str(tmp_path / "t_cache"))
    want = j_data.ImagenetSegmentation(synthetic_mat, cache_dir=str(tmp_path / "j_cache"))
    assert len(got) == len(want) == 3
    for i in range(3):
        (gi, gm, gn), (wi, wm, wn) = got[i], want[i]
        assert gi.shape == (24, 32, 3) and gm.dtype == np.int64 and gn == wn == f"gold-fish_{i}"
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    again = t_data.ImagenetSegmentation(synthetic_mat, cache_dir=str(tmp_path / "t_cache"))
    assert again.rows == got.rows  # the cache is read, not rebuilt


def make_mini_voc(root, classes_per_image=(1, 2, 1, 0)):
    """A VOC2012 tree: images 20x30 whose masks hold bands of class ids
    3, 4, ... and a 255 border row."""
    import PIL.Image

    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    (root / "SegmentationClass").mkdir()
    (root / "JPEGImages").mkdir()
    rng = np.random.default_rng(1)
    ids = []
    for i, n_classes in enumerate(classes_per_image):
        image_id = f"2007_{i:06d}"
        ids.append(image_id)
        mask = np.zeros((20, 30), np.uint8)
        for c in range(n_classes):
            mask[5 * (c + 1): 5 * (c + 2)] = c + 3
        mask[0] = 255
        PIL.Image.fromarray(mask).save(root / "SegmentationClass" / f"{image_id}.png")
        img = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
        PIL.Image.fromarray(img).save(root / "JPEGImages" / f"{image_id}.jpg")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text("\n".join(ids))
    return str(root)


@pytest.fixture()
def mini_voc(tmp_path):
    return make_mini_voc(tmp_path / "VOC2012")


@pytest.mark.parametrize("kind", ["VOCSingleClassSegmentation", "VOCMultiClassSegmentation"])
def test_voc_loaders_match_jax(mini_voc, tmp_path, kind):
    assert getattr(t_data, kind).available(mini_voc)
    assert not getattr(t_data, kind).available(str(tmp_path))
    got, want = getattr(t_data, kind)(mini_voc), getattr(j_data, kind)(mini_voc)
    assert len(got) == len(want) == (2 if kind.startswith("VOCSingle") else 4)
    for i in range(len(got)):
        (gi, gm, gt), (wi, wm, wt) = got[i], want[i]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert gt == wt
    if kind.startswith("VOCMulti"):
        assert got.ids == want.ids and got[1][2] == ["bird", "boat"] and got[3][2] == []
    assert t_data.VOC_CLASSES == j_data.VOC_CLASSES
