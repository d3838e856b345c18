"""The port's eval harnesses on the CPU, and against the JAX package's.

`python -m conceptattention_torch.experiments.imagenet_segmentation` runs
and resumes on a synthetic gtsegs .mat, as `tests/test_imagenet_seg_harness.py`
checks the JAX script; the VOC runners run on the mini VOC tree of
`tests/test_torch_evals.py`. Then both packages' ImageNet harnesses run on the
same flux-tiny checkpoint files (`FLUX_TINY` / `AE_TINY`, written as
`tests/test_torch_convert.py` writes them) in f32, with the seed-keyed numpy
noise of `tests/test_torch_segmentation.py` in place of each package's noise
and the VAE's posterior mean: the JAX script in one subprocess (batch 1 and
2 in turn), the port in this process. Their FINAL pixAcc, mIoU and mAP, printed
to 4 decimals, must agree within 2e-4 (the printed rounding of values equal
to 1e-5; one flipped mask token moves pixAcc by about 0.02 here).
"""

import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from safetensors.torch import save_file
from test_torch_convert import ae_state_dict, flux_state_dict
from test_torch_evals import make_mini_voc
from test_torch_segmentation import inject_noise

from conceptattention_torch.config import configs
from conceptattention_torch.experiments import imagenet_segmentation as t_imagenet
from conceptattention_torch.experiments import voc_multi_class, voc_single_class
from conceptattention_torch.pipeline import concept_pipeline as t_pipe

torch.set_num_threads(2)  # six test workers share the host's cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL_TOL = 2e-4
CPU = ["--device", "cpu", "--dtype", "float32"]
TINY = ["--model_name", "flux-tiny", "--width", "32", "--label_size", "40", "--num_steps", "2",
        "--noise_timestep", "1", "--layers", "0", "1"]


def make_mat(path, n=3):
    """A gtsegs-style .mat of n random 40x48 images with masks."""
    import h5py

    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        g = f.create_group("value")
        img_refs, gt_refs, name_refs = [], [], []
        for i in range(n):
            img = f.create_dataset(f"im{i}", data=rng.integers(0, 255, (3, 40, 48), dtype=np.uint8))
            mask = f.create_dataset(f"m{i}", data=(rng.random((40, 48)) > 0.5).astype(np.uint8))
            gc = f.create_dataset(f"gc{i}", data=np.array([[mask.ref]], dtype=h5py.ref_dtype))
            name = f.create_dataset(
                f"nm{i}", data=np.array([ord(c) for c in f"dog-{i}_x"], dtype=np.uint16))
            img_refs.append(img.ref)
            gt_refs.append(gc.ref)
            name_refs.append(name.ref)
        g.create_dataset("img", data=np.array(img_refs, dtype=h5py.ref_dtype))
        g.create_dataset("gt", data=np.array(gt_refs, dtype=h5py.ref_dtype))
        g.create_dataset("name", data=np.array(name_refs, dtype=h5py.ref_dtype))
    return path


def final_numbers(text):
    lines = re.findall(r"^FINAL (.*)$", text, re.M)
    return [dict(zip(line.split()[::2], map(float, line.split()[1::2]))) for line in lines]


def test_imagenet_harness_runs_and_resumes(tmp_path, capsys):
    mat = make_mat(str(tmp_path / "gtsegs.mat"))
    state = str(tmp_path / "state.json")
    base = ["--mat_path", mat, *TINY, *CPU, "--state_path", state]
    assert t_imagenet.main(base + ["--num_images", "1"]) == 0
    st = json.load(open(state))
    assert st["next_index"] == 1 and st["labeled"] > 0
    assert t_imagenet.main(base + ["--num_images", "3", "--image_batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "resuming from image 1" in out
    run2 = out.split("resuming")[1]
    assert "[1/3]" not in run2 and "[2/3]" in run2 and "[3/3]" in run2 and "FINAL" in run2
    assert json.load(open(state))["next_index"] == 3


def test_imagenet_harness_gates(tmp_path, capsys, monkeypatch):
    assert t_imagenet.main(["--mat_path", str(tmp_path / "absent.mat"), *CPU]) == 2
    assert "dataset not found" in capsys.readouterr().err
    # DAAMSD2 passes the gate and runs (the zoo's tiny UNet, random weights)
    from conceptattention_torch.evals import model_zoo

    monkeypatch.delenv("SD2_UNET", raising=False)
    monkeypatch.setattr(model_zoo, "build_segmentation_model",
                        functools.partial(model_zoo.build_segmentation_model, tiny=True))
    mat = make_mat(str(tmp_path / "gtsegs.mat"), n=2)
    assert t_imagenet.main(["--mat_path", mat, *CPU, "--segmentation_model", "DAAMSD2",
                            "--random_weights"]) == 0
    assert len(final_numbers(capsys.readouterr().out)) == 1


def test_image_groups_split_on_concept_count():
    """A batch closes early where an image's concept list has another length
    (the target is one of the background concepts)."""
    image = np.zeros((4, 4, 3), np.uint8)
    names = ["dog_1", "cat_2", "sky_3", "tree_4", "dog_5"]
    dataset = [(image, np.zeros((4, 4)), n) for n in names]
    groups = list(t_imagenet.image_groups(dataset, 0, 5, 4))
    assert [[g[0] for g in group] for group in groups] == [[0, 1], [2, 3], [4]]
    assert groups[1][0][4] == ["sky", "background", "floor", "grass", "tree"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    spec = configs["flux-tiny"]
    root = tmp_path_factory.mktemp("ckpt")
    flux = {k: v.to(torch.bfloat16) for k, v in flux_state_dict(spec.params, seed=1).items()}
    save_file(flux, str(root / "flux-tiny.safetensors"))
    save_file(ae_state_dict(spec.ae_params, seed=2), str(root / "ae-tiny.safetensors"))
    return {"FLUX_TINY": str(root / "flux-tiny.safetensors"),
            "AE_TINY": str(root / "ae-tiny.safetensors")}


# The JAX script with its pipeline in f32, encoding to the posterior mean,
# and the seed-keyed numpy noise; run once per --image_batch.
JAX_HARNESS = """
import sys
import jax.numpy as jnp
import pytest
import conceptattention_tpu as cat
from test_torch_segmentation import inject_noise

inject_noise(pytest.MonkeyPatch())


class F32Pipeline(cat.ConceptAttentionFluxPipeline):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, dtype=jnp.float32, **kwargs)

    def _encode_pixels_batch(self, images, height, width, seed, sample=True):
        return super()._encode_pixels_batch(images, height, width, seed, sample=False)

    def _encode_pixels(self, image, height, width, seed, sample=True):
        return super()._encode_pixels(image, height, width, seed, sample=False)


cat.ConceptAttentionFluxPipeline = F32Pipeline
import run_experiment

args = sys.argv[1:]
for batch in ("1", "2"):
    sys.argv = ["run_experiment.py", *args, "--image_batch", batch]
    run_experiment.main()
"""


def test_imagenet_harness_matches_jax(tmp_path, checkpoint, monkeypatch, capsys):
    mat = make_mat(str(tmp_path / "gtsegs.mat"))
    args = ["--mat_path", mat, *TINY]
    env = dict(os.environ, JAX_PLATFORMS="cpu", **checkpoint,
               JAX_COMPILATION_CACHE_DIR=os.path.join(ROOT, ".jax_cache"),
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests"),
                                           os.path.join(ROOT, "experiments",
                                                        "imagenet_segmentation")]))
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_HARNESS, *args], cwd=ROOT, env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, path in checkpoint.items():
        monkeypatch.setenv(name, path)
    inject_noise(monkeypatch)
    batch = t_pipe.ConceptAttentionFluxPipeline._encode_pixels_batch
    monkeypatch.setattr(t_pipe.ConceptAttentionFluxPipeline, "_encode_pixels_batch",
                        lambda self, images, h, w, seeds, sample=True: batch(self, images, h, w,
                                                                             seeds, False))
    for image_batch in ("1", "2"):
        assert t_imagenet.main([*args, *CPU, "--image_batch", image_batch]) == 0
    got = final_numbers(capsys.readouterr().out)
    out, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-3000:]
    want = final_numbers(out)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"pixAcc", "mIoU", "mAP"}
        for key in g:
            assert abs(g[key] - w[key]) <= FINAL_TOL, (key, got, want)


def test_voc_runners(tmp_path, capsys):
    voc = make_mini_voc(tmp_path / "VOC2012")
    state = str(tmp_path / "voc_state.json")
    base = ["--voc_root", voc, *TINY, "--label_size", "20", *CPU, "--state_path", state]
    assert voc_single_class.main(base + ["--num_images", "1"]) == 0
    assert json.load(open(state))["next_index"] == 1
    assert voc_single_class.main(base + ["--num_images", "2"]) == 0
    out = capsys.readouterr().out
    assert "resuming from image 1" in out and "[2/2]" in out and "FINAL pixAcc" in out
    assert voc_multi_class.main(["--voc_root", voc, *TINY, "--label_size", "20", *CPU]) == 0
    out = capsys.readouterr().out
    assert "[3]" in out and "[4]" not in out  # the background-only image is skipped
    (final,) = re.findall(r"^FINAL mIoU (\S+) pixAcc (\S+)$", out, re.M)
    assert all(0.0 <= float(x) <= 1.0 for x in final)
    assert voc_single_class.main(["--voc_root", str(tmp_path / "absent"), *CPU]) == 2
    assert voc_multi_class.main(["--voc_root", str(tmp_path / "absent"), *CPU]) == 2
