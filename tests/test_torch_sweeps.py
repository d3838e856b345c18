"""The port's per-layer and per-timestep segmentation sweeps and their plots.

Both sweeps run against the JAX package's scripts on the same flux-tiny
checkpoint files (`FLUX_TINY` / `AE_TINY`, as `tests/test_torch_eval_harness.py`
writes them) and a synthetic gtsegs `.mat`, in f32, with the seed-keyed
numpy noise of `tests/test_torch_segmentation.py` in place of each package's
noise and the VAE's posterior mean: the JAX scripts in one subprocess, the
port in this process. Their CSVs must agree to 4 decimals (2e-4: one
flipped mask token moves pixAcc by about 0.02 here). The plot helpers run
headless from a CSV, as `tests/test_misc.py::TestSweepPlots` runs the JAX
package's.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_eval_harness import CPU, ROOT, checkpoint, make_mat  # noqa: F401 (fixture)
from test_torch_segmentation import inject_noise

from conceptattention_torch.experiments import per_layer_segmentation as t_layer
from conceptattention_torch.experiments import per_timestep_segmentation as t_time
from conceptattention_torch.experiments import plot_segmentations_per_layer as t_plot_layer
from conceptattention_torch.experiments import plot_segmentations_per_time as t_plot_time
from conceptattention_torch.pipeline import concept_pipeline as t_pipe
from conceptattention_torch.utils.sweep_plots import plot_sweep_csv, read_sweep_csv

torch.set_num_threads(2)  # six test workers share the host's cores

CSV_TOL = 2e-4
TINY = ["--model_name", "flux-tiny", "--width", "32", "--label_size", "40"]
LAYER_ARGS = [*TINY, "--num_steps", "2", "--noise_timestep", "1"]
TIME_ARGS = [*TINY, "--num_steps", "4", "--timesteps", "0", "2", "3", "--layers", "0", "1"]

# Both JAX sweeps with their pipeline in f32, encoding to the posterior
# mean, and the seed-keyed numpy noise.
JAX_SWEEPS = """
import sys
import jax.numpy as jnp
import pytest
import conceptattention_tpu as cat
from test_torch_segmentation import inject_noise

inject_noise(pytest.MonkeyPatch())


class F32Pipeline(cat.ConceptAttentionFluxPipeline):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, dtype=jnp.float32, **kwargs)

    def _encode_pixels(self, image, height, width, seed, sample=True):
        return super()._encode_pixels(image, height, width, seed, sample=False)


cat.ConceptAttentionFluxPipeline = F32Pipeline
import test_segmentations_per_layer
import test_segmentations_per_time

mat, layer_csv, time_csv, n_layer = sys.argv[1:5]
layer_args, time_args = sys.argv[5:5 + int(n_layer)], sys.argv[5 + int(n_layer):]
sys.argv = ["per_layer", "--mat_path", mat, "--output_csv", layer_csv, *layer_args]
test_segmentations_per_layer.main()
sys.argv = ["per_time", "--mat_path", mat, "--output_csv", time_csv, *time_args]
test_segmentations_per_time.main()
"""


def read_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], np.float64)


@pytest.fixture
def port_noise(monkeypatch):
    """The numpy noise and the posterior-mean encode in the port."""
    inject_noise(monkeypatch)
    batch = t_pipe.ConceptAttentionFluxPipeline._encode_pixels_batch
    monkeypatch.setattr(t_pipe.ConceptAttentionFluxPipeline, "_encode_pixels_batch",
                        lambda self, images, h, w, seeds, sample=True: batch(self, images, h, w,
                                                                             seeds, False))


def test_sweeps_match_jax(tmp_path, checkpoint, monkeypatch, port_noise, capsys):  # noqa: F811
    mat = make_mat(str(tmp_path / "gtsegs.mat"))
    want_layer, want_time = str(tmp_path / "jax_layer.csv"), str(tmp_path / "jax_time.csv")
    env = dict(os.environ, JAX_PLATFORMS="cpu", **checkpoint,
               JAX_COMPILATION_CACHE_DIR=os.path.join(ROOT, ".jax_cache"),
               PYTHONPATH=os.pathsep.join([
                   ROOT, os.path.join(ROOT, "tests"),
                   os.path.join(ROOT, "experiments", "per_layer_segmentation"),
                   os.path.join(ROOT, "experiments", "per_timestep_segmentation")]))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SWEEPS, mat, want_layer, want_time, str(len(LAYER_ARGS)),
         *LAYER_ARGS, *TIME_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    for name, path in checkpoint.items():
        monkeypatch.setenv(name, path)
    got_layer, got_time = str(tmp_path / "layer.csv"), str(tmp_path / "time.csv")
    assert t_layer.main(["--mat_path", mat, "--output_csv", got_layer, *LAYER_ARGS, *CPU]) == 0
    assert t_time.main(["--mat_path", mat, "--output_csv", got_time, *TIME_ARGS, *CPU]) == 0
    out = capsys.readouterr().out
    assert out.count("[3/3] dog-2_x") == 2 and f"wrote {got_layer}" in out
    _, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, err[-3000:]
    for got, want, x_col, xs in ((got_layer, want_layer, "layer", [0, 1]),
                                 (got_time, want_time, "timestep", [0, 2, 3])):
        (g_head, g), (w_head, w) = read_rows(got), read_rows(want)
        assert g_head == w_head == [x_col, "pix_acc", "miou"]
        assert g[:, 0].tolist() == xs and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=CSV_TOL, err_msg=x_col)


def test_per_layer_rows_are_one_layer_scores(tmp_path):
    """A sweep row is the score of a one-layer model over the same images
    (one forward's per-layer maps are the one-layer calls' maps)."""
    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.evals.datasets import ImagenetSegmentation
    from conceptattention_torch.evals.segmentation import FluxTapSegmentationModel

    dataset = ImagenetSegmentation(make_mat(str(tmp_path / "gtsegs.mat")))
    pipe = ConceptAttentionFluxPipeline("flux-tiny", dtype=torch.float32, device="cpu")
    kw = dict(num_steps=2, noise_timestep=1, width=32, height=32)
    rows = t_layer.run(FluxTapSegmentationModel(pipe, **kw), dataset, 3, label_size=40)
    models = {l: FluxTapSegmentationModel(pipe, layer_indices=[l], **kw) for l in (0, 1)}
    for layer, model in models.items():
        stats = t_layer.new_stats()
        for image, gt_mask, name in dataset:
            target = t_layer.target_of(name)
            (mask,), _, _ = model([image], [target], [target, *t_layer.SWEEP_BACKGROUND],
                                  [target])
            t_layer.score_mask(stats, mask, t_layer.label_of(gt_mask, 40))
        assert rows[layer] == (layer, *t_layer.metrics(stats))


def test_sweep_gates(tmp_path, capsys):
    absent = ["--mat_path", str(tmp_path / "absent.mat"), *CPU]
    assert t_layer.main(absent) == 2
    assert t_time.main(absent) == 2
    assert capsys.readouterr().err.count("dataset not found") == 2
    args = t_time.parse_args(absent)
    assert (args.model_name, args.num_steps, args.timesteps, args.layers) == (
        "flux-dev", 50, None, [14, 15, 16, 17])
    assert t_layer.parse_args(absent).model_name == "flux-schnell"


def write_sweep_csv(path, x_col):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([x_col, "pix_acc", "miou"])
        for i in range(5):
            w.writerow([i, 0.5 + 0.05 * i, 0.3 + 0.04 * i])


class TestSweepPlots:
    """The cases of `tests/test_misc.py::TestSweepPlots`."""

    def test_plot_sweep_csv(self, tmp_path):
        csv_path = str(tmp_path / "per_layer_metrics.csv")
        write_sweep_csv(csv_path, "layer")
        cols = read_sweep_csv(csv_path)
        assert cols["layer"] == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert cols["miou"] == pytest.approx([0.3, 0.34, 0.38, 0.42, 0.46])
        png = plot_sweep_csv(csv_path, str(tmp_path / "out.png"), x_col="layer")
        assert os.path.getsize(png) > 1000  # a real PNG, not an empty file

    def test_plot_scripts_run(self, tmp_path, capsys):
        for main, x_col in ((t_plot_layer.main, "layer"), (t_plot_time.main, "timestep")):
            csv_path = str(tmp_path / f"{x_col}.csv")
            write_sweep_csv(csv_path, x_col)
            out = str(tmp_path / f"{x_col}.png")
            assert main(["--csv", csv_path, "--out", out]) == 0
            assert os.path.getsize(out) > 1000
            assert main(["--csv", csv_path]) == 0  # the PNG beside the CSV by default
            assert os.path.exists(str(tmp_path / f"{x_col}.png"))
        assert capsys.readouterr().out.count("wrote") == 4

    def test_sweep_plot_flag(self, tmp_path, monkeypatch):
        """`--plot` writes the PNG beside the CSV after the sweep."""
        monkeypatch.setattr(t_layer, "run", lambda *a, **k: [(0, 0.5, 0.25), (1, 0.75, 0.5)])
        mat = make_mat(str(tmp_path / "gtsegs.mat"), n=1)
        out = str(tmp_path / "sweep.csv")
        assert t_layer.main(["--mat_path", mat, "--output_csv", out, "--plot", *TINY, *CPU]) == 0
        assert read_sweep_csv(out) == {"layer": [0.0, 1.0], "pix_acc": [0.5, 0.75],
                                       "miou": [0.25, 0.5]}
        assert os.path.getsize(str(tmp_path / "sweep.png")) > 1000
