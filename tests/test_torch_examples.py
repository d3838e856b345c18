"""The port's quickstarts (`conceptattention_torch/examples/`) on the CPU.

Each script runs as a user runs it, a plain `python <script>` in a fresh
working directory, on flux-tiny on the CPU (`--device cpu`, and `--tiny`
where the script's default model is flux-schnell), and is held to its exit
code, what it prints and the files it writes. `fsdp_train.py` is held as
`tests/test_fsdp.py` holds the JAX package's: exit 0 and `done: final
loss`.
"""

import os
import subprocess
import sys

import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "conceptattention_torch", "examples")
CONCEPTS = ["dragon", "rock", "sky", "cloud"]


def run(script, *args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    result = subprocess.run([sys.executable, os.path.join(EXAMPLES, script), *args],
                            capture_output=True, text=True, timeout=600, cwd=cwd, env=env)
    assert result.returncode == 0, result.stdout[-2000:] + result.stderr[-2000:]
    return result.stdout


def test_generated_then_encoded_image(tmp_path):
    out = run("example_generated_image.py", "--tiny", "--device", "cpu", cwd=tmp_path)
    assert "wrote generated_image.png" in out
    assert Image.open(tmp_path / "generated_image.png").size == (64, 64)
    for c in CONCEPTS:
        assert (tmp_path / f"{c}_heatmap.png").exists()
    out = run("example_encoded_image.py", "generated_image.png", "--tiny", "--device", "cpu",
              cwd=tmp_path)
    assert "wrote per-concept heatmaps for generated_image.png" in out
    for c in CONCEPTS:
        assert (tmp_path / f"encoded_{c}_heatmap.png").exists()


def test_int8_serving(tmp_path):
    out = run("int8_serving.py", "--tiny", "--device", "cpu", cwd=tmp_path)
    assert "wrote 2 images + 4 heatmaps each" in out
    for i in range(2):
        assert Image.open(tmp_path / f"int8_image_{i}.png").size == (64, 64)
        for c in CONCEPTS:
            assert (tmp_path / f"int8_{i}_{c}.png").exists()


def test_lora_finetune(tmp_path):
    from conceptattention_torch.config import configs
    from conceptattention_torch.weights.convert import load_safetensors
    from conceptattention_torch.weights.lora import convert_lora_state_dict

    adapter = tmp_path / "lora.safetensors"
    out = run("lora_finetune.py", "--steps", "3", "--rank", "4", "--out", str(adapter),
              "--device", "cpu", cwd=tmp_path)
    lines = out.splitlines()
    assert lines[0].startswith("step    0  loss") and lines[1].startswith("step    2  loss")
    assert f"to {adapter}" in out and "generated (64, 64) image with 2 concept heatmaps" in out
    # the file reads back to adapters whose B factors trained away from zero
    tree = convert_lora_state_dict(load_safetensors(str(adapter)), configs["flux-tiny"].params)
    assert any(f["b"].abs().max() > 0 for stack in tree.values() for f in stack.values())


def test_fsdp_train_runs_headless(tmp_path):
    out = run("fsdp_train.py", "--steps", "2", "--data", "2", "--model", "2", "--batch", "4",
              "--device", "cpu", cwd=tmp_path)
    assert "mesh: data=2 (FSDP+DP) x model=2 (TP) on one cpu" in out
    assert "done: final loss" in out


def test_multichip_inference_on_a_virtual_mesh(tmp_path):
    out = run("multichip_inference.py", "--tiny", "--device", "cpu", "--data", "1", "--model",
              "2", "--steps", "2", cwd=tmp_path)
    assert "mesh: data=1 model=2 over 1 device(s) (2 ranks sharing them)" in out
    assert "wrote multichip_output.png with 3 heatmaps" in out
    assert Image.open(tmp_path / "multichip_output.png").size == (64, 64)
