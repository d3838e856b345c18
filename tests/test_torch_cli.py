"""The port's CLI (`cli.py`, `python -m conceptattention_torch`), its BFL API
client (`api.py`) and its NSFW gate (`utils/safety.py`) on the CPU, held
against the JAX package's.

The CLI subprocesses run flux-tiny at 64x64 with `--device cpu` and
HF_HUB_OFFLINE=1, so the NSFW classifier, which is not in the local cache,
is unavailable without any network use and the CLI saves unscreened, as the
JAX CLI does. The API client is driven through a stand-in `requests`
module: no request leaves the process.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from conceptattention_torch import api as t_api
from conceptattention_torch import cli as t_cli
from conceptattention_torch.utils import safety as t_safety
from conceptattention_tpu import cli as j_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_ARGS = ["--model_name", "flux-tiny", "--device", "cpu", "--width", "64", "--height", "64",
            "--num_steps", "1"]


def _cli(args, tmp_path, stdin=None, timeout=300):
    env = dict(os.environ, HF_HUB_OFFLINE="1", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "conceptattention_torch", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=tmp_path,
                          input=stdin)


class TestParser:
    def test_defaults_match_jax(self):
        got = vars(t_cli.build_parser().parse_args([]))
        want = vars(j_cli.build_parser().parse_args([]))
        # the port adds --device; its backends are its own ("fused", "sdpa")
        assert got.pop("device") == "cuda"
        assert got.pop("attention_backend") == "fused"
        want.pop("attention_backend")
        assert got == want

    @pytest.mark.parametrize("argv", [
        ["--concepts", "a", "b", "--attention_norm", "sparsemax"],
        ["--no-add_sampling_metadata", "--no-nsfw_filter", "--loop"],
        ["--lora", "x.safetensors", "y.safetensors", "--lora_strength", "0.5", "1.5"],
        ["--quantize", "w8a8", "--int8_qk", "--layers", "0", "1", "--heatmap_dir", "hm"],
    ])
    def test_flags_parse_as_jax(self, argv):
        got = vars(t_cli.build_parser().parse_args(argv))
        want = vars(j_cli.build_parser().parse_args(argv))
        for key in ("device", "attention_backend"):
            got.pop(key)
            want.pop(key, None)
        assert got == want

    def test_rejects_jax_backends(self):
        with pytest.raises(SystemExit):
            t_cli.build_parser().parse_args(["--attention_backend", "pallas"])


class TestExif:
    @pytest.mark.parametrize("meta", [True, False])
    def test_exif_matches_jax(self, meta):
        from PIL.ExifTags import Base

        got = t_cli._exif_for("flux-schnell", "a dragon", add_sampling_metadata=meta)
        want = j_cli._exif_for("flux-schnell", "a dragon", add_sampling_metadata=meta)
        assert dict(got) == dict(want)
        assert got[Base.Software] == "AI generated;txt2img;flux"
        assert got[Base.Make] == "Black Forest Labs" and got[Base.Model] == "flux-schnell"
        assert (Base.ImageDescription in got) == meta

    def test_exif_roundtrip_through_png(self, tmp_path):
        import PIL.Image
        from PIL.ExifTags import Base

        img = PIL.Image.new("RGB", (8, 8), (10, 20, 30))
        img.save(tmp_path / "img.png", exif=t_cli._exif_for("flux-schnell", "roundtrip", True))
        back = PIL.Image.open(tmp_path / "img.png").getexif()
        assert back[Base.Model] == "flux-schnell" and back[Base.ImageDescription] == "roundtrip"


class TestCliEndToEnd:
    def test_writes_image_and_one_heatmap_per_concept(self, tmp_path):
        """One image and one PNG per concept; the classifier is unavailable
        offline, so the CLI says so and saves unscreened."""
        import PIL.Image
        from PIL.ExifTags import Base

        r = _cli([*CLI_ARGS, "--prompt", "a cat", "--concepts", "cat", "blue sky",
                  "--output", "out.png", "--heatmap_dir", "hm"], tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "NSFW classifier unavailable" in r.stdout
        img = PIL.Image.open(tmp_path / "out.png")
        assert img.size == (64, 64) and img.getexif()[Base.ImageDescription] == "a cat"
        assert sorted(os.listdir(tmp_path / "hm")) == ["blue_sky.png", "cat.png"]
        assert PIL.Image.open(tmp_path / "hm" / "cat.png").size == (16, 16)
        launches = json.loads(r.stdout.split("kernel launches ", 1)[1].splitlines()[0])
        from conceptattention_torch.kernels import launch_counts

        # every count of kernels.launch_counts, the K1 instances' included: 0 on the CPU
        assert launches == {k: 0 for k in launch_counts()}
        assert {"flash_saliency", "flash_saliency_int8", "flash_saliency_paired", "conv3x3",
                "ring_attention", "flash_saliency (Hopper instance)",
                "conv3x3 (Hopper instance)"} <= set(launches)

    def test_loop_reads_prompts_and_lora(self, tmp_path):
        """--loop: one image per prompt read from stdin (a fresh seed after
        the first), the default heatmap directory beside the output, and a
        LoRA file merged at load."""
        from test_torch_serving import write_adapter

        from conceptattention_torch.config import configs

        lora = write_adapter(tmp_path / "a.safetensors", configs["flux-tiny"].params)
        r = _cli([*CLI_ARGS, "--loop", "--output", "loop.png", "--lora", lora,
                  "--lora_strength", "0.5", "--no-nsfw_filter"], tmp_path,
                 stdin="a red fox\nfox snow\na boat\n\nq\n")
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.count("wrote loop.png in") == 2 and "seed: " in r.stdout
        assert sorted(os.listdir(tmp_path / "loop_heatmaps")) == ["fox.png", "snow.png"]

    def test_bad_size_fails_before_the_model(self, tmp_path):
        r = _cli([*CLI_ARGS[:4], "--width", "100"], tmp_path)
        assert r.returncode == 2 and "multiples of 16" in r.stderr

    def test_default_device_is_the_card(self, monkeypatch):
        """Without `--device` the CLI builds its pipeline on the card and,
        without one, raises rather than carrying on on the CPU."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cli.main(["--model_name", "flux-tiny", "--width", "64", "--height", "64"])


# ---------------------------------------------------------------------------
class _Response:
    def __init__(self, status, payload=None, content=b""):
        self.status_code, self._payload, self.content = status, payload, content

    def json(self):
        return self._payload


@pytest.fixture
def fake_requests(monkeypatch):
    """A stand-in `requests` module that answers like api.bfl.ml: a request
    id, one "Pending" poll, then "Ready" with a sample URL; it records calls."""
    calls = []
    polls = iter([{"status": "Pending"}, {"status": "Ready",
                                          "result": {"sample": "https://x/img.jpg?sig=1"}}])

    def post(url, headers=None, json=None):
        calls.append(("post", url, headers, json))
        return _Response(200, {"id": "req-1"})

    def get(url, headers=None, params=None):
        calls.append(("get", url, headers, params))
        if url.endswith("/v1/get_result"):
            return _Response(200, next(polls))
        return _Response(200, content=b"jpeg-bytes")

    mod = types.SimpleNamespace(post=post, get=get)
    monkeypatch.setitem(sys.modules, "requests", mod)
    monkeypatch.setattr(t_api.time, "sleep", lambda s: None)
    return calls


class TestApiClient:
    def test_validation_without_network(self):
        with pytest.raises(ValueError):
            t_api.ImageRequest("x", name="nope", launch=False)
        with pytest.raises(ValueError):
            t_api.ImageRequest("x", width=100, launch=False)  # not a multiple of 32
        req = t_api.ImageRequest("a dragon", name="flux.1-dev", launch=False)
        assert req.request_json["prompt"] == "a dragon" and req.request_id is None

    def test_request_json_matches_jax(self):
        from conceptattention_tpu import api as j_api

        kw = dict(name="flux.1-pro", width=512, height=768, steps=20, seed=3, launch=False)
        assert t_api.ImageRequest("a fox", **kw).request_json == \
            j_api.ImageRequest("a fox", **kw).request_json
        assert t_api.API_ENDPOINTS == j_api.API_ENDPOINTS and t_api.API_URL == j_api.API_URL

    def test_submit_poll_and_save(self, fake_requests, tmp_path, monkeypatch):
        monkeypatch.setenv("BFL_API_KEY", "k")
        req = t_api.ImageRequest("a fox", name="flux.1-dev", seed=1)
        assert req.request_id == "req-1"
        kind, url, headers, body = fake_requests[0]
        assert (kind, url) == ("post", f"{t_api.API_URL}/v1/flux-dev")
        assert headers["x-key"] == "k" and body == {"prompt": "a fox", "width": 1024,
                                                     "height": 1024, "seed": 1,
                                                     "prompt_upsampling": False,
                                                     "safety_tolerance": 6}
        req.save(str(tmp_path / "out"))
        assert (tmp_path / "out.jpg").read_bytes() == b"jpeg-bytes"
        assert [c[0] for c in fake_requests] == ["post", "get", "get", "get"]

    def test_error_status_raises(self, monkeypatch):
        mod = types.SimpleNamespace(post=lambda *a, **k: _Response(403, {"detail": "bad key"}))
        monkeypatch.setitem(sys.modules, "requests", mod)
        with pytest.raises(t_api.ApiException, match="403") as e:
            t_api.ImageRequest("x")
        assert e.value.status_code == 403 and e.value.detail == "bad key"


# ---------------------------------------------------------------------------
class TestSafety:
    @pytest.fixture(autouse=True)
    def fresh(self, monkeypatch):
        monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        monkeypatch.setattr(t_safety, "_classifier", None)
        monkeypatch.setattr(t_safety, "_unavailable_reason", None)

    def test_offline_is_permissive_with_reason(self):
        import PIL.Image

        from conceptattention_tpu.utils import safety as j_safety

        img = PIL.Image.new("RGB", (16, 16))
        score = t_safety.nsfw_score(img)
        if t_safety.classifier_available():
            assert 0.0 <= score <= 1.0
        else:
            assert score == 0.0 and t_safety.unavailable_reason()
        assert t_safety.is_safe(img) == (score < t_safety.NSFW_THRESHOLD)
        assert t_safety.NSFW_THRESHOLD == j_safety.NSFW_THRESHOLD == 0.85

    def test_scores_through_a_loaded_classifier(self, monkeypatch):
        """With a classifier in place, the "nsfw" label's score decides."""
        monkeypatch.setattr(t_safety, "_classifier",
                            lambda image: [{"label": "normal", "score": 0.1},
                                           {"label": "nsfw", "score": 0.9}])
        assert t_safety.classifier_available()
        assert t_safety.nsfw_score(None) == 0.9 and not t_safety.is_safe(None)
        assert t_safety.is_safe(None, threshold=0.95)

    def test_import_leaves_out_transformers(self):
        code = ("import sys, conceptattention_torch.utils.safety, conceptattention_torch.api, "
                "conceptattention_torch.cli; "
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('transformers', 'requests', 'huggingface_hub', 'PIL')]; "
                "print(bad); sys.exit(1 if bad else 0)")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=ROOT)
        assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_heatmaps_match_the_pipelines(tmp_path):
    """The heatmap PNGs the CLI writes are `heatmaps_to_pil` of the
    pipeline's maps for the same call (one colormap lookup, no matplotlib
    needed for plasma)."""
    import PIL.Image
    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.pipeline.heatmaps import heatmaps_to_pil

    r = _cli([*CLI_ARGS, "--prompt", "a cat", "--concepts", "cat", "sky", "--seed", "5",
              "--output", "o.png", "--no-nsfw_filter"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    pipe = ConceptAttentionFluxPipeline("flux-tiny", dtype=torch.float32, device="cpu")
    out = pipe.generate_image("a cat", ["cat", "sky"], width=64, height=64,
                              num_inference_steps=1, seed=5, softmax=True,
                              guidance=3.5 if pipe.cfg.guidance_embed else 0.0,
                              attention_norm="softmax", return_pil_heatmaps=False)
    for concept, want in zip(["cat", "sky"], heatmaps_to_pil(out.concept_heatmaps)):
        got = np.asarray(PIL.Image.open(tmp_path / "o_heatmaps" / f"{concept}.png"))
        np.testing.assert_array_equal(got, np.asarray(want))
