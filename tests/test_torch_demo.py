"""The port's demos (`demo.py`, gradio; `demo_st.py`, streamlit) on the CPU.

Neither gradio nor streamlit is installed here, so each demo runs against a
stand-in module that records what the page builds: the gradio demo's click
handler, and the streamlit page's widgets, answered from a table. Each
handler runs flux-tiny on the CPU (f32, random weights from init_seed 0)
and is held, bit for bit, to a direct `generate_image` on a pipeline built
the same way. The gates raise SystemExit naming the CLI when the UI package
is missing. The NSFW gate is replaced by a recorder (its classifier needs
a download).
"""

import contextlib
import io
import sys
import types

import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline, demo, demo_st
from conceptattention_torch.utils import safety

torch.set_num_threads(2)  # six test workers share the host's cores

PROMPT = "a dragon standing on a rock"
SIZE, STEPS = 64, 2


@pytest.fixture(scope="module")
def direct():
    return ConceptAttentionFluxPipeline("flux-tiny", dtype=torch.float32, device="cpu")


def fake_gradio():
    """A stand-in gradio: components that take anything, Blocks / Row /
    Column as context managers, and a Button whose click is recorded."""
    gr = types.ModuleType("gradio")
    gr.clicks = []

    class Component:
        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Button(Component):
        def click(self, fn, inputs, outputs):
            gr.clicks.append((fn, inputs, outputs))

    for name in ("Blocks", "Markdown", "Row", "Column", "Textbox", "Slider", "Number", "Radio",
                 "Image", "Gallery"):
        setattr(gr, name, type(name, (Component,), {}))
    gr.Button = Button
    return gr


class FakeStreamlit(types.ModuleType):
    """A stand-in streamlit page: each widget returns its answer from
    `answers` (by label), else its default; output calls are recorded."""

    def __init__(self, answers):
        super().__init__("streamlit")
        self.answers, self.calls = answers, []

    def cache_resource(self):
        return lambda fn: fn

    def _answer(self, label, default):
        return self.answers.get(label, default)

    def selectbox(self, label, options):
        return self._answer(label, options[0])

    def checkbox(self, label, value=False):
        return self._answer(label, value)

    def file_uploader(self, label, type=None):
        return self._answer(label, None)

    def number_input(self, label, min_value=None, max_value=None, value=None, step=None,
                     disabled=False):
        return self._answer(label, value)

    def text_input(self, label, value=""):
        return self._answer(label, value)

    def button(self, label):
        return self._answer(label, False)

    def spinner(self, text):
        return contextlib.nullcontext()

    def columns(self, n):
        return [self] * n

    def __getattr__(self, name):  # title, write, warning, image, download_button
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *args, **kwargs: self.calls.append((name, args, kwargs))

    def called(self, name):
        return [(args, kwargs) for n, args, kwargs in self.calls if n == name]


@pytest.fixture
def screened(monkeypatch):
    """The NSFW gate as a recorder: every image it screens, passed as safe."""
    seen = []
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(safety, "is_safe", lambda image: seen.append(image) or True)
    return seen


def same_image(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("module,package,entry", [
    (demo, "gradio", lambda: demo.build_demo("flux-tiny", "cpu")),
    (demo_st, "streamlit", lambda: demo_st.main("cpu")),
], ids=["gradio", "streamlit"])
def test_gate_names_the_cli(monkeypatch, module, package, entry):
    monkeypatch.setitem(sys.modules, package, None)  # import raises ImportError
    with pytest.raises(SystemExit, match="python -m conceptattention_torch.cli"):
        entry()


def test_gradio_handler_matches_generate_image(monkeypatch, direct):
    gr = fake_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    demo.build_demo("flux-tiny", "cpu")
    ((generate, inputs, outputs),) = gr.clicks
    assert len(inputs) == 8 and len(outputs) == 2
    # schnell-style defaults for a model without guidance embedding
    assert inputs[4].kwargs["value"] == 4 and inputs[5].kwargs["value"] == 0.0
    image, gallery = generate(PROMPT, "dragon, rock, ", SIZE, SIZE, STEPS, 0.0, 3, "sparsemax")
    want = direct.generate_image(PROMPT, ["dragon", "rock"], width=SIZE, height=SIZE,
                                 num_inference_steps=STEPS, seed=3, softmax=False,
                                 attention_norm="sparsemax")
    same_image(image, want.image)
    assert [c for _, c in gallery] == ["dragon", "rock"]
    for (hm, _), want_hm in zip(gallery, want.concept_heatmaps):
        same_image(hm, want_hm)


PAGE = {"Which model to load?": "flux-tiny", "Load model": True, "Width": SIZE, "Height": SIZE,
        "Number of steps": STEPS, "Seed": 5, "Concepts (comma-separated)": "dragon, sky",
        "Attention norm": "softmax", "Prompt": PROMPT, "Sample": True}


def test_streamlit_page_matches_generate_image(monkeypatch, direct, screened):
    st = FakeStreamlit(dict(PAGE))
    monkeypatch.setitem(sys.modules, "streamlit", st)
    demo_st.main("cpu")
    want = direct.generate_image(PROMPT, ["dragon", "sky"], width=SIZE, height=SIZE,
                                 num_inference_steps=STEPS, seed=5, softmax=True,
                                 attention_norm="softmax", image2image_strength=0.0)
    images = st.called("image")
    assert len(images) == 3 and len(screened) == 1
    same_image(images[0][0][0], want.image)
    assert images[0][1]["caption"] == PROMPT
    for (args, kwargs), concept, hm in zip(images[1:], ["dragon", "sky"], want.concept_heatmaps):
        same_image(args[0], hm)
        assert kwargs["caption"] == concept
    ((args, kwargs),) = st.called("download_button")
    from PIL import Image
    from PIL.ExifTags import Base

    saved = Image.open(io.BytesIO(args[1]))
    same_image(saved, want.image)
    assert saved.getexif()[Base.ImageDescription] == PROMPT
    assert kwargs["file_name"] == "concept_attention.png"


def test_streamlit_image_to_image(monkeypatch, direct, screened):
    from PIL import Image

    init = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    upload = io.BytesIO()
    Image.fromarray(init).save(upload, format="PNG")
    upload.seek(0)
    st = FakeStreamlit(dict(PAGE, **{"Image to Image": True, "Input": upload,
                                     "Noising strength": 0.5,
                                     "Add sampling parameters to metadata?": False}))
    monkeypatch.setitem(sys.modules, "streamlit", st)
    demo_st.main("cpu")
    want = direct.generate_image(PROMPT, ["dragon", "sky"], width=SIZE, height=SIZE,
                                 num_inference_steps=STEPS, seed=5, init_image=init,
                                 image2image_strength=0.5)
    same_image(st.called("image")[0][0][0], want.image)
    assert st.called("write")[0][0][0].startswith(f"Got image of size {SIZE}x{SIZE}")
    assert st.called("download_button") == []


def test_streamlit_stops_before_sampling(monkeypatch, screened):
    """Unloaded, or loaded without the Sample button, the page builds no
    image; an unsafe image is withheld with a warning."""
    for answers in ({"Load model": False}, dict(PAGE, Sample=False)):
        st = FakeStreamlit(answers)
        monkeypatch.setitem(sys.modules, "streamlit", st)
        demo_st.main("cpu")
        assert st.called("image") == []
    monkeypatch.setattr(safety, "is_safe", lambda image: False)
    st = FakeStreamlit(dict(PAGE))
    monkeypatch.setitem(sys.modules, "streamlit", st)
    demo_st.main("cpu")
    assert st.called("image") == [] and "NSFW" in st.called("warning")[0][0][0]
