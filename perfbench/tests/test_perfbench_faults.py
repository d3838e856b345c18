"""A whole run of each cell, shrunk to the program's tiny presets on the
CPU in float32 (the harness's look for a card left out), with the timed
path broken underneath in each way the cell can break: the check has to
read `correct` false. (No cell spans chips, so no exchange between chips
can be left out.) The unbroken run reads true, and each cell's control,
the reference in float8 in the program's place, reads false."""

import time

import pytest

from perfbench import harness
from perfbench.tests.tiny import OVERRIDES

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
GENERATE, ENCODE, VIDEO = ("flux-schnell.generate-1024-b4", "flux-schnell.encode-512-b8",
                           "cogvideox-5b.denoise-49f")


def _run(cell, variant="program"):
    over = OVERRIDES[cell]
    over = {**over, "config": {**over["config"], "dtype": "float32"}}
    result, _ = harness.run_cell(BENCH, cell, 2**31 + 99, 0.2, False, time.perf_counter(),
                                 device="cpu", variant=variant, overrides=over,
                                 log=lambda msg: None)
    return result


def _half_batch(monkeypatch, cls, method):
    """Only the first half of each call's batch is computed; the second half
    gets copies of the first half's answers."""
    orig = getattr(cls, method)

    def broken(self, items, *args, **kwargs):
        n, half = len(items), max(1, len(items) // 2)

        def cut(v):
            return v[:half] if isinstance(v, list) and len(v) == n else v

        outs = orig(self, items[:half], *map(cut, args), **{k: cut(v) for k, v in kwargs.items()})
        return [outs[i % half] for i in range(n)]

    monkeypatch.setattr(cls, method, broken)


def _altered_maps(monkeypatch):
    from conceptattention_torch.pipeline import concept_pipeline as cp

    orig = cp.reduce_maps
    monkeypatch.setattr(cp, "reduce_maps", lambda *a, **k: orig(*a, **k) + 0.05)


@pytest.mark.parametrize("cell", [GENERATE, ENCODE, VIDEO])
def test_unbroken_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", [GENERATE, ENCODE, VIDEO])
def test_control_is_not_correct(cell):
    assert not _run(cell, variant="control")["correct"]


def test_generate_step_returns_its_state(monkeypatch):
    from conceptattention_torch.pipeline import concept_pipeline as cp

    orig = cp.denoise
    monkeypatch.setattr(cp, "denoise", lambda params, cfg, img, *a, **k:
                        (img, orig(params, cfg, img, *a, **k)[1]))
    assert not _run(GENERATE)["correct"]


def test_generate_half_batch(monkeypatch):
    from conceptattention_torch.pipeline.concept_pipeline import ConceptAttentionFluxPipeline

    _half_batch(monkeypatch, ConceptAttentionFluxPipeline, "generate_images")
    assert not _run(GENERATE)["correct"]


def test_generate_answer_altered(monkeypatch):
    _altered_maps(monkeypatch)
    assert not _run(GENERATE)["correct"]


def test_encode_noising_step_returns_its_input(monkeypatch):
    from conceptattention_torch.pipeline import concept_pipeline as cp

    monkeypatch.setattr(cp, "forward_noise", lambda x, noise, t: x.to(noise.dtype))
    assert not _run(ENCODE)["correct"]


def test_encode_half_batch(monkeypatch):
    from conceptattention_torch.pipeline.concept_pipeline import ConceptAttentionFluxPipeline

    _half_batch(monkeypatch, ConceptAttentionFluxPipeline, "encode_images")
    assert not _run(ENCODE)["correct"]


def test_encode_answer_altered(monkeypatch):
    _altered_maps(monkeypatch)
    assert not _run(ENCODE)["correct"]


def test_video_step_returns_its_state(monkeypatch):
    from conceptattention_torch.pipeline import video_pipeline as vp

    monkeypatch.setattr(vp, "ddim_step", lambda sched, out, t, prev, sample, **k: sample)
    assert not _run(VIDEO)["correct"]


def test_video_half_batch(monkeypatch):
    """The guidance batch's unconditional half left out: its prediction is
    the conditional half's."""
    import torch

    from conceptattention_torch.pipeline import video_pipeline as vp

    orig = vp.video_dit_forward

    def cond_only(params, cfg, video, text, t, concepts=None, **k):
        half = video.shape[0] // 2
        pred, sal = orig(params, cfg, video[half:], text[half:], t[half:],
                         concepts=None if concepts is None else concepts[half:], **k)
        return torch.cat([pred, pred]), {n: torch.cat([m, m], dim=1) for n, m in sal.items()}

    monkeypatch.setattr(vp, "video_dit_forward", cond_only)
    assert not _run(VIDEO)["correct"]


def test_video_answer_altered(monkeypatch):
    from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline

    orig = VideoConceptAttentionPipeline.generate_video

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out.video_latents = out.video_latents.clone()
        out.video_latents[:, -1] += 1.0
        return out

    monkeypatch.setattr(VideoConceptAttentionPipeline, "generate_video", altered)
    assert not _run(VIDEO)["correct"]


def test_video_maps_altered(monkeypatch):
    """The per-step maps altered where they are made; the latents untouched."""
    from conceptattention_torch.pipeline import video_pipeline as vp

    orig = vp._reduce_step_maps
    monkeypatch.setattr(vp, "_reduce_step_maps", lambda *a, **k: orig(*a, **k) * 1.1)
    assert not _run(VIDEO)["correct"]


def test_video_concept_tokens_zeroed(monkeypatch):
    """The concept stream fed zeros: only the maps can show it."""
    from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline

    orig = VideoConceptAttentionPipeline.encode_concepts
    monkeypatch.setattr(VideoConceptAttentionPipeline, "encode_concepts",
                        lambda self, *a, **k: orig(self, *a, **k) * 0)
    assert not _run(VIDEO)["correct"]
