"""The port's layer spans (`utils/profiling.span`) on the CPU: nothing is
recorded and nothing changes without a profiler session, and under one the
pipelines' calls emit the declared spans, nested call > sampler > forward
and call > VAE, with one forward per step and one VAE pass per image."""

import contextlib
import re
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conceptattention_torch.models.video.dit import CogVideoXConfig
from conceptattention_torch.models.video.vae import CogVideoXVAEConfig
from conceptattention_torch.pipeline.concept_pipeline import ConceptAttentionFluxPipeline
from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline
from conceptattention_torch.utils import profiling
from conceptattention_torch.utils.profiling import SPANS, span

torch.set_num_threads(2)  # six test workers share the host's cores

# The kernel-name classes that the benchmark's readers match on the card's trace.
KERNEL_CLASSES = (r"flash_saliency|rope_rows", r"conv3x3", r"(?i)conv|fprop|winograd")
CONCEPTS = ["cat", "dog", "sky"]
GEN = dict(width=32, height=32, num_inference_steps=2, return_pil_heatmaps=False,
           return_image_array=True, watermark=False)


@pytest.fixture(scope="module")
def flux():
    return ConceptAttentionFluxPipeline("flux-tiny", dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def video():
    cfg = CogVideoXConfig(
        num_attention_heads=2, attention_head_dim=16, in_channels=4, out_channels=4,
        time_embed_dim=8, text_embed_dim=16, num_layers=2, sample_width=8, sample_height=8,
        sample_frames=9, patch_size=2, max_text_seq_length=6)
    vae_cfg = CogVideoXVAEConfig(block_out_channels=(8, 16, 16), latent_channels=4,
                                 layers_per_block=1, norm_num_groups=4)
    return VideoConceptAttentionPipeline(cfg=cfg, dtype=torch.float32, device="cpu",
                                         vae_cfg=vae_cfg)


def recorded(fn):
    """(fn's result, the `ca.` spans its call emitted as (name, start, end)
    in order of start) under a CPU profiler session."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("ca.")]
    return out, sorted(events, key=lambda e: e[1])


def named(events, name):
    return [e for e in events if e[0] == name]


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def counts(events):
    out = {}
    for name, _, _ in events:
        out[name] = out.get(name, 0) + 1
    return out


def check_names(events):
    assert {n for n, _, _ in events} <= set(SPANS)
    assert not [n for n, _, _ in events for c in KERNEL_CLASSES if re.search(c, n)]


def test_span_without_a_session_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    off = span(profiling.DIT_FORWARD)
    assert off is span(profiling.CALL_GENERATE_VIDEO)
    assert isinstance(off, contextlib.nullcontext)
    # a span opened before a session records nothing in it; one opened in it does
    with span(profiling.CALL_ENCODE_IMAGES):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert torch.autograd._profiler_enabled()
            with span(profiling.DIT_FORWARD):
                torch.ones(2).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert profiling.DIT_FORWARD in names and profiling.CALL_ENCODE_IMAGES not in names
    assert span(profiling.DIT_FORWARD) is off


def test_declared_names_are_distinct_and_match_no_kernel_class():
    assert len(set(SPANS)) == len(SPANS) == 10
    assert all(n.startswith("ca.") for n in SPANS)
    check_names([(n, 0, 0) for n in SPANS])


def test_generate_images_is_bit_identical_under_a_session(flux):
    def run():
        return flux.generate_images(["a cat", "a dog"], CONCEPTS, seeds=[1, 2], **GEN)

    plain = run()
    traced, events = recorded(run)
    assert events
    for a, b in zip(plain, traced):
        for field in ("image", "concept_heatmaps", "cross_attention_maps"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field


def test_generate_images_spans(flux):
    _, ev = recorded(lambda: flux.generate_images(["a cat", "a dog"], CONCEPTS, seeds=[1, 2],
                                                  **GEN))
    check_names(ev)
    assert counts(ev) == {"ca.call.generate_images": 1, "ca.pipeline.prepare": 2,
                          "ca.sampler.denoise": 1, "ca.dit.forward": 2,
                          "ca.pipeline.reduce_maps": 2, "ca.vae.decode": 2,
                          "ca.pipeline.to_host": 4}
    (call,), (loop,) = named(ev, "ca.call.generate_images"), named(ev, "ca.sampler.denoise")
    assert inside(loop, call) and all(inside(e, call) for e in ev)
    assert all(inside(f, loop) for f in named(ev, "ca.dit.forward"))
    for d in named(ev, "ca.vae.decode"):
        assert not inside(d, loop)


def test_generate_image_to_image_spans(flux):
    init = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    _, ev = recorded(lambda: flux.generate_image(
        "a cat", CONCEPTS, width=32, height=32, num_inference_steps=2, init_image=init,
        image2image_strength=0.5, return_pil_heatmaps=False, watermark=False))
    check_names(ev)
    c = counts(ev)
    assert (c["ca.call.generate_images"], c["ca.vae.encode"], c["ca.vae.decode"]) == (1, 1, 1)
    assert c["ca.dit.forward"] == 1  # strength 0.5 of 2 steps runs the last
    (call,) = named(ev, "ca.call.generate_images")
    assert all(inside(e, call) for e in ev)


def test_encode_images_spans(flux):
    images = [np.random.default_rng(i).integers(0, 256, (40, 40, 3), dtype=np.uint8)
              for i in range(2)]
    _, ev = recorded(lambda: flux.encode_images(images, ["cat", "dog"], width=32, height=32,
                                                return_pil_heatmaps=False, seeds=[3, 4]))
    check_names(ev)
    # prepare: each image's resize and upload, the text and concepts, the noise
    assert counts(ev) == {"ca.call.encode_images": 1, "ca.pipeline.prepare": 4,
                          "ca.vae.encode": 2, "ca.dit.forward": 1,
                          "ca.pipeline.reduce_maps": 4, "ca.pipeline.to_host": 2}
    (call,) = named(ev, "ca.call.encode_images")
    assert all(inside(e, call) for e in ev)
    _, one = recorded(lambda: flux.encode_image(images[0], ["cat", "dog"], width=32, height=32,
                                                return_pil_heatmaps=False))
    check_names(one)
    c = counts(one)
    assert (c["ca.call.encode_images"], c["ca.vae.encode"], c["ca.dit.forward"]) == (1, 1, 1)
    assert "ca.sampler.denoise" not in c


@pytest.mark.parametrize("scheduler", ["ddim", "dpm"])
def test_generate_video_spans(video, scheduler):
    _, ev = recorded(lambda: video.generate_video(
        "a dog running", ["dog", "grass"], num_frames=3, height=8, width=8,
        num_inference_steps=2, scheduler=scheduler, return_cross_attention=True, decode=True))
    check_names(ev)
    # one forward a guided step ([uncond; cond] in one batch); the two taps'
    # finalize; the maps, the cross maps and the frames back to the host
    assert counts(ev) == {"ca.call.generate_video": 1, "ca.pipeline.prepare": 1,
                          "ca.sampler.denoise": 1, "ca.dit.forward": 2,
                          "ca.pipeline.reduce_maps": 2, "ca.pipeline.to_host": 3,
                          "ca.vae.decode": 1}
    (call,), (loop,) = named(ev, "ca.call.generate_video"), named(ev, "ca.sampler.denoise")
    assert all(inside(e, call) for e in ev)
    assert all(inside(f, loop) for f in named(ev, "ca.dit.forward"))
    (dec,) = named(ev, "ca.vae.decode")
    assert not inside(dec, loop)


def test_graph_replay_is_a_forward_span():
    """`make_jitted_forward`'s replay (the card's path; its graph stubbed)."""
    from conceptattention_torch.models.flux.dit import _Replay

    replay = object.__new__(_Replay)
    replay.inputs = {"img": torch.zeros(2)}
    replay.graph = types.SimpleNamespace(replay=lambda: None)
    replay.launches = {}
    replay.outputs = (torch.ones(2), {"output": torch.ones(3)})
    (pred, sal), ev = recorded(lambda: replay({"img": torch.ones(2)}))
    assert [n for n, _, _ in ev] == ["ca.dit.forward"]
    assert torch.equal(replay.inputs["img"], torch.ones(2)) and torch.equal(pred, torch.ones(2))
