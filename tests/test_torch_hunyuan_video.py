"""HunyuanVideo on the port (`models/video/hunyuan.py` and the video
pipeline's HunyuanVideo path) against the plain float32 reference
`perfbench/reference/hunyuan_video.py`, on the CPU at the tiny preset
(hidden 128, 4 heads of 32, 2 + 2 blocks, 2 refiner blocks, RoPE axes
8/12/12, 3 x 8 x 8 latents, 16 text slots with 5 valid, 3 concepts), with
seeded weights whose biases and norm scales are perturbed off their init.

The port runs in float32 here, so it meets the reference to float32
rounding: TOL below. The reference keeps all 16 text slots under the
boolean mask (the published model's semantics) while the port cuts the
text to its 5 valid slots, so every comparison also holds the cut to the
mask. Two controls show that TOL is tight enough to catch a refiner run in
bf16 and a dropped mask."""

import math

import pytest
import torch

from conceptattention_torch.models.flux.params import tree_map
from conceptattention_torch.models.text.encoders import StubTextEncoders
from conceptattention_torch.models.video import hunyuan as hy
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.ops.rope import embed_nd
from conceptattention_torch.ops.schedule import get_schedule, get_shifted_schedule, time_shift
from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline
from perfbench.reference import hunyuan_video as ref

# Relative L2 gap: float32 sums taken in another order (fused vs split
# attention, [txt; img] vs [img; txt] key order) over 4 blocks and 2 steps
# stay below 1e-5; a bf16 refiner reads about 1e-3 (the controls below).
TOL = 2e-5
CFG = hy.hunyuanvideo_tiny_config()
REF_CFG = {"num_heads": CFG.num_heads, "axes_dim": CFG.axes_dim, "theta": CFG.theta,
           "depth": CFG.depth, "depth_single": CFG.depth_single_blocks,
           "num_refiner_layers": CFG.num_refiner_layers}
PROMPT, CONCEPTS = "a red dog on sand", ["dog", "sand", "sky"]  # 5 words: 5 valid slots
FRAMES, H, W = 3, 8, 8


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def params():
    """Seeded f32 weights, every leaf moved off its init (zero biases and
    unit scales would hide a bias or scale in the wrong place)."""
    p = hy.init_hunyuan_video_params(torch.Generator().manual_seed(0), CFG, torch.float32)
    g = torch.Generator().manual_seed(1)
    return tree_map(lambda x: x + 0.05 * torch.randn(x.shape, generator=g), p)


@pytest.fixture(scope="module")
def enc():
    return StubTextEncoders(t5_dim=CFG.context_in_dim, clip_dim=CFG.vec_in_dim,
                            t5_max_length=CFG.text_len)


def _text(enc):
    states, lengths = enc.encode_llm([PROMPT])
    mask = torch.arange(CFG.text_len) < lengths[0]
    return states, mask


def _concepts(enc):
    return torch.stack([enc.encode_llm([c])[0][0, 0] for c in CONCEPTS])[None]


def test_stub_text_has_five_valid_of_sixteen_slots(enc):
    states, mask = _text(enc)
    assert states.shape == (1, 16, 64) and int(mask.sum()) == 5


@pytest.mark.parametrize("row_lengths", [(5,), (11, 11)], ids=["b1", "b2"])
def test_token_refiner_matches_reference(params, row_lengths):
    """The refiner on the valid slots alone against the reference over all
    16 slots and their mask, row by row."""
    g = torch.Generator().manual_seed(2)
    b, n = len(row_lengths), row_lengths[0]
    text = torch.randn(b, CFG.text_len, CFG.context_in_dim, generator=g)
    mask = torch.arange(CFG.text_len) < n
    t = torch.tensor([0.7, 0.3][:b])
    got = hy.token_refiner(params, CFG, text[:, :n], t)
    for i in range(b):
        want = ref.token_refiner(params["refiner"], REF_CFG, text[i:i + 1], t[i:i + 1], mask)
        assert _rel(got[i], want[0, :n]) < TOL


def test_refiner_control_bf16_fails_the_tolerance(params):
    """The same refiner with its weights and text in bf16 reads far above TOL."""
    text = torch.randn(1, 5, CFG.context_in_dim, generator=torch.Generator().manual_seed(3))
    t = torch.tensor([0.5])
    want = ref.token_refiner(params["refiner"], REF_CFG, text, t, torch.ones(5, dtype=torch.bool))
    bf16 = tree_map(lambda x: x.to(torch.bfloat16), params)
    got = hy.token_refiner(bf16, CFG, text.to(torch.bfloat16), t)
    assert _rel(got.float(), want) > 20 * TOL


def _forward_both(params, enc, spec, garbage=False):
    states, mask = _text(enc)
    if garbage:
        states = states.clone()
        states[:, ~mask] = 1e3 * torch.randn(int((~mask).sum()), CFG.context_in_dim)
    g = torch.Generator().manual_seed(4)
    video = torch.randn(1, FRAMES, CFG.latent_channels, H, W, generator=g)
    y = enc.encode_clip([PROMPT])
    t, guid = torch.tensor([0.6]), torch.tensor([6.0])
    con = _concepts(enc)
    n = int(mask.sum())
    got = hy.hunyuan_video_forward(params, CFG, video, states[:, :n], t, y, guid, concepts=con,
                                   spec=spec)
    want = ref.forward(params, REF_CFG, video, states, mask, t, y, guid, con)
    return got, want


@pytest.mark.parametrize("backend", ["fused", "sdpa"])
def test_forward_with_concepts_matches_reference(params, enc, backend):
    (pred, sal), (rpred, rsal) = _forward_both(
        params, enc, ConceptAttentionSpec(backend=backend))
    assert pred.shape == (1, FRAMES, CFG.latent_channels, H, W)
    assert _rel(pred, rpred) < TOL
    assert set(sal) == set(rsal) == {"output", "cross_attention"}
    for k in sal:
        assert sal[k].shape == (CFG.depth, 1, len(CONCEPTS), FRAMES * (H // 2) * (W // 2))
        assert _rel(sal[k], rsal[k]) < TOL


def test_garbage_in_padded_slots_changes_nothing(params, enc):
    """The reference with 1e3-scale garbage in the 11 padded slots gives the
    same answers: the mask keeps them out of every valid row."""
    spec = ConceptAttentionSpec(backend="sdpa")
    (pred, sal), (rpred, rsal) = _forward_both(params, enc, spec, garbage=True)
    assert _rel(pred, rpred) < TOL
    for k in sal:
        assert _rel(sal[k], rsal[k]) < TOL


def test_dropped_mask_control_fails_the_tolerance(params, enc):
    """The reference with every slot marked valid (the mask dropped) is far
    from the port, which keeps only the valid slots."""
    states, mask = _text(enc)
    video = torch.randn(1, FRAMES, CFG.latent_channels, H, W,
                        generator=torch.Generator().manual_seed(4))
    y, t, guid = enc.encode_clip([PROMPT]), torch.tensor([0.6]), torch.tensor([6.0])
    pred, _ = hy.hunyuan_video_forward(params, CFG, video, states[:, :5], t, y, guid,
                                       spec=ConceptAttentionSpec(backend="sdpa"))
    rpred, _ = ref.forward(params, REF_CFG, video, states, torch.ones_like(mask), t, y, guid)
    assert _rel(pred, rpred) > 20 * TOL


def _pipe(params, enc):
    return VideoConceptAttentionPipeline(cfg=CFG, params=params, text_encoders=enc,
                                         dtype=torch.float32, device="cpu")


def test_generate_video_two_steps_matches_reference(params, enc):
    pipe = _pipe(params, enc)
    out = pipe.generate_video(PROMPT, CONCEPTS, num_frames=FRAMES, height=H, width=W,
                              num_inference_steps=2, guidance_scale=6.0, seed=5)
    assert out.video_latents.shape == (1, FRAMES, CFG.latent_channels, H, W)
    assert out.concept_heatmaps.shape == (len(CONCEPTS), FRAMES, H // 2, W // 2)
    states, mask = _text(enc)
    lat0 = torch.randn((1, FRAMES, CFG.latent_channels, H, W),
                       generator=torch.Generator().manual_seed(5))
    lat, heat = ref.generate(params, REF_CFG, lat0, states, mask, enc.encode_clip([PROMPT]),
                             _concepts(enc), 2, CFG.flow_shift, 6.0, range(CFG.depth))
    assert _rel(out.video_latents, lat) < TOL
    assert _rel(torch.as_tensor(out.concept_heatmaps), heat) < TOL


def test_pipeline_opens_the_refiner_span(params, enc):
    from torch.profiler import profile

    pipe = _pipe(params, enc)
    with profile() as prof:
        pipe.generate_video(PROMPT, CONCEPTS[:1], num_frames=1, height=4, width=4,
                            num_inference_steps=1)
    names = [e.name for e in prof.events()]
    # text and concepts, one refiner pass each, inside the step's forward
    assert names.count("ca.dit.refiner") == 2
    for span in ("ca.call.generate_video", "ca.sampler.denoise", "ca.dit.forward"):
        assert names.count(span) == 1


def test_rope_tables_are_three_axis_at_theta_256():
    from conceptattention_torch.models.video.dit import make_video_ids

    ids = make_video_ids(FRAMES, H // 2, W // 2)
    cos, sin = embed_nd(ids, CFG.axes_dim, CFG.theta)
    rcos, rsin = ref.rope_tables(ref.video_ids(FRAMES, H // 2, W // 2, "cpu"), CFG.axes_dim,
                                 256.0)
    assert cos.shape == rcos.shape == (1, 1, FRAMES * (H // 2) * (W // 2), 16)
    assert float((cos - rcos).abs().max()) < 1e-6 and float((sin - rsin).abs().max()) < 1e-6
    flux_cos, _ = embed_nd(ids, CFG.axes_dim, 10_000)
    assert float((flux_cos - cos).abs().max()) > 0.1
    # the time axis: frame 1's first pair turns by 1 radian, its last by 256^(-6/8)
    p = (H // 2) * (W // 2)
    assert math.isclose(float(torch.atan2(sin[0, 0, p, 0], cos[0, 0, p, 0])), 1.0, rel_tol=1e-6)
    assert math.isclose(float(torch.atan2(sin[0, 0, p, 3], cos[0, 0, p, 3])), 256 ** -0.75,
                        rel_tol=1e-5)


@pytest.mark.parametrize("steps", [1, 4, 50])
def test_shifted_schedule(steps):
    got = get_shifted_schedule(steps, 7.0)
    assert got == pytest.approx(ref.sigmas(steps, 7.0), abs=1e-12)
    mid = [float(time_shift(math.log(7.0), 1.0, t)) for t in get_schedule(steps, 1, shift=False)[:-1]]
    assert got[:-1] == pytest.approx(mid, abs=1e-12) and got[-1] == 0.0


def test_published_config():
    cfg = hy.hunyuanvideo_config()
    assert (cfg.depth, cfg.depth_single_blocks, cfg.num_refiner_layers) == (20, 40, 2)
    assert (cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.mlp_hidden_dim) == (3072, 24, 128,
                                                                                  12288)
    assert (cfg.axes_dim, cfg.theta, cfg.guidance_embed) == ((16, 56, 56), 256, True)
    assert (cfg.context_in_dim, cfg.vec_in_dim, cfg.text_len) == (4096, 768, 256)
    assert (cfg.latent_channels, cfg.in_channels, cfg.flow_shift) == (16, 64, 7.0)
    assert cfg.patch_size == 2 and hy.hunyuanvideo_config(latent_channels=8).in_channels == 32
    with pytest.raises(TypeError):  # the packed patch width follows from the latents'
        hy.hunyuanvideo_config(in_channels=32)


@pytest.mark.parametrize("kw", [dict(quantize="w8a8"), dict(lora={})], ids=["quantize", "lora"])
def test_unported_paths_raise(params, enc, kw):
    with pytest.raises(NotImplementedError):
        VideoConceptAttentionPipeline(cfg=CFG, params=params, text_encoders=enc, device="cpu",
                                      dtype=torch.float32, **kw)


def test_decode_and_ring_raise(params, enc):
    pipe = _pipe(params, enc)
    with pytest.raises(NotImplementedError):
        pipe.generate_video(PROMPT, CONCEPTS, num_frames=1, height=4, width=4,
                            num_inference_steps=1, decode=True)
    with pytest.raises(NotImplementedError):
        hy.hunyuan_video_forward(params, CFG, torch.zeros(1, 1, 4, 4, 4), torch.zeros(1, 2, 64),
                                 torch.zeros(1), torch.zeros(1, 32), torch.zeros(1),
                                 spec=ConceptAttentionSpec(backend="ring"))


@pytest.fixture(scope="module")
def smoke():
    """`chip_smoke.py`, the card's smoke run, whose HunyuanVideo phases hold
    K1 against the plain version on a subset of rows (`plain_rows`)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_args(t, p, c, cross=True, self_attention=True):
    """K1's args at a small joint shape with random 3-axis tables."""
    from conceptattention_torch.kernels import flash_saliency as fs

    g = torch.Generator().manual_seed(6)
    s, d = t + p + c, 32
    q, k, v = (torch.randn(1, 3, s, d, generator=g).bfloat16() for _ in range(3))
    ids = torch.randint(0, 9, (1, t + p, 3), generator=g).float()
    cos, sin = fs.expand_rope_tables([embed_nd(ids, (8, 12, 12), 256)], s)
    return (q, k, v, t, p, c, cross, self_attention, cos, sin)


@pytest.mark.parametrize("segments,cross,self_attention", [
    ((5, 70, 3), True, True), ((5, 70, 3), True, False), ((5, 70, 3), False, True),
    ((75, 0, 0), True, True)], ids=["double", "cross-only", "self-only", "single"])
def test_smoke_plain_rows_is_the_plain_version(smoke, segments, cross, self_attention):
    """`plain_rows` at some heads and rows is the plain version's output
    there (to a bf16 step: its f32 scores come from another product), and
    its two controls move the rows they fault."""
    from conceptattention_torch.kernels import flash_saliency as fs

    args = _smoke_args(*segments, cross, self_attention)
    t, p, c = segments
    heads, rows = [0, 2], torch.tensor([0, 3, 4, 5, 40, 74] + list(range(75, 75 + c)))
    want = fs.fused_concept_flash_attention_plain(*args)[:, heads][:, :, rows].float()
    got = smoke.plain_rows(args, heads, rows).float()
    step = 2.0**-7 * want.abs().max()
    assert float((got - want).abs().max()) <= step
    dropped = smoke.plain_rows(args, heads, rows, drop=8).float()
    assert float((dropped[:, :, :6] - want[:, :, :6]).abs().max()) > step
    if c:
        flipped = smoke.plain_rows(args, heads, rows, cross=not cross).float()
        assert float((flipped[:, :, 6:] - want[:, :, 6:]).abs().max()) > step


def test_smoke_hunyuan_prompt_fills_32_text_slots(smoke, enc):
    assert smoke.HY_TEXT_ROWS[0] == 32 and enc.encode_llm([smoke.HY_PROMPT])[1] == [16]
    wide = StubTextEncoders(t5_dim=8, clip_dim=8, t5_max_length=256)
    assert wide.encode_llm([smoke.HY_PROMPT])[1] == [32]
