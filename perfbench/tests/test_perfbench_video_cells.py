"""The two video cells that `tiny.py` does not shrink, HunyuanVideo denoising
and CogVideoX decoding, through the harness's whole path on the CPU in
float32 at the program's tiny sizes: the unbroken run reads `correct` true,
each cell's control (the reference in float8 in the program's place) and
each planted fault read false. Besides: the new references against the
program's plain path, the counts of `roofline_video.py` against what
`FlopCounterMode` counts over the references, and the drivers' imports."""

import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness, roofline_video, weights_video
from perfbench.drivers import hunyuan_video as hdrv
from perfbench.reference import hunyuan_video as ref_hy
from perfbench.reference import video_vae as ref_vae
from perfbench.tests.tiny import VIDEO_TINY

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
HUNYUAN, DECODE = "hunyuanvideo.denoise-540p-129f", "cogvideox-5b.decode-49f"
HUNYUAN_TINY = {
    "port_preset": None, "attention_head_dim": 32, "num_attention_heads": 4, "num_layers": 2,
    "num_single_layers": 2, "num_refiner_layers": 2, "rope_axes_dim": [8, 12, 12],
    "text_embed_dim": 64, "pooled_projection_dim": 32, "in_channels": 4, "text_len": 16,
}
VAE_TINY = {"block_out_channels": [8, 16, 16, 32], "layers_per_block": 1, "norm_num_groups": 4,
            "latent_channels": 4}
OVERRIDES = {
    HUNYUAN: {"config": HUNYUAN_TINY,
              "traffic": {"frames": 3, "height": 8, "width": 8, "concepts": 3,
                          "text_valid": [3, 12]}},
    DECODE: {"config": VIDEO_TINY,
             "traffic": {"frames": 3, "height": 8, "width": 8, "vae": VAE_TINY}},
}
TOL = 2e-5  # relative: float32 sums taken in another order


def _run(cell, variant="program"):
    over = OVERRIDES[cell]
    over = {**over, "config": {**over["config"], "dtype": "float32"}}
    result, _ = harness.run_cell(BENCH, cell, 2**31 + 77, 0.2, False, time.perf_counter(),
                                 device="cpu", variant=variant, overrides=over,
                                 log=lambda msg: None)
    return result


@pytest.mark.parametrize("cell", [HUNYUAN, DECODE])
def test_unbroken_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", [HUNYUAN, DECODE])
def test_control_is_not_correct(cell):
    assert not _run(cell, variant="control")["correct"]


def test_hunyuan_text_mask_ignored(monkeypatch):
    """The pipeline takes every text slot as valid: padded states become keys."""
    from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline

    orig = VideoConceptAttentionPipeline.__init__

    class AllValid:
        def __init__(self, enc):
            self.enc = enc

        def __getattr__(self, name):
            return getattr(self.enc, name)

        def encode_llm(self, prompts):
            states, _ = self.enc.encode_llm(prompts)
            return states, [states.shape[1]] * len(prompts)

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.text_encoders = AllValid(self.text_encoders)

    monkeypatch.setattr(VideoConceptAttentionPipeline, "__init__", init)
    assert not _run(HUNYUAN)["correct"]


def test_hunyuan_refiner_gate_dropped(monkeypatch):
    """Each refiner block adds its attention and MLP with gate 1."""
    from conceptattention_torch.models.video import hunyuan

    orig = hunyuan.layer

    def ungated(stacked, i):
        lp = orig(stacked, i)
        if "adaln" in lp:
            a = lp["adaln"]
            lp = {**lp, "adaln": {"w": torch.zeros_like(a["w"]), "b": torch.ones_like(a["b"])}}
        return lp

    monkeypatch.setattr(hunyuan, "layer", ungated)
    assert not _run(HUNYUAN)["correct"]


def test_decode_up_block_skipped(monkeypatch):
    """The third up block's resnets left out (its width does not change, so
    the frames keep their shape)."""
    from conceptattention_torch.models.video import vae

    orig = vae.decoder_apply

    def skipped(p, cfg, z):
        up = list(p["up"])
        up[2] = {**up[2], "resnets": []}
        return orig({**p, "up": up}, cfg, z)

    monkeypatch.setattr(vae, "decoder_apply", skipped)
    assert not _run(DECODE)["correct"]


def _vae_cfg():
    tr = harness._merge(harness.load_json(harness.HERE / "traffic" / "decode-49f.json"),
                        OVERRIDES[DECODE]["traffic"])
    return tr["vae"]


def test_video_vae_reference_matches_the_program():
    from conceptattention_torch.models.video import vae
    from perfbench.drivers.video_decode import port_vae_config

    cfg = _vae_cfg()
    params = weights_video.cogvideox_vae_decoder(5, cfg, "cpu")
    z = torch.randn(1, 3, 4, 6, 8, generator=torch.Generator().manual_seed(0))
    got = vae.decode(params, port_vae_config(cfg), z.transpose(1, 2))
    want = ref_vae.decode(params, cfg, z)
    assert got.shape == want.shape == (1, 3, 9, 48, 64)
    assert float((got - want).norm() / want.norm()) < TOL


def test_decoder_conv_flops():
    cfg = _vae_cfg()
    params = weights_video.cogvideox_vae_decoder(5, cfg, "cpu")
    z = torch.randn(1, 3, 4, 6, 8, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        ref_vae.decode(params, cfg, z)
    convs = roofline_video.cogvideox_decoder_convs(cfg, 3, 6, 8)
    assert counter.get_total_flops() == sum(roofline_video.conv_flops(c) for c in convs)
    assert roofline_video.decoder_conv_bound_s(convs) > 0


def _hunyuan_sizes():
    cfg = harness.load_json(harness.HERE / "configs" / "hunyuanvideo.json")
    return hdrv.sizes(harness._merge(cfg, HUNYUAN_TINY))


@pytest.mark.parametrize("c", [0, 3])
def test_hunyuan_forward_flops(c):
    sz = _hunyuan_sizes()
    params = weights_video.hunyuan_dit(3, sz, "cpu", torch.float32)
    g = torch.Generator().manual_seed(1)
    t, video = 7, torch.randn(1, 3, 4, 8, 8, generator=g)
    args = (video, torch.randn(1, t, 64, generator=g), torch.ones(t, dtype=torch.bool),
            torch.tensor([0.4]), torch.randn(1, 32, generator=g), torch.tensor([6.0]),
            torch.randn(1, c, 64, generator=g) if c else None)
    with FlopCounterMode(display=False) as counter:
        ref_hy.forward(params, sz, *args)
    p = 3 * 4 * 4
    want = roofline_video.hunyuan_forward_flops(sz, t, p, c)
    cross_tap = sz["depth"] * 2.0 * c * p * sz["hidden"]  # the reference makes both taps
    assert counter.get_total_flops() == pytest.approx(sum(want.values()) + cross_tap, rel=1e-12)


def test_hunyuan_reference_matches_the_program_with_padded_text():
    """The reference over 16 slots with 9 valid against the program's
    forward on the 9 valid slots, on the benchmark's weights."""
    from conceptattention_torch.models.video import hunyuan
    from conceptattention_torch.ops.attention import ConceptAttentionSpec

    sz = _hunyuan_sizes()
    cfg = harness._merge(harness.load_json(harness.HERE / "configs" / "hunyuanvideo.json"),
                         HUNYUAN_TINY)
    port = hdrv.port_config(cfg)
    params = weights_video.hunyuan_dit(3, sz, "cpu", torch.float32)
    g = torch.Generator().manual_seed(2)
    video, txt = torch.randn(1, 3, 4, 8, 8, generator=g), torch.randn(1, 16, 64, generator=g)
    y, con = torch.randn(1, 32, generator=g), torch.randn(1, 3, 64, generator=g)
    t, guid = torch.tensor([0.9]), torch.tensor([6.0])
    pred, sal = hunyuan.hunyuan_video_forward(params, port, video, txt[:, :9], t, y, guid,
                                              concepts=con, spec=ConceptAttentionSpec())
    rpred, rsal = ref_hy.forward(params, sz, video, txt, torch.arange(16) < 9, t, y, guid, con)
    assert float((pred - rpred).norm() / rpred.norm()) < TOL
    for k in ("output", "cross_attention"):
        assert float((sal[k] - rsal[k]).norm() / rsal[k].norm()) < TOL


def test_text_lengths_are_seeded_and_in_range():
    enc = hdrv.LlmTextStates(2**31 + 5, "cpu", 8, 4, 256, (32, 256))
    lengths = [enc.valid_length(f"prompt {i}") for i in range(400)]
    assert min(lengths) >= 32 and max(lengths) <= 256 and len(set(lengths)) > 100
    assert lengths == [enc.valid_length(f"prompt {i}") for i in range(400)]
    states, n = enc.encode_llm(["a b"])
    assert states.shape == (1, 256, 8) and n == [enc.valid_length("a b")]


def test_new_drivers_import_nothing_of_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.drivers.hunyuan_video, perfbench.drivers.video_decode\n"
            "import perfbench.reference.hunyuan_video, perfbench.reference.video_vae\n"
            "import perfbench.harness as h; print(','.join(h.forbidden_modules()))\n"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip()
    assert out == ""
