"""The operation counts of `perfbench/roofline.py` against what
`FlopCounterMode` counts over the frozen reference at tiny sizes, and its
bounds against the figures the port's kernel table holds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import roofline, weights
from perfbench.reference import flux as ref_flux
from perfbench.reference import flux_vae as ref_vae
from perfbench.reference import video as ref_video

DIT = {"hidden": 64, "num_heads": 2, "head_dim": 32, "mlp_hidden": 256, "in_channels": 16,
       "context_in_dim": 24, "vec_in_dim": 12, "depth": 2, "depth_single": 2,
       "axes_dim": (8, 12, 12)}
VAE = {"ch": 16, "ch_mult": (1, 2), "num_res_blocks": 1, "z_channels": 4, "in_channels": 3,
       "out_ch": 3, "scale_factor": 0.3611, "shift_factor": 0.1159}
VIDEO = {"hidden": 32, "num_heads": 2, "head_dim": 16, "num_layers": 2, "time_embed_dim": 8,
         "in_channels": 4, "out_channels": 4, "patch_size": 2, "text_embed_dim": 16,
         "norm_eps": 1e-5, "max_text_seq_length": 5}


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("stop", [False, True])
@pytest.mark.parametrize("b,t,p,c", [(1, 5, 16, 3), (2, 7, 36, 2)])
def test_flux_forward_flops(b, t, p, c, stop):
    params = weights.flux_dit(0, DIT, "cpu", torch.float32)
    side = int(p ** 0.5)
    g = torch.Generator().manual_seed(0)
    ids = ref_flux.img_ids(side, side, "cpu").expand(b, -1, -1)

    def run():
        ref_flux.forward(params, DIT, torch.randn(b, p, 16, generator=g), ids,
                         torch.randn(b, t, 24, generator=g), torch.zeros(b, t, 3),
                         torch.full((b,), 0.5), torch.randn(b, 12, generator=g),
                         torch.randn(b, c, 24, generator=g), torch.zeros(b, c, 3),
                         torch.zeros(b, 12), stop_after_double=stop)

    want = sum(roofline.flux_forward_flops(DIT, b, t, p, c, stop).values())
    assert _counted(run) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("decoder", [False, True])
def test_vae_flops(decoder):
    p = weights.flux_vae(0, VAE, "cpu")
    if decoder:
        def run():
            ref_vae.decode(p, VAE, torch.randn(1, 4, 16, 16))
    else:
        def run():
            ref_vae.encode_moments(p["encoder"], VAE, torch.randn(1, 3, 32, 32))
    assert _counted(run) == pytest.approx(roofline.vae_flops(VAE, 32, decoder), rel=1e-12)


def test_video_forward_flops():
    params = weights.cogvideox_dit(0, VIDEO, "cpu", torch.float32)
    b, f, h, w, t, c = 2, 2, 4, 6, 5, 5
    g = torch.Generator().manual_seed(0)

    def run():
        ref_video.forward(params, VIDEO, torch.randn(b, f, 4, h, w, generator=g),
                          torch.randn(b, t, 16, generator=g), torch.full((b,), 500.0),
                          torch.randn(b, c, 16, generator=g))

    p = f * (h // 2) * (w // 2)
    want = sum(roofline.video_forward_flops(VIDEO, b, t, p, c).values())
    assert _counted(run) == pytest.approx(want, rel=1e-12)


def test_attention_bounds_match_the_kernel_table():
    flux = {"num_heads": 24, "head_dim": 128}
    double = roofline.attention_bound_s(1, 24, 128, 4355, roofline.concept_pairs(256, 4096, 3))
    assert double * 1e3 == pytest.approx(0.2355, abs=5e-5)
    assert flux["num_heads"] * flux["head_dim"] == 3072
    video = roofline.attention_bound_s(2, 48, 64, 18002, roofline.concept_pairs(226, 17550, 226))
    assert video * 1e3 == pytest.approx(7.9519, abs=5e-4)
    mid = roofline.vae_attention_bound_s({**VAE, "ch": 128, "ch_mult": (1, 2, 4, 4)}, 1024)
    assert mid * 1e3 == pytest.approx(0.5559, abs=5e-4)


def test_decoder_conv_bound_matches_the_kernel_table():
    vae = {**VAE, "ch": 128, "ch_mult": (1, 2, 4, 4), "num_res_blocks": 2, "z_channels": 16}
    convs = roofline.k2_convs(vae, 1024)
    assert len(convs) == 31
    assert roofline.conv_bound_s(convs, 2, roofline.PEAK_BF16) * 1e3 == pytest.approx(9.85,
                                                                                      abs=0.05)
