"""The frozen reference against the program's plain path on the CPU, in
float32, at the program's tiny presets: the Flux DiT's output and both
heatmap taps, the Flux VAE both ways, the CogVideoX DiT's output and map.
Any gap beyond float32 rounding is a difference of mathematics."""

import pytest
import torch

from perfbench import harness, weights
from perfbench.drivers import flux_common
from perfbench.reference import flux as ref_flux
from perfbench.reference import flux_vae as ref_vae
from perfbench.reference import video as ref_video
from perfbench.tests.tiny import FLUX_TINY, VIDEO_TINY

TOL = 2e-5  # relative: float32 sums taken in another order, over a few layers


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _flux_sizes():
    """The flux-schnell configuration file shrunk to the program's flux-tiny."""
    cfg = harness.load_json(harness.HERE / "configs" / "flux-schnell.json")
    return flux_common.sizes(harness._merge(cfg, FLUX_TINY))


@pytest.mark.parametrize("stop", [False, True])
def test_flux_dit_and_taps(stop):
    from conceptattention_torch.config import configs
    from conceptattention_torch.models.flux.dit import flux_forward
    from conceptattention_torch.ops.attention import ConceptAttentionSpec

    dit, _ = _flux_sizes()
    cfg = configs["flux-tiny"].params
    params = weights.flux_dit(3, dit, "cpu", torch.float32)
    g = torch.Generator().manual_seed(1)
    b, t, c = 2, 7, 3
    ids = ref_flux.img_ids(6, 6, "cpu").expand(b, -1, -1)
    inputs = dict(img=torch.randn(b, 36, 16, generator=g), img_ids=ids,
                  txt=torch.randn(b, t, 64, generator=g), txt_ids=torch.zeros(b, t, 3),
                  timesteps=torch.tensor([0.3, 0.8]), y=torch.randn(b, 32, generator=g),
                  concepts=torch.randn(b, c, 64, generator=g), concept_ids=torch.zeros(b, c, 3),
                  concept_vec=torch.zeros(b, 32))
    pred, sal = flux_forward(params, cfg, **inputs, stop_after_multimodal_attentions=stop,
                             spec=ConceptAttentionSpec(backend="sdpa"))
    rpred, rsal = ref_flux.forward(params, dit, *(inputs[k] for k in (
        "img", "img_ids", "txt", "txt_ids", "timesteps", "y", "concepts", "concept_ids",
        "concept_vec")), stop_after_double=stop)
    assert (pred is None) == stop and (rpred is None) == stop
    if not stop:
        assert _rel(pred, rpred) < TOL
    assert set(sal) == set(rsal) == {"output", "cross_attention"}
    for k in sal:
        assert _rel(sal[k], rsal[k]) < TOL


def test_flux_vae_both_ways():
    from conceptattention_torch.config import configs
    from conceptattention_torch.models.flux import autoencoder as vae

    _, sizes = _flux_sizes()
    acfg = configs["flux-tiny"].ae_params
    p = weights.flux_vae(4, sizes, "cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.rand(1, 3, 32, 32, generator=g) * 2 - 1
    eps = torch.randn(1, 4, 16, 16, generator=g)
    want = vae.vae_latents(vae.encoder_apply(p["encoder"], acfg, x), acfg)
    mean, logvar = vae.encoder_apply(p["encoder"], acfg, x).chunk(2, dim=1)
    want_draw = acfg.scale_factor * (mean + torch.exp(0.5 * logvar) * eps - acfg.shift_factor)
    assert _rel(ref_vae.encode(p, sizes, x), want) < TOL
    assert _rel(ref_vae.encode(p, sizes, x, eps), want_draw) < TOL
    z = torch.randn(1, 4, 16, 16, generator=g)
    assert _rel(ref_vae.decode(p, sizes, z), vae.decode(p, acfg, z)) < TOL
    assert _rel(ref_vae.decode(p, sizes, z), vae.decode_nhwc(p, acfg, z)) < TOL


def test_video_dit_and_map():
    from conceptattention_torch.models.video.dit import CogVideoXConfig, video_dit_forward
    from conceptattention_torch.ops.attention import ConceptAttentionSpec

    from perfbench.drivers.video import sizes

    file = harness._merge(harness.load_json(harness.HERE / "configs" / "cogvideox-5b.json"),
                          VIDEO_TINY)
    sz = sizes(file)
    cfg = CogVideoXConfig(**{k: file[k] for k in VIDEO_TINY if k != "port_preset"},
                          use_rotary_positional_embeddings=True)
    params = weights.cogvideox_dit(5, sz, "cpu", torch.float32)
    g = torch.Generator().manual_seed(3)
    video = torch.randn(2, 3, 4, 8, 8, generator=g)
    text = torch.randn(2, 6, 16, generator=g)
    concepts = torch.randn(2, 6, 16, generator=g)
    t = torch.tensor([750.0, 750.0])
    pred, sal = video_dit_forward(params, cfg, video, text, t, concepts=concepts,
                                  spec=ConceptAttentionSpec(backend="sdpa", taps=("output",)))
    rpred, rmaps = ref_video.forward(params, sz, video, text, t, concepts)
    assert _rel(pred, rpred) < TOL and _rel(sal["output"], rmaps) < TOL
