"""Weights of the video cells that `weights.py` does not draw: HunyuanVideo's
transformer and the CogVideoX 3D VAE's decoder, by the same rules (drawn on
the device from the seed, one `torch.randn` call a stacked leaf, in the
dtype served: linear and conv weights N(0, 1/fan_in), biases and norm
shifts N(0, 0.02^2), norm scales one) and in the layout the program takes.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import weights


def hunyuan_dit(seed: int, cfg: Dict, device, dtype=torch.bfloat16) -> Dict:
    """HunyuanVideo's tree: Flux's (`weights.flux_dit`: img_in, time_in,
    vector_in, final, double, single) less its linear `txt_in`, with
    `guidance_in` and the token refiner (`refiner`). `cfg`: the Flux sizes
    and num_refiner_layers."""
    tree = weights.flux_dit(seed, cfg, device, dtype)
    del tree["txt_in"]  # the refiner embeds the text
    r = weights._Draw(weights.derive(seed, "hunyuan-refiner"), device, dtype)
    d, h, hd, m = cfg["hidden"], cfg["num_heads"], cfg["head_dim"], cfg["mlp_hidden"]
    n = (cfg["num_refiner_layers"],)

    def ln():
        return {"w": r.ones((*n, d)), "b": r.normal((*n, d), 0.02)}

    tree["guidance_in"] = {"in": r.linear(256, d), "out": r.linear(d, d)}
    tree["refiner"] = {
        "input_embedder": r.linear(cfg["context_in_dim"], d),
        "t_embedder": {"in": r.linear(256, d), "out": r.linear(d, d)},
        "c_embedder": {"in": r.linear(cfg["context_in_dim"], d), "out": r.linear(d, d)},
        "blocks": {"norm1": ln(), "qkv": r.linear(d, (3, h, hd), n), "proj": r.linear(d, d, n),
                   "norm2": ln(), "mlp_in": r.linear(d, m, n), "mlp_out": r.linear(m, d, n),
                   "adaln": r.linear(d, 2 * d, n)},
    }
    return tree


def cogvideox_vae_decoder(seed: int, cfg: Dict, device, dtype=torch.float32) -> Dict:
    """{"decoder": ...}: the CogVideoX 3D VAE's decoder in the program's
    layout (diffusers' `AutoencoderKLCogVideoX` order; convs OIDHW, the
    upsamplers' Conv2d OIHW; SpatialNorm3D's GroupNorm and its 1x1x1
    `conv_y` / `conv_b` of the latent). `cfg`: block_out_channels,
    layers_per_block, latent_channels, out_channels."""
    r = _ConvDraw(weights.derive(seed, "cogvideox-vae"), device, dtype)
    zc = cfg["latent_channels"]

    def sn(c):
        return {"norm": {"scale": r.ones((c,)), "bias": r.normal((c,), 0.02)},
                "conv_y": r.conv(zc, c, (1, 1, 1)), "conv_b": r.conv(zc, c, (1, 1, 1))}

    def resnet(c_in, c_out):
        p = {"norm1": sn(c_in), "conv1": r.conv(c_in, c_out, (3, 3, 3)), "norm2": sn(c_out),
             "conv2": r.conv(c_out, c_out, (3, 3, 3))}
        if c_in != c_out:
            p["conv_shortcut"] = r.conv(c_in, c_out, (1, 1, 1))
        return p

    chans = list(cfg["block_out_channels"])[::-1]
    up: List[Dict] = []
    c_prev = chans[0]
    for i, c in enumerate(chans):
        block = {"resnets": [resnet(c_prev if j == 0 else c, c)
                             for j in range(cfg["layers_per_block"] + 1)]}
        if i < len(chans) - 1:
            block["upsample"] = r.conv(c, c, (3, 3))
        up.append(block)
        c_prev = c
    return {"decoder": {"conv_in": r.conv(zc, chans[0], (3, 3, 3)),
                        "mid": [resnet(chans[0], chans[0]) for _ in range(2)], "up": up,
                        "norm_out": sn(chans[-1]),
                        "conv_out": r.conv(chans[-1], cfg["out_channels"], (3, 3, 3))}}


class _ConvDraw(weights._Draw):
    def conv(self, c_in: int, c_out: int, kernel) -> Dict:
        fan = c_in
        for k in kernel:
            fan *= k
        return {"w": self.normal((c_out, c_in, *kernel), fan ** -0.5),
                "b": self.normal((c_out,), 0.02)}
