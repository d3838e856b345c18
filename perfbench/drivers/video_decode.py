"""Closed-loop CogVideoX decoding: `VideoConceptAttentionPipeline.decode_latents`
calls on seeded latents of the published clip, each to uint8 frames through
the float32 3D causal VAE, with the pipeline holding its DiT as a deployment
does.

Traffic parameters: frames, height, width (latent sizes), vae (the
published `vae/config.json` sizes the decoder is built from), check_calls,
report.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from perfbench import roofline_video, weights, weights_video
from perfbench.drivers import flux_common as fc
from perfbench.drivers import video


def port_vae_config(vae: Dict):
    """The program's `CogVideoXVAEConfig` with the file's sizes."""
    from conceptattention_torch.models.video.vae import CogVideoXVAEConfig

    return CogVideoXVAEConfig(
        in_channels=vae["in_channels"], out_channels=vae["out_channels"],
        block_out_channels=tuple(vae["block_out_channels"]),
        latent_channels=vae["latent_channels"], layers_per_block=vae["layers_per_block"],
        temporal_compression_ratio=vae["temporal_compression_ratio"],
        norm_num_groups=vae["norm_num_groups"], scaling_factor=vae["scaling_factor"])


def requests(tr: Dict, seed: int) -> Iterator[Dict]:
    """The endless, seeded stream of calls: a latent seed each."""
    i = 0
    while True:
        yield {"i": i, "seed": weights.derive(seed, "decode-latents", i) % 2**31}
        i += 1


class VideoDecode:
    def __init__(self, ctx):
        self.ctx, self.tr, cfg = ctx, ctx.traffic, ctx.config
        vae_cfg = port_vae_config(self.tr["vae"])
        port = video.port_config(cfg)
        self.vae = weights_video.cogvideox_vae_decoder(ctx.seed, self.tr["vae"], ctx.device)
        self.pipe = None
        if ctx.variant != fc.CONTROL:
            from conceptattention_torch.pipeline.video_pipeline import (
                VideoConceptAttentionPipeline,
            )

            dit = weights.cogvideox_dit(ctx.seed, video.sizes(cfg), ctx.device, fc.dtype_of(cfg))
            self.pipe = VideoConceptAttentionPipeline(
                cfg=port, params=dit, dtype=fc.dtype_of(cfg), vae_params=self.vae,
                vae_cfg=vae_cfg, device=ctx.device)

    def requests(self) -> Iterator[Dict]:
        return requests(self.tr, self.ctx.seed)

    def _latents(self, req) -> torch.Tensor:
        """[1, F, C, h, w] N(0, 1) latents from the call's seed, rounded to
        the DiT's dtype as the DiT leaves them."""
        tr, dev = self.tr, self.ctx.device
        shape = (1, tr["frames"], self.tr["vae"]["latent_channels"], tr["height"], tr["width"])
        gen = torch.Generator(dev).manual_seed(req["seed"])
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.to(fc.dtype_of(self.ctx.config))

    def warm(self, req):
        if self.pipe is not None:
            self.pipe.decode_latents(self._latents(req))

    def call(self, req):
        if self.pipe is None:
            return self._control(req)
        return self.pipe.decode_latents(self._latents(req))

    @torch.inference_mode()
    def _control(self, req):
        """The call's frames from the reference in float8."""
        from perfbench.reference import full_f32
        from perfbench.reference.common import fp8, rounded

        with full_f32(), rounded(fp8):
            return self._reference_frames(req).cpu().numpy()

    def _reference_frames(self, req) -> torch.Tensor:
        from perfbench.reference import video_vae as ref

        return ref.to_frames(ref.decode(self.vae, self.tr["vae"], self._latents(req)))

    def _frames(self) -> int:
        f = self.tr["frames"]
        return 1 + (f - 1) * self.tr["vae"]["temporal_compression_ratio"]

    def units(self, req) -> int:
        return self._frames()

    def work(self, req) -> Dict[str, float]:
        convs = roofline_video.cogvideox_decoder_convs(self.tr["vae"], self.tr["frames"],
                                                       self.tr["height"], self.tr["width"])
        return {"flops": sum(roofline_video.conv_flops(c) for c in convs),
                "conv_bound_s": roofline_video.decoder_conv_bound_s(convs)}

    def release(self):
        self.pipe = None

    @torch.inference_mode()
    def check(self, records) -> Dict[str, float]:
        """The reference decodes `check_calls` completed calls' latents drawn
        from the seed: `frame_mae`, the worst call's mean absolute gap of
        its uint8 frames on a 0..1 scale (and `frame_max`, its largest), and
        `frame_mid`, the smallest share of the reference's values strictly
        inside 0..255 (a clip clamped flat would hide every gap)."""
        from perfbench.reference import full_f32

        dev = self.ctx.device
        rng = np.random.default_rng(weights.derive(self.ctx.seed, "decode-check"))
        picks = rng.choice(len(records), size=min(self.tr["check_calls"], len(records)),
                           replace=False)
        mae, worst, mid = [], [], []
        with full_f32():
            for k in sorted(int(x) for x in picks):
                got = torch.as_tensor(records[k]["out"], device=dev).float()
                want = self._reference_frames(records[k]["req"])
                if got.shape != want.shape:  # frames of another shape are no answer
                    mae.append(float("inf"))
                    worst.append(float("inf"))
                    mid.append(0.0)
                    continue
                mid.append(float(((want > 0) & (want < 255)).double().mean()))
                gap = (got - want).abs() / 255.0
                mae.append(float(gap.mean()))
                worst.append(float(gap.max()))
        return {"frame_mae": max(mae), "frame_mae_mean": sum(mae) / len(mae),
                "frame_max": max(worst), "frame_mid": min(mid)}


def setup(ctx) -> VideoDecode:
    return VideoDecode(ctx)
