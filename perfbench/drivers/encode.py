"""Closed-loop real-image encoding: `encode_images` on a batch of images,
each with its own concepts and caption, stopped after the double blocks.

Traffic parameters: width, height, batch, concepts (per image),
num_samples, num_steps, noise_timestep, layer_indices, pool (synthetic
images made from the seed and taken in turn), prompt_words / concept_vocab,
check_images (how many completed images the reference recomputes), report.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import roofline, weights
from perfbench.drivers import flux_common as fc


def synthetic_images(seed: int, n: int, height: int, width: int):
    """`n` smooth random RGB images (uint8 HWC): a coarse field upsampled
    and a finer one over it, squashed to 0..255."""
    gen = torch.Generator("cpu").manual_seed(weights.derive(seed, "images"))
    out = []
    for _ in range(n):
        coarse = F.interpolate(torch.randn((1, 3, 6, 6), generator=gen), size=(height, width),
                               mode="bicubic", align_corners=False)
        fine = F.interpolate(torch.randn((1, 3, 48, 48), generator=gen), size=(height, width),
                             mode="bilinear", align_corners=False)
        x = torch.sigmoid(1.5 * coarse + 0.5 * fine)[0].permute(1, 2, 0)
        out.append((x * 255).round().to(torch.uint8).numpy())
    return out


def requests(tr: Dict, seed: int) -> Iterator[Dict]:
    """The endless, seeded stream of calls: images of the pool in turn, each
    with its own concepts, caption and noise seed."""
    rng = np.random.default_rng(weights.derive(seed, "encode-requests"))
    i, b = 0, tr["batch"]
    while True:
        yield {"i": i, "images": [(i * b + j) % tr["pool"] for j in range(b)],
               "concepts": [fc.words(rng, tr["concept_vocab"], tr["concepts"]) for _ in range(b)],
               "prompts": [" ".join(fc.words(rng, tr["prompt_words"], 8)) for _ in range(b)],
               "seeds": [weights.derive(seed, "encode", i, j) % 2**31 for j in range(b)]}
        i += 1


class Encode:
    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.traffic
        self.dit, self.vae = fc.sizes(ctx.config)
        fc.check_port(ctx.config, self.dit, self.vae)
        self.params, self.ae, self.enc = fc.make_model(ctx, self.dit, self.vae)
        self.pipe = fc.make_pipeline(ctx, self.params, self.ae, self.enc)
        self.images = synthetic_images(ctx.seed, self.tr["pool"], self.tr["height"],
                                       self.tr["width"])
        depth = self.dit["depth"]
        self.layers = self.tr["layer_indices"] or list(range(max(0, depth - 4), depth))

    def requests(self) -> Iterator[Dict]:
        return requests(self.tr, self.ctx.seed)

    def call(self, req):
        if self.pipe is None:
            return self._control(req)
        tr = self.tr
        outs = self.pipe.encode_images(
            [self.images[k] for k in req["images"]], req["concepts"], prompts=req["prompts"],
            width=tr["width"], height=tr["height"], layer_indices=tr["layer_indices"],
            num_samples=tr["num_samples"], num_steps=tr["num_steps"],
            noise_timestep=tr["noise_timestep"], return_pil_heatmaps=False, seeds=req["seeds"])
        return [(o.concept_heatmaps, o.cross_attention_maps) for o in outs]

    def warm(self, req):
        if self.pipe is not None:
            self.call(req)

    @torch.inference_mode()
    def _control(self, req):
        """The call's answers from the reference in float8."""
        from perfbench.reference import full_f32
        from perfbench.reference.common import fp8, rounded

        out = []
        with full_f32(), rounded(fp8):
            for j in range(len(req["images"])):
                hm, cm = self._reference_image(req, j)
                out.append((hm.cpu().numpy(), cm.cpu().numpy()))
        return out

    def _reference_image(self, req, j):
        """The reference's maps of image j of a call: (concept heatmaps,
        cross-attention heatmaps), each [C, h, w]."""
        from perfbench.reference import flux as ref
        from perfbench.reference import flux_vae as ref_vae

        tr, dev = self.tr, self.ctx.device
        t = fc.schedule(tr["num_steps"])[tr["noise_timestep"]]
        gh, gw = fc.latent_grid(self.vae, tr["height"], tr["width"])
        z_shape = (1, self.vae["z_channels"], 2 * gh, 2 * gw)
        seed = req["seeds"][j]
        img = torch.from_numpy(self.images[req["images"][j]]).to(dev)
        x = 2.0 * (img.permute(2, 0, 1)[None].float() / 255.0) - 1.0
        x = F.interpolate(x, size=(tr["height"], tr["width"]), mode="bilinear", antialias=True,
                          align_corners=False)
        gen = torch.Generator(dev).manual_seed(fc.VAE_SEED_SALT + seed)
        eps = torch.randn(z_shape, generator=gen, dtype=torch.float32, device=dev)
        z = ref_vae.encode(self.ae, self.vae, x, eps)
        gen = torch.Generator(dev).manual_seed(seed)
        noise = torch.randn(z_shape, generator=gen, dtype=fc.model_dtype(self.ctx), device=dev)
        concepts = torch.stack([self.enc.encode_t5([c])[0, 0] for c in req["concepts"][j]])[None]
        hm, cm = ref.encode_maps(self.params, self.dit, z, noise, t,
                                 self.enc.encode_t5([req["prompts"][j]]), concepts, self.layers)
        return hm[0], cm[0]

    def units(self, req) -> int:
        return len(req["images"])

    def work(self, req) -> Dict[str, float]:
        tr, b = self.tr, len(req["images"]) * self.tr["num_samples"]
        gh, gw = fc.latent_grid(self.vae, tr["height"], tr["width"])
        p = gh * gw
        t, c = self.ctx.config["t5_max_length"], tr["concepts"]
        fl = roofline.flux_forward_flops(self.dit, b, t, p, c, stop_after_double=True)
        convs, _ = roofline.vae_layers(self.vae, tr["height"], decoder=False)
        return {
            "flops": sum(fl.values()) + len(req["images"]) * roofline.vae_flops(
                self.vae, tr["height"], False),
            "attn_bound_s": roofline.flux_attention_bound_s(self.dit, b, t, p, c, True),
            "conv_bound_s": len(req["images"]) * roofline.conv_bound_s(convs, 4,
                                                                       roofline.PEAK_F32),
        }

    def release(self):
        self.pipe = None

    @torch.inference_mode()
    def check(self, records) -> Dict[str, float]:
        """The reference recomputes `check_images` completed images drawn
        from the seed: the gaps of each heatmap (`flux_common.Gaps`)."""
        from perfbench.reference import full_f32

        tr, dev = self.tr, self.ctx.device
        done = [(k, j) for k, r in enumerate(records) for j in range(len(r["req"]["images"]))]
        rng = np.random.default_rng(weights.derive(self.ctx.seed, "encode-check"))
        picks = rng.choice(len(done), size=min(tr["check_images"], len(done)), replace=False)
        gaps = fc.Gaps()
        with full_f32():
            for n in sorted(int(x) for x in picks):
                k, j = done[n]
                heat, cross = records[k]["out"][j]
                hm, cm = self._reference_image(records[k]["req"], j)
                gaps.add("heatmap", torch.as_tensor(heat, device=dev), hm, concept_axis=0)
                gaps.add("cross", torch.as_tensor(cross, device=dev), cm, concept_axis=0)
        return gaps.readings()


def setup(ctx) -> Encode:
    return Encode(ctx)
