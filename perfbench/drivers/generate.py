"""Closed-loop image generation: `generate_images` on a batch of prompts
that share their concepts, each image decoded with its heatmaps.

Traffic parameters: width, height, batch, steps, concepts, layer_indices
(null: the program's default), prompt_words / concept_vocab (the words
prompts and concepts are drawn from), check_calls (how many completed calls
the reference recomputes), report (end-to-end metric -> kind).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from perfbench import roofline, weights
from perfbench.drivers import flux_common as fc


def requests(tr: Dict, seed: int) -> Iterator[Dict]:
    """The endless, seeded stream of calls: each call's prompts, shared
    concepts and one noise seed per image."""
    rng = np.random.default_rng(weights.derive(seed, "generate-requests"))
    i = 0
    while True:
        prompts = [" ".join(fc.words(rng, tr["prompt_words"], 6)) for _ in range(tr["batch"])]
        yield {"i": i, "prompts": prompts,
               "concepts": fc.words(rng, tr["concept_vocab"], tr["concepts"]),
               "seeds": [weights.derive(seed, "image", i, j) % 2**31 for j in range(tr["batch"])]}
        i += 1


class Generate:
    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.traffic
        self.dit, self.vae = fc.sizes(ctx.config)
        fc.check_port(ctx.config, self.dit, self.vae)
        self.params, self.ae, self.enc = fc.make_model(ctx, self.dit, self.vae)
        self.pipe = fc.make_pipeline(ctx, self.params, self.ae, self.enc)
        depth = self.dit["depth"]
        self.layers = self.tr["layer_indices"] or list(range(max(0, depth - 4), depth))

    def requests(self) -> Iterator[Dict]:
        return requests(self.tr, self.ctx.seed)

    def _generate(self, req, steps):
        tr = self.tr
        return self.pipe.generate_images(
            req["prompts"], req["concepts"], width=tr["width"], height=tr["height"],
            layer_indices=tr["layer_indices"], return_pil_heatmaps=False,
            num_inference_steps=steps, return_image_array=True, watermark=False,
            seeds=req["seeds"])

    def warm(self, req):
        """Every shape of a call: one Euler step of the batch and its decodes."""
        if self.pipe is not None:
            self._generate(req, 1)

    def call(self, req):
        if self.pipe is None:
            return self._control(req)
        return [(o.image, o.concept_heatmaps, o.cross_attention_maps)
                for o in self._generate(req, self.tr["steps"])]

    @torch.inference_mode()
    def _control(self, req):
        """The call's answers from the reference in float8."""
        from perfbench.reference import full_f32
        from perfbench.reference.common import fp8, rounded

        out = []
        with full_f32(), rounded(fp8):
            for j in range(len(req["prompts"])):
                pixels, hm, cm = self._reference_image(req, j)
                out.append((pixels.to(torch.uint8).cpu().numpy(), hm.cpu().numpy(),
                            cm.cpu().numpy()))
        return out

    def _reference_image(self, req, j):
        """The reference's image j of a call: (pixels [H, W, 3] 0..255,
        concept heatmaps, cross-attention heatmaps [C, h, w])."""
        from perfbench.reference import flux as ref
        from perfbench.reference import flux_vae as ref_vae

        tr, dev = self.tr, self.ctx.device
        gh, gw = fc.latent_grid(self.vae, tr["height"], tr["width"])
        shape = (1, self.vae["z_channels"], 2 * gh, 2 * gw)
        concepts = torch.stack([self.enc.encode_t5([c])[0, 0] for c in req["concepts"]])[None]
        gen = torch.Generator(dev).manual_seed(req["seeds"][j])
        noise = torch.randn(shape, generator=gen, dtype=fc.model_dtype(self.ctx), device=dev)
        prompt = req["prompts"][j]
        lat, hm, cm = ref.generate(self.params, self.dit, noise, self.enc.encode_t5([prompt]),
                                   self.enc.encode_clip([prompt]), concepts,
                                   fc.schedule(tr["steps"]), self.layers)
        pixels = ref_vae.to_pixels(ref_vae.decode(self.ae, self.vae, ref.unpack(lat, gh, gw)))
        return pixels, hm[0], cm[0]

    def units(self, req) -> int:
        return len(req["prompts"])

    def work(self, req) -> Dict[str, float]:
        tr, b = self.tr, len(req["prompts"])
        gh, gw = fc.latent_grid(self.vae, tr["height"], tr["width"])
        p = gh * gw
        t, c, steps = self.ctx.config["t5_max_length"], len(req["concepts"]), tr["steps"]
        fl = roofline.flux_forward_flops(self.dit, b, t, p, c)
        res = tr["height"]
        return {
            "flops": steps * sum(fl.values()) + b * roofline.vae_flops(self.vae, res, True),
            "attn_bound_s": steps * roofline.flux_attention_bound_s(self.dit, b, t, p, c)
            + b * roofline.vae_attention_bound_s(self.vae, res),
            "conv_bound_s": b * roofline.conv_bound_s(roofline.k2_convs(self.vae, res), 2,
                                                      roofline.PEAK_BF16),
        }

    def release(self):
        self.pipe = None

    @torch.inference_mode()
    def check(self, records) -> Dict[str, float]:
        """The reference recomputes every image of `check_calls` completed
        calls drawn from the seed: the gaps (`flux_common.Gaps`) of the
        pixels (on a 0..1 scale) and of each heatmap."""
        from perfbench.reference import full_f32

        tr, dev = self.tr, self.ctx.device
        rng = np.random.default_rng(weights.derive(self.ctx.seed, "generate-check"))
        picks = rng.choice(len(records), size=min(tr["check_calls"], len(records)), replace=False)
        gaps = fc.Gaps()
        with full_f32():
            for k in sorted(int(x) for x in picks):
                req, got = records[k]["req"], records[k]["out"]
                for j in range(len(req["prompts"])):
                    pixels, hm, cm = self._reference_image(req, j)
                    image, heat, cross = (torch.as_tensor(np.asarray(x), device=dev)
                                          for x in got[j])
                    gaps.add("image", image.double() / 255, pixels.double() / 255)
                    gaps.add("heatmap", heat, hm, concept_axis=0)
                    gaps.add("cross", cross, cm, concept_axis=0)
        return gaps.readings()


def setup(ctx) -> Generate:
    return Generate(ctx)
