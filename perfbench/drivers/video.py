"""Closed-loop video denoising: `generate_video` calls of a fixed number of
classifier-free-guided DDIM steps at the published clip size, no decode.

Traffic parameters: frames, height, width (latent sizes), steps, guidance,
scheduler, concepts, prompt_words / concept_vocab, check_calls, report.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from perfbench import roofline, weights
from perfbench.drivers import flux_common as fc


def sizes(cfg: Dict) -> Dict:
    hd, nh = cfg["attention_head_dim"], cfg["num_attention_heads"]
    return {"hidden": hd * nh, "num_heads": nh, "head_dim": hd, "num_layers": cfg["num_layers"],
            "time_embed_dim": cfg["time_embed_dim"], "in_channels": cfg["in_channels"],
            "out_channels": cfg["out_channels"], "patch_size": cfg["patch_size"],
            "text_embed_dim": cfg["text_embed_dim"], "norm_eps": cfg["norm_eps"],
            "max_text_seq_length": cfg["max_text_seq_length"]}


def port_config(cfg: Dict):
    """The program's CogVideoX config: its preset `port_preset` (refused
    where it differs from the file), or one built from the file."""
    from conceptattention_torch.models.video import dit

    keys = ("num_attention_heads", "attention_head_dim", "in_channels", "out_channels",
            "time_embed_dim", "text_embed_dim", "num_layers", "sample_width", "sample_height",
            "sample_frames", "patch_size", "temporal_compression_ratio", "max_text_seq_length",
            "norm_eps", "spatial_interpolation_scale", "temporal_interpolation_scale",
            "use_rotary_positional_embeddings", "flip_sin_to_cos", "freq_shift")
    want = {k: cfg[k] for k in keys}
    if not cfg.get("port_preset"):
        return dit.CogVideoXConfig(**want)
    port = getattr(dit, cfg["port_preset"])()
    bad = {k: (want[k], getattr(port, k)) for k in keys if getattr(port, k) != want[k]}
    if bad:
        raise ValueError(f"the program's {cfg['port_preset']} differs from the file: {bad}")
    return port


def requests(tr: Dict, seed: int) -> Iterator[Dict]:
    """The endless, seeded stream of calls: a prompt, concepts and a noise seed each."""
    rng = np.random.default_rng(weights.derive(seed, "video-requests"))
    i = 0
    while True:
        yield {"i": i, "prompt": " ".join(fc.words(rng, tr["prompt_words"], 8)),
               "concepts": fc.words(rng, tr["concept_vocab"], tr["concepts"]),
               "seed": weights.derive(seed, "clip", i) % 2**31}
        i += 1


class Video:
    def __init__(self, ctx):
        from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline

        self.ctx, self.tr, cfg = ctx, ctx.traffic, ctx.config
        self.sz = sizes(cfg)
        port = port_config(cfg)
        dt = fc.dtype_of(cfg)
        self.params = weights.cogvideox_dit(ctx.seed, self.sz, ctx.device, dt)
        self.enc = weights.SeededTextEncoders(ctx.seed, ctx.device, cfg["text_embed_dim"], 768,
                                              cfg["max_text_seq_length"])
        self.pipe = None if ctx.variant == fc.CONTROL else VideoConceptAttentionPipeline(
            cfg=port, params=self.params, text_encoders=self.enc, dtype=dt, device=ctx.device,
            quantize="w8a8" if ctx.variant == "int8" else False)
        self.layers = self.tr["layer_indices"] or list(range(self.sz["num_layers"]))

    def requests(self) -> Iterator[Dict]:
        return requests(self.tr, self.ctx.seed)

    def _generate(self, req, steps):
        tr = self.tr
        return self.pipe.generate_video(
            req["prompt"], req["concepts"], negative_prompt="", num_frames=tr["frames"],
            height=tr["height"], width=tr["width"], num_inference_steps=steps,
            guidance_scale=tr["guidance"], layer_indices=tr["layer_indices"],
            scheduler=tr["scheduler"], seed=req["seed"], decode=False)

    def warm(self, req):
        """Every shape of a call: one guided step (each step is the same work)."""
        if self.pipe is not None:
            self._generate(req, 1)

    def call(self, req):
        if self.pipe is None:
            return self._control(req)
        out = self._generate(req, self.tr["steps"])
        return out.video_latents.float().cpu(), out.concept_heatmaps

    @torch.inference_mode()
    def _control(self, req):
        """The call's answers from the reference in float8."""
        from perfbench.reference import full_f32
        from perfbench.reference.common import fp8, rounded

        with full_f32(), rounded(fp8):
            lat, heat = self._reference_call(req)
        return lat.cpu(), heat.cpu().numpy()

    def _reference_call(self, req):
        """The reference's answers to a call: (latents [1, F, C, H, W],
        heatmaps [C, F, h, w])."""
        from perfbench.reference import video as ref

        tr, dev = self.tr, self.ctx.device
        slots = self.sz["max_text_seq_length"]
        shape = (1, tr["frames"], self.sz["in_channels"], tr["height"], tr["width"])
        gen = torch.Generator(dev).manual_seed(req["seed"])
        lat0 = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        lat0 = lat0.to(fc.dtype_of(self.ctx.config)).float()
        con = torch.stack([self.enc.encode_t5([c])[0, 0] for c in req["concepts"]])
        con = torch.cat([con, con.new_zeros((slots - con.shape[0], con.shape[1]))])[None]
        return ref.generate(self.params, self.sz, lat0,
                            self.enc.encode_t5([req["prompt"]])[:, :slots],
                            self.enc.encode_t5([""])[:, :slots], con, len(req["concepts"]),
                            tr["steps"], tr["guidance"], self.layers)

    def units(self, req) -> int:
        return self.tr["steps"]

    def _tokens(self):
        tr, p = self.tr, self.sz["patch_size"]
        return (self.sz["max_text_seq_length"], tr["frames"] * (tr["height"] // p)
                * (tr["width"] // p), self.sz["max_text_seq_length"])

    def work(self, req) -> Dict[str, float]:
        t, p, c = self._tokens()
        steps = self.tr["steps"]
        return {"flops": steps * sum(roofline.video_forward_flops(self.sz, 2, t, p, c).values()),
                "attn_bound_s": steps * roofline.video_attention_bound_s(self.sz, 2, t, p, c)}

    def release(self):
        self.pipe = None

    @torch.inference_mode()
    def check(self, records) -> Dict[str, float]:
        """The reference recomputes `check_calls` completed calls drawn from
        the seed: the gaps (`flux_common.Gaps`) of the latents and of the
        heatmaps, which the concept stream alone makes."""
        from perfbench.reference import full_f32

        tr, dev = self.tr, self.ctx.device
        rng = np.random.default_rng(weights.derive(self.ctx.seed, "video-check"))
        picks = rng.choice(len(records), size=min(tr["check_calls"], len(records)), replace=False)
        gaps = fc.Gaps()
        with full_f32():
            for k in sorted(int(x) for x in picks):
                lat_got, heat_got = records[k]["out"]
                lat, heat = self._reference_call(records[k]["req"])
                gaps.add("latent", lat_got.to(dev), lat)
                gaps.add("heatmap", torch.as_tensor(heat_got, device=dev), heat,
                         concept_axis=0)
        return gaps.readings()


def setup(ctx) -> Video:
    return Video(ctx)
