"""Closed-loop HunyuanVideo denoising: `generate_video` calls of a fixed
number of flow-matching Euler steps at the published 540p clip size,
embedded guidance at batch 1, no decode.

Traffic parameters: frames, height, width (latent sizes), steps, guidance,
concepts, text_valid ([least, most] valid text slots of a prompt, uniform),
layer_indices, prompt_words / concept_vocab, check_calls, report.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from perfbench import roofline, roofline_video, weights, weights_video
from perfbench.drivers import flux_common as fc
from perfbench.drivers.video import requests as video_requests

# The only (patch_size, patch_size_t) the program packs: 2 x 2, a frame each.
PATCH = (2, 1)
# The program's preset attributes and the configuration file's keys they hold.
PRESET_KEYS = {
    "hidden_size": lambda c: c["attention_head_dim"] * c["num_attention_heads"],
    "num_heads": lambda c: c["num_attention_heads"],
    "mlp_ratio": lambda c: c["mlp_ratio"],
    "depth": lambda c: c["num_layers"],
    "depth_single_blocks": lambda c: c["num_single_layers"],
    "num_refiner_layers": lambda c: c["num_refiner_layers"],
    "axes_dim": lambda c: tuple(c["rope_axes_dim"]),
    "theta": lambda c: c["rope_theta"],
    "guidance_embed": lambda c: c["guidance_embeds"],
    "context_in_dim": lambda c: c["text_embed_dim"],
    "vec_in_dim": lambda c: c["pooled_projection_dim"],
    "latent_channels": lambda c: c["in_channels"],
    "text_len": lambda c: c["text_len"],
    "flow_shift": lambda c: c["shift"],
}


def sizes(cfg: Dict) -> Dict:
    """The Flux sizes (`roofline.flux_forward_flops`, `weights.flux_dit`) of
    the configuration file, and the refiner's depth."""
    hd, nh = cfg["attention_head_dim"], cfg["num_attention_heads"]
    p = cfg["patch_size"]
    return {"hidden": hd * nh, "num_heads": nh, "head_dim": hd,
            "mlp_hidden": int(hd * nh * cfg["mlp_ratio"]),
            "in_channels": cfg["in_channels"] * p * p * cfg["patch_size_t"],
            "context_in_dim": cfg["text_embed_dim"], "vec_in_dim": cfg["pooled_projection_dim"],
            "depth": cfg["num_layers"], "depth_single": cfg["num_single_layers"],
            "axes_dim": tuple(cfg["rope_axes_dim"]), "theta": cfg["rope_theta"],
            "num_refiner_layers": cfg["num_refiner_layers"]}


def port_config(cfg: Dict):
    """The program's `hunyuanvideo_config()` (imported first, so a program
    without it fails before any weight is drawn), refused where it differs
    from the file; `port_preset` null builds one from the file instead."""
    from conceptattention_torch.models.video import hunyuan

    if (cfg["patch_size"], cfg["patch_size_t"]) != PATCH:
        raise ValueError(f"the program packs patches of {PATCH} (patch_size, patch_size_t)")
    want = {k: f(cfg) for k, f in PRESET_KEYS.items()}
    if not cfg.get("port_preset"):
        return hunyuan.HunyuanVideoConfig(**want)
    port = getattr(hunyuan, cfg["port_preset"])()
    bad = {k: (v, getattr(port, k)) for k, v in want.items() if getattr(port, k) != v}
    if bad:
        raise ValueError(f"the program's {cfg['port_preset']} differs from the file: {bad}")
    return port


class LlmTextStates(weights.SeededTextEncoders):
    """Stands in for LLaVA-LLaMA-3-8B and CLIP-L (no weights of either are in
    the repository): `encode_llm` gives each text's states [slots, width]
    (N(0, 1), bf16-rounded, drawn from the seed and the text; the padded
    slots hold states too, as a language model's do) and its valid length,
    uniform in `valid` from the seed and the text; `encode_clip` the pooled
    vector."""

    def __init__(self, seed: int, device, width: int, clip_dim: int, slots: int,
                 valid: Tuple[int, int]):
        super().__init__(seed, device, width, clip_dim, slots)
        self.valid = valid

    def valid_length(self, text: str) -> int:
        lo, hi = self.valid
        return lo + weights.derive(self.seed, "llm-valid", text) % (hi - lo + 1)

    def encode_llm(self, prompts: List[str]) -> Tuple[torch.Tensor, List[int]]:
        states = torch.stack([self._draw(p, "llm", (self.t5_max_length, self.t5_dim))
                              for p in prompts])
        return states, [self.valid_length(p) for p in prompts]


def requests(tr: Dict, seed: int) -> Iterator[Dict]:
    """The endless, seeded stream of calls: a prompt, concepts and a noise
    seed each (the CogVideoX cell's generator, drawn under another name)."""
    return video_requests(tr, weights.derive(seed, "hunyuan"))


class HunyuanVideo:
    def __init__(self, ctx):
        self.ctx, self.tr, cfg = ctx, ctx.traffic, ctx.config
        port = port_config(cfg)
        self.sz = sizes(cfg)
        dt = fc.dtype_of(cfg)
        self.params = weights_video.hunyuan_dit(ctx.seed, self.sz, ctx.device, dt)
        self.enc = LlmTextStates(ctx.seed, ctx.device, cfg["text_embed_dim"],
                                 cfg["pooled_projection_dim"], cfg["text_len"],
                                 tuple(self.tr["text_valid"]))
        self.pipe = None
        if ctx.variant != fc.CONTROL:
            from conceptattention_torch.pipeline.video_pipeline import (
                VideoConceptAttentionPipeline,
            )

            self.pipe = VideoConceptAttentionPipeline(cfg=port, params=self.params,
                                                      text_encoders=self.enc, dtype=dt,
                                                      device=ctx.device)
        self.layers = self.tr["layer_indices"] or list(range(self.sz["depth"]))

    def requests(self) -> Iterator[Dict]:
        return requests(self.tr, self.ctx.seed)

    def _generate(self, req, steps):
        tr = self.tr
        return self.pipe.generate_video(
            req["prompt"], req["concepts"], num_frames=tr["frames"], height=tr["height"],
            width=tr["width"], num_inference_steps=steps, guidance_scale=tr["guidance"],
            layer_indices=tr["layer_indices"], seed=req["seed"])

    def warm(self, req):
        if self.pipe is not None:
            self._generate(req, self.tr["steps"])

    def call(self, req):
        """The program's answers; the control's are made in `check`: one call
        of the reference takes longer than the harness lets a call take."""
        if self.pipe is None:
            return fc.CONTROL
        out = self._generate(req, self.tr["steps"])
        return out.video_latents.float().cpu(), out.concept_heatmaps

    def _reference_call(self, req):
        """The reference's answers to a call over the full text slots and
        their mask: (latents [1, F, C, H, W], heatmaps [C, F, h, w])."""
        from perfbench.reference import hunyuan_video as ref

        tr, dev, cfg = self.tr, self.ctx.device, self.ctx.config
        shape = (1, tr["frames"], cfg["in_channels"], tr["height"], tr["width"])
        gen = torch.Generator(dev).manual_seed(req["seed"])
        lat0 = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        lat0 = lat0.to(fc.dtype_of(cfg)).float()
        states, lengths = self.enc.encode_llm([req["prompt"]])
        mask = torch.arange(states.shape[1], device=dev) < lengths[0]
        con = torch.stack([self.enc.encode_llm([c])[0][0, 0] for c in req["concepts"]])[None]
        return ref.generate(self.params, self.sz, lat0, states, mask,
                            self.enc.encode_clip([req["prompt"]]), con, tr["steps"],
                            cfg["shift"], tr["guidance"], self.layers)

    def units(self, req) -> int:
        return self.tr["steps"]

    def work(self, req) -> Dict[str, float]:
        tr = self.tr
        t = self.enc.valid_length(req["prompt"])
        p = tr["frames"] * (tr["height"] // 2) * (tr["width"] // 2)
        c = tr["concepts"]
        flops = roofline_video.hunyuan_forward_flops(self.sz, t, p, c)
        return {"flops": tr["steps"] * sum(flops.values()),
                "attn_bound_s": tr["steps"] * roofline.flux_attention_bound_s(self.sz, 1, t, p, c)}

    def release(self):
        self.pipe = None

    @torch.inference_mode()
    def check(self, records) -> Dict[str, float]:
        """The reference recomputes `check_calls` completed calls drawn from
        the seed: the gaps (`flux_common.Gaps`) of the latents and of the
        heatmaps. For the control, the answers are the reference's in
        float8, made here."""
        from perfbench.reference import full_f32
        from perfbench.reference.common import fp8, rounded

        dev = self.ctx.device
        rng = np.random.default_rng(weights.derive(self.ctx.seed, "hunyuan-check"))
        picks = rng.choice(len(records), size=min(self.tr["check_calls"], len(records)),
                           replace=False)
        gaps = fc.Gaps()
        with full_f32():
            for k in sorted(int(x) for x in picks):
                req, got = records[k]["req"], records[k]["out"]
                if isinstance(got, str):  # fc.CONTROL
                    with rounded(fp8):
                        got = self._reference_call(req)
                lat, heat = self._reference_call(req)
                gaps.add("latent", torch.as_tensor(got[0], device=dev), lat)
                gaps.add("heatmap", torch.as_tensor(got[1], device=dev), heat, concept_axis=0)
        return gaps.readings()


def setup(ctx) -> HunyuanVideo:
    return HunyuanVideo(ctx)
