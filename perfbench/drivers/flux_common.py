"""What the Flux cells share: the configuration file read into the sizes
the weights, the reference and the counts take, checked against the
program's own registry entry, and the request vocabulary."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from perfbench import weights

# The program's convention for the VAE's reparameterization draw: image
# b draws it from a generator seeded seeds[b] + this salt.
VAE_SEED_SALT = 0x7AE << 32
# The variant that runs each cell's control: the plain reference in float8
# (`reference.common.fp8` on the input and weight of every linear layer
# and convolution) in the program's place, on the same requests.
CONTROL = "control"


def sizes(cfg: Dict) -> Tuple[Dict, Dict]:
    """(DiT sizes, VAE sizes) from a configuration file in the published
    config's key names."""
    hd, nh = cfg["attention_head_dim"], cfg["num_attention_heads"]
    dit = {
        "hidden": hd * nh, "num_heads": nh, "head_dim": hd,
        "mlp_hidden": int(hd * nh * cfg["mlp_ratio"]), "in_channels": cfg["in_channels"],
        "context_in_dim": cfg["joint_attention_dim"], "vec_in_dim": cfg["pooled_projection_dim"],
        "depth": cfg["num_layers"], "depth_single": cfg["num_single_layers"],
        "axes_dim": tuple(cfg["axes_dims_rope"]),
    }
    v = cfg["vae"]
    ch = v["block_out_channels"][0]
    vae = {
        "ch": ch, "ch_mult": tuple(c // ch for c in v["block_out_channels"]),
        "num_res_blocks": v["layers_per_block"], "z_channels": v["latent_channels"],
        "in_channels": v["in_channels"], "out_ch": v["out_channels"],
        "scale_factor": v["scaling_factor"], "shift_factor": v["shift_factor"],
    }
    return dit, vae


def check_port(cfg: Dict, dit: Dict, vae: Dict):
    """The program's registry entry for `cfg["port_model"]`, refused where
    its sizes differ from the configuration file's."""
    from conceptattention_torch.config import configs

    spec = configs[cfg["port_model"]]
    p, a = spec.params, spec.ae_params
    got = {
        "hidden": p.hidden_size, "num_heads": p.num_heads, "head_dim": p.head_dim,
        "mlp_hidden": p.mlp_hidden_dim, "in_channels": p.in_channels,
        "context_in_dim": p.context_in_dim, "vec_in_dim": p.vec_in_dim, "depth": p.depth,
        "depth_single": p.depth_single_blocks, "axes_dim": tuple(p.axes_dim),
        "ch": a.ch, "ch_mult": tuple(a.ch_mult), "num_res_blocks": a.num_res_blocks,
        "z_channels": a.z_channels, "in_channels_vae": a.in_channels, "out_ch": a.out_ch,
        "scale_factor": a.scale_factor, "shift_factor": a.shift_factor,
        "guidance_embed": p.guidance_embed, "qkv_bias": p.qkv_bias,
        "t5_max_length": spec.t5_max_length,
    }
    want = {**dit, **{k: v for k, v in vae.items() if k != "in_channels"},
            "in_channels_vae": vae["in_channels"], "guidance_embed": cfg["guidance_embeds"],
            "qkv_bias": cfg["qkv_bias"], "t5_max_length": cfg["t5_max_length"]}
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if bad:
        raise ValueError(f"the program's {cfg['port_model']!r} differs from the configuration "
                         f"file (file, program): {bad}")
    return spec


def dtype_of(cfg: Dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


def model_dtype(ctx) -> torch.dtype:
    """The configuration's dtype; float32 for the witness variant."""
    return torch.float32 if ctx.variant == "f32_plain" else dtype_of(ctx.config)


def make_model(ctx, dit: Dict, vae: Dict):
    """(DiT tree, VAE tree, text encoders) drawn from the run's seed."""
    dev = ctx.device
    params = weights.flux_dit(ctx.seed, dit, dev, model_dtype(ctx))
    ae = weights.flux_vae(ctx.seed, vae, dev)
    enc = weights.SeededTextEncoders(ctx.seed, dev, dit["context_in_dim"], dit["vec_in_dim"],
                                     ctx.config["t5_max_length"])
    return params, ae, enc


def make_pipeline(ctx, params, ae, enc):
    """The program's pipeline on the benchmark's trees, or None for the
    control (`CONTROL`), which puts the reference in the program's place.
    Variants besides "program": "int8", the program's own int8 path (w8a8
    stacks, int8 q and k), whose readings `PERF.md` keeps; "f32_plain", a
    witness for the reference, the program's plain attention path in
    float32."""
    from conceptattention_torch.pipeline.concept_pipeline import ConceptAttentionFluxPipeline

    if ctx.variant == CONTROL:
        return None
    kw = {"attention_backend": "sdpa" if ctx.variant == "f32_plain" else "fused"}
    if ctx.variant == "int8":
        from conceptattention_torch.ops.quant import quantize_flux_params

        params = quantize_flux_params(params, mode="w8a8")
        kw["int8_qk"] = True
    return ConceptAttentionFluxPipeline(
        ctx.config["port_model"], dtype=model_dtype(ctx), params=params, ae_params=ae,
        text_encoders=enc, device=ctx.device, **kw)


def latent_grid(vae: Dict, height: int, width: int) -> Tuple[int, int]:
    """The packed token grid (h, w) of an image: latents of side 2 ceil(side / 2f)
    for the VAE's downsampling factor f, packed 2 x 2."""
    f = 2 ** (len(vae["ch_mult"]) - 1)
    return -(-height // (2 * f)), -(-width // (2 * f))


def words(rng: np.random.Generator, vocab, n: int):
    return [str(w) for w in rng.choice(vocab, size=n, replace=False)]


def schedule(steps: int):
    """The rectified-flow schedule 1 -> 0 over steps + 1 values, not
    time-shifted, as flux-schnell's is."""
    return [float(t) for t in np.linspace(1.0, 0.0, steps + 1)]


class Gaps:
    """Each answer's gaps from the reference, folded over the answers:
    `<name>_<stat>` is the worst answer's and `<name>_<stat>_mean` the mean
    over the answers. Stats: `rms` and `mae` (root-mean-square and mean
    absolute difference), `max` (largest absolute difference), `rel_rms`
    (the RMS difference over the reference's RMS) and, for heatmaps
    (`concept_axis` given), `flip`, the share of patches whose strongest
    concept differs."""

    def __init__(self):
        self.items: Dict[str, list] = {}

    def add(self, name: str, got: torch.Tensor, want: torch.Tensor, concept_axis=None) -> None:
        d = got.double() - want.double()
        rms = d.pow(2).mean().sqrt()
        vals = {"rms": rms, "mae": d.abs().mean(), "max": d.abs().max(),
                "rel_rms": rms / want.double().pow(2).mean().sqrt()}
        if concept_axis is not None:
            vals["flip"] = (got.argmax(concept_axis) != want.argmax(concept_axis)).double().mean()
        for k, v in vals.items():
            self.items.setdefault(f"{name}_{k}", []).append(float(v))

    def readings(self) -> Dict[str, float]:
        out = {}
        for k, v in self.items.items():
            out[k] = max(v)
            out[f"{k}_mean"] = sum(v) / len(v)
        return out
