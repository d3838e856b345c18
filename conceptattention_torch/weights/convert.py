"""Safetensors checkpoints -> the port's parameter trees.

Counterpart of the JAX package's `weights/convert.py` (its flux, VAE,
CogVideoX, ViT and SD-UNet converters; the open_clip ones live in
`models/clip_vit.py`). Key names are the official ones: the Flux DiT's
(`double_blocks.0.img_attn.qkv.weight`, `single_blocks.5.linear1.bias`,
...), its VAE's (`encoder.down.0.block.1.norm1.weight`, ...), diffusers'
CogVideoX transformer and VAE, the timm / Chefer / DINO ViT's
(`blocks.3.attn.qkv.weight`, ...) and diffusers' `UNet2DConditionModel`
(`down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.weight`, ...).

The trees are the JAX package's, leaf for leaf: linear weights transposed
to [in, out], the fused qkv weight as [D, 3, H, Dh], single-block `linear1`
and `linear2` split at 3*hidden, layers stacked along a leading depth axis,
convolution weights as they are (OIHW, OIDHW).

`load_safetensors` reads the file format itself (an 8-byte little-endian
header length, a JSON header, then the raw tensors) over a copy-on-write
memory map: no `safetensors` package, and bf16 stays bf16. The converters
take one tensor at a time into `dtype`, on the device the state dict lies
on, and fill each depth stack in place, so no f32 copy of the state dict and
no second copy of a stack exists.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from typing import Any, Dict, Mapping, Optional, Union

import torch

from conceptattention_torch.config import AutoEncoderConfig, FluxConfig
from conceptattention_torch.models.flux.params import stack_layers

DeviceLike = Union[str, torch.device]

_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{key: CPU tensor} of a `.safetensors` file, each a view of a private
    memory map of the file (pages are read when a tensor is first used)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = f.seek(0, 2)
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    base = 8 + n
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {key} has unsupported dtype {info['dtype']}")
        dtype = _DTYPES[info["dtype"]]
        shape = list(info["shape"])
        start, end = info["data_offsets"]
        count = math.prod(shape)
        if end - start != count * dtype.itemsize or base + end > size:
            raise ValueError(f"{path}: {key} spans bytes {start}..{end}, not {shape} {info['dtype']}")
        if count == 0:
            out[key] = torch.empty(shape, dtype=dtype)
        else:
            out[key] = torch.frombuffer(mm, dtype=dtype, count=count, offset=base + start).reshape(shape)
    return out


class StateDict:
    """A state dict read one tensor at a time into `dtype` on `device` (the
    source's by default), recording the keys it used (`unused()` reports
    the rest)."""

    def __init__(self, sd: Mapping[str, Any], dtype: torch.dtype,
                 device: Optional[DeviceLike] = None):
        self.sd = sd
        self.dtype = dtype
        self.device = device
        self.used = set()

    def __call__(self, key: str, transpose: bool = False,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The tensor at `key` (transposed if asked) as a new contiguous
        tensor of `dtype` (the reader's by default) on the reader's device:
        copied there as stored, then transposed and cast there."""
        self.used.add(key)
        x = torch.as_tensor(self.sd[key])
        if self.device is not None:
            x = x.to(self.device)
        if transpose:
            x = x.t()
        return torch.empty(x.shape, dtype=dtype or self.dtype, device=x.device).copy_(x)

    def linear(self, key: str) -> Dict[str, torch.Tensor]:
        p = {"w": self(f"{key}.weight", transpose=True)}
        if f"{key}.bias" in self.sd:
            p["b"] = self(f"{key}.bias")
        return p

    def unused(self):
        return sorted(set(self.sd.keys()) - self.used)


def _mlp_embedder(s: StateDict, key: str) -> Dict[str, Any]:
    return {"in": s.linear(f"{key}.in_layer"), "out": s.linear(f"{key}.out_layer")}


def convert_flux_state_dict(
    sd: Mapping[str, Any], cfg: FluxConfig, dtype: torch.dtype = torch.bfloat16,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Any]:
    """Flux DiT state dict -> the port's parameter tree on `device` (the
    state dict's by default)."""
    s = StateDict(sd, dtype, device)
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.hidden_size

    def qkv(lin: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        p = {"w": lin["w"].reshape(d, 3, h, hd)}
        if "b" in lin:
            p["b"] = lin["b"].reshape(3, h, hd)
        return p

    def double_layer(i: int) -> Dict[str, Any]:
        base = f"double_blocks.{i}"
        p: Dict[str, Any] = {}
        for stream, attn in (("img", "img_attn"), ("txt", "txt_attn")):
            p[f"{stream}_mod"] = s.linear(f"{base}.{stream}_mod.lin")
            p[f"{stream}_qkv"] = qkv(s.linear(f"{base}.{attn}.qkv"))
            p[f"{stream}_qnorm"] = s(f"{base}.{attn}.norm.query_norm.scale")
            p[f"{stream}_knorm"] = s(f"{base}.{attn}.norm.key_norm.scale")
            p[f"{stream}_proj"] = s.linear(f"{base}.{attn}.proj")
            p[f"{stream}_mlp_in"] = s.linear(f"{base}.{stream}_mlp.0")
            p[f"{stream}_mlp_out"] = s.linear(f"{base}.{stream}_mlp.2")
        return p

    def single_layer(i: int) -> Dict[str, Any]:
        base = f"single_blocks.{i}"
        l1 = s.linear(f"{base}.linear1")
        l2 = s.linear(f"{base}.linear2")
        return {
            "mod": s.linear(f"{base}.modulation.lin"),
            "qkv": qkv({"w": l1["w"][:, : 3 * d], "b": l1["b"][: 3 * d]}),
            "mlp_in": {"w": l1["w"][:, 3 * d :], "b": l1["b"][3 * d :]},
            "proj": {"w": l2["w"][:d], "b": l2["b"]},
            "mlp_out": {"w": l2["w"][d:]},
            "qnorm": s(f"{base}.norm.query_norm.scale"),
            "knorm": s(f"{base}.norm.key_norm.scale"),
        }

    params: Dict[str, Any] = {
        "img_in": s.linear("img_in"),
        "txt_in": s.linear("txt_in"),
        "time_in": _mlp_embedder(s, "time_in"),
        "vector_in": _mlp_embedder(s, "vector_in"),
        "final": {
            "adaln": s.linear("final_layer.adaLN_modulation.1"),
            "linear": s.linear("final_layer.linear"),
        },
    }
    if cfg.guidance_embed:
        params["guidance_in"] = _mlp_embedder(s, "guidance_in")
    params["double"] = stack_layers(double_layer, cfg.depth)
    params["single"] = stack_layers(single_layer, cfg.depth_single_blocks)
    return params


def _conv(s: StateDict, key: str) -> Dict[str, torch.Tensor]:
    return {"w": s(f"{key}.weight"), "b": s(f"{key}.bias")}


def _gn(s: StateDict, key: str) -> Dict[str, torch.Tensor]:
    return {"scale": s(f"{key}.weight"), "bias": s(f"{key}.bias")}


def _resnet(s: StateDict, key: str) -> Dict[str, Any]:
    p = {
        "norm1": _gn(s, f"{key}.norm1"),
        "conv1": _conv(s, f"{key}.conv1"),
        "norm2": _gn(s, f"{key}.norm2"),
        "conv2": _conv(s, f"{key}.conv2"),
    }
    if f"{key}.nin_shortcut.weight" in s.sd:
        p["nin_shortcut"] = _conv(s, f"{key}.nin_shortcut")
    return p


def _attn(s: StateDict, key: str) -> Dict[str, Any]:
    return {"norm": _gn(s, f"{key}.norm"), **{n: _conv(s, f"{key}.{n}") for n in
                                             ("q", "k", "v", "proj_out")}}


def convert_autoencoder_state_dict(
    sd: Mapping[str, Any], cfg: AutoEncoderConfig, dtype: torch.dtype = torch.float32,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Any]:
    """Flux VAE state dict -> the port's parameter tree on `device` (the
    state dict's by default)."""
    s = StateDict(sd, dtype, device)
    n_levels = len(cfg.ch_mult)
    down = []
    for i in range(n_levels):
        level: Dict[str, Any] = {
            "block": [_resnet(s, f"encoder.down.{i}.block.{j}") for j in range(cfg.num_res_blocks)]
        }
        if i != n_levels - 1:
            level["downsample"] = {"conv": _conv(s, f"encoder.down.{i}.downsample.conv")}
        down.append(level)
    enc = {
        "conv_in": _conv(s, "encoder.conv_in"),
        "down": down,
        "mid_block_1": _resnet(s, "encoder.mid.block_1"),
        "mid_attn_1": _attn(s, "encoder.mid.attn_1"),
        "mid_block_2": _resnet(s, "encoder.mid.block_2"),
        "norm_out": _gn(s, "encoder.norm_out"),
        "conv_out": _conv(s, "encoder.conv_out"),
    }
    up = []
    for i in range(n_levels):
        level = {
            "block": [_resnet(s, f"decoder.up.{i}.block.{j}") for j in range(cfg.num_res_blocks + 1)]
        }
        if i != 0:
            level["upsample"] = {"conv": _conv(s, f"decoder.up.{i}.upsample.conv")}
        up.append(level)
    dec = {
        "conv_in": _conv(s, "decoder.conv_in"),
        "mid_block_1": _resnet(s, "decoder.mid.block_1"),
        "mid_attn_1": _attn(s, "decoder.mid.attn_1"),
        "mid_block_2": _resnet(s, "decoder.mid.block_2"),
        "up": up,
        "norm_out": _gn(s, "decoder.norm_out"),
        "conv_out": _conv(s, "decoder.conv_out"),
    }
    return {"encoder": enc, "decoder": dec}


def convert_cogvideox_state_dict(
    sd: Mapping[str, Any], cfg, dtype: torch.dtype = torch.bfloat16
) -> Dict[str, Any]:
    """diffusers `CogVideoXTransformer3DModel` state dict -> the port's tree
    (`models/video/dit.py`): `patch_embed.proj` (the 2x2 patch conv) as a
    [C*p*p, D] matmul weight in (c, dy, dx) order, separate to_q / to_k /
    to_v fused along the output axis, blocks stacked by depth."""
    s = StateDict(sd, dtype)

    def ln(key):
        return {"w": s(f"{key}.weight"), "b": s(f"{key}.bias")}

    def block(i):
        base = f"transformer_blocks.{i}"
        qkv = {"w": torch.cat([s(f"{base}.attn1.to_{x}.weight", transpose=True) for x in "qkv"], 1)}
        if f"{base}.attn1.to_q.bias" in s.sd:
            qkv["b"] = torch.cat([s(f"{base}.attn1.to_{x}.bias") for x in "qkv"])
        return {
            "norm1": {"ln": ln(f"{base}.norm1.norm"), "lin": s.linear(f"{base}.norm1.linear")},
            "norm2": {"ln": ln(f"{base}.norm2.norm"), "lin": s.linear(f"{base}.norm2.linear")},
            "qkv": qkv,
            "qnorm": ln(f"{base}.attn1.norm_q"),
            "knorm": ln(f"{base}.attn1.norm_k"),
            "proj": s.linear(f"{base}.attn1.to_out.0"),
            "ff_in": s.linear(f"{base}.ff.net.0.proj"),
            "ff_out": s.linear(f"{base}.ff.net.2"),
        }

    conv_w = s("patch_embed.proj.weight")
    return {
        "patch_proj": {"w": conv_w.reshape(conv_w.shape[0], -1).t().contiguous(),
                       "b": s("patch_embed.proj.bias")},
        "text_proj": s.linear("patch_embed.text_proj"),
        "time_lin1": s.linear("time_embedding.linear_1"),
        "time_lin2": s.linear("time_embedding.linear_2"),
        "blocks": stack_layers(block, cfg.num_layers),
        "norm_final": ln("norm_final"),
        "norm_out_ln": ln("norm_out.norm"),
        "norm_out_lin": s.linear("norm_out.linear"),
        "proj_out": s.linear("proj_out"),
    }


def convert_cogvideox_vae_state_dict(
    sd: Mapping[str, Any], cfg, dtype: torch.dtype = torch.float32
) -> Dict[str, Any]:
    """diffusers `AutoencoderKLCogVideoX` state dict -> the port's tree
    (`models/video/vae.py`): causal convs as `<name>.conv.weight` (OIDHW),
    bare `conv_shortcut.weight`, per-frame 2D down / up samplers, and the
    decoder's SpatialNorm3D triplets (`norm_layer`, `conv_y`, `conv_b`)."""
    s = StateDict(sd, dtype)

    def conv(key):
        base = f"{key}.conv" if f"{key}.conv.weight" in s.sd else key
        return {"w": s(f"{base}.weight"), "b": s(f"{base}.bias")}

    def gn(key):
        return {"scale": s(f"{key}.weight"), "bias": s(f"{key}.bias")}

    def sn(key):
        return {"norm": gn(f"{key}.norm_layer"), "conv_y": conv(f"{key}.conv_y"),
                "conv_b": conv(f"{key}.conv_b")}

    def resnet(key, spatial: bool):
        norm = sn if spatial else gn
        p = {"norm1": norm(f"{key}.norm1"), "conv1": conv(f"{key}.conv1"),
             "norm2": norm(f"{key}.norm2"), "conv2": conv(f"{key}.conv2")}
        if f"{key}.conv_shortcut.weight" in s.sd or f"{key}.conv_shortcut.conv.weight" in s.sd:
            p["conv_shortcut"] = conv(f"{key}.conv_shortcut")
        return p

    n_blocks = len(cfg.block_out_channels)
    down = []
    for i in range(n_blocks):
        base = f"encoder.down_blocks.{i}"
        block = {"resnets": [resnet(f"{base}.resnets.{j}", False)
                             for j in range(cfg.layers_per_block)]}
        if f"{base}.downsamplers.0.conv.weight" in s.sd:
            block["downsample"] = conv(f"{base}.downsamplers.0.conv")
        down.append(block)
    up = []
    for i in range(n_blocks):
        base = f"decoder.up_blocks.{i}"
        block = {"resnets": [resnet(f"{base}.resnets.{j}", True)
                             for j in range(cfg.layers_per_block + 1)]}
        if f"{base}.upsamplers.0.conv.weight" in s.sd:
            block["upsample"] = conv(f"{base}.upsamplers.0.conv")
        up.append(block)
    return {
        "encoder": {
            "conv_in": conv("encoder.conv_in"),
            "down": down,
            "mid": [resnet(f"encoder.mid_block.resnets.{j}", False) for j in range(2)],
            "norm_out": gn("encoder.norm_out"),
            "conv_out": conv("encoder.conv_out"),
        },
        "decoder": {
            "conv_in": conv("decoder.conv_in"),
            "mid": [resnet(f"decoder.mid_block.resnets.{j}", True) for j in range(2)],
            "up": up,
            "norm_out": sn("decoder.norm_out"),
            "conv_out": conv("decoder.conv_out"),
        },
    }


def convert_vit_state_dict(
    sd: Mapping[str, Any], cfg, dtype: torch.dtype = torch.float32,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Any]:
    """timm / Chefer / DINO ViT state dict -> the port's tree
    (`models/vit.py`): `patch_embed.proj` (the patch conv) as a [C*p*p, D]
    matmul weight in (c, py, px) order, `cls_token`, `pos_embed`,
    `blocks.{i}.{norm1, norm2}`, `.attn.{qkv, proj}`, `.mlp.{fc1, fc2}`
    stacked by depth, `norm`, `head`."""
    s = StateDict(sd, dtype, device)

    def ln(key):
        return {"scale": s(f"{key}.weight"), "bias": s(f"{key}.bias")}

    def block(i):
        base = f"blocks.{i}"
        return {
            "norm1": ln(f"{base}.norm1"),
            "attn": {"qkv": s.linear(f"{base}.attn.qkv"), "proj": s.linear(f"{base}.attn.proj")},
            "norm2": ln(f"{base}.norm2"),
            "mlp_in": s.linear(f"{base}.mlp.fc1"),
            "mlp_out": s.linear(f"{base}.mlp.fc2"),
        }

    conv_w = s("patch_embed.proj.weight")
    return {
        "patch_embed": {"w": conv_w.reshape(conv_w.shape[0], -1).t().contiguous(),
                        "b": s("patch_embed.proj.bias")},
        "cls_token": s("cls_token"),
        "pos_embed": s("pos_embed"),
        "blocks": stack_layers(block, cfg.depth),
        "norm": ln("norm"),
        "head": s.linear("head"),
    }


def convert_sd_unet_state_dict(
    sd: Mapping[str, Any], cfg, dtype: torch.dtype = torch.float32,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Any]:
    """diffusers `UNet2DConditionModel` state dict (the SD2 or the SDXL
    layout, linear projections) -> the port's tree (`models/sd_unet.py`) on
    `device` (the state dict's by default). Pass `SDXL_BASE_CONFIG` for an
    sd_xl_base checkpoint (several blocks a transformer, `add_embedding`)."""
    s = StateDict(sd, dtype, device)

    def conv(key):
        return _conv(s, key)

    def norm(key):
        return _gn(s, key)

    def res(key):
        p = {"norm1": norm(f"{key}.norm1"), "conv1": conv(f"{key}.conv1"),
             "time_emb": s.linear(f"{key}.time_emb_proj"),
             "norm2": norm(f"{key}.norm2"), "conv2": conv(f"{key}.conv2")}
        if f"{key}.conv_shortcut.weight" in s.sd:
            p["shortcut"] = conv(f"{key}.conv_shortcut")
        return p

    def attn_inner(key):
        return {"q": s.linear(f"{key}.to_q"), "k": s.linear(f"{key}.to_k"),
                "v": s.linear(f"{key}.to_v"), "proj": s.linear(f"{key}.to_out.0")}

    def basic_block(tb):
        return {"norm1": norm(f"{tb}.norm1"), "attn1": attn_inner(f"{tb}.attn1"),
                "norm2": norm(f"{tb}.norm2"), "attn2": attn_inner(f"{tb}.attn2"),
                "norm3": norm(f"{tb}.norm3"), "ff_in": s.linear(f"{tb}.ff.net.0.proj"),
                "ff_out": s.linear(f"{tb}.ff.net.2")}

    def transformer(key, n_blocks):
        return {"norm": norm(f"{key}.norm"), "proj_in": s.linear(f"{key}.proj_in"),
                "blocks": [basic_block(f"{key}.transformer_blocks.{n}") for n in range(n_blocks)],
                "proj_out": s.linear(f"{key}.proj_out")}

    n_levels = len(cfg.block_out_channels)
    down = []
    for i in range(n_levels):
        base = f"down_blocks.{i}"
        block: Dict[str, Any] = {
            "resnets": [res(f"{base}.resnets.{j}") for j in range(cfg.layers_per_block)]}
        if cfg.cross_attention_levels[i]:
            block["attentions"] = [transformer(f"{base}.attentions.{j}", cfg.tlayers(i))
                                   for j in range(cfg.layers_per_block)]
        if f"{base}.downsamplers.0.conv.weight" in s.sd:
            block["downsample"] = conv(f"{base}.downsamplers.0.conv")
        down.append(block)

    up = []
    for k in range(n_levels):
        i = n_levels - 1 - k
        base = f"up_blocks.{k}"
        block = {"resnets": [res(f"{base}.resnets.{j}") for j in range(cfg.layers_per_block + 1)]}
        if cfg.cross_attention_levels[i]:
            block["attentions"] = [transformer(f"{base}.attentions.{j}", cfg.tlayers(i))
                                   for j in range(cfg.layers_per_block + 1)]
        if f"{base}.upsamplers.0.conv.weight" in s.sd:
            block["upsample"] = conv(f"{base}.upsamplers.0.conv")
        up.append(block)

    out = {
        "time1": s.linear("time_embedding.linear_1"),
        "time2": s.linear("time_embedding.linear_2"),
        "conv_in": conv("conv_in"),
        "down": down,
        "mid": {"res1": res("mid_block.resnets.0"),
                "attn": transformer("mid_block.attentions.0", cfg.tlayers(n_levels - 1)),
                "res2": res("mid_block.resnets.1")},
        "up": up,
        "norm_out": norm("conv_norm_out"),
        "conv_out": conv("conv_out"),
    }
    if cfg.addition_embed_type == "text_time":
        out["add1"] = s.linear("add_embedding.linear_1")
        out["add2"] = s.linear("add_embedding.linear_2")
    return out
