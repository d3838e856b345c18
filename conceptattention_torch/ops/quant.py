"""Weight-only int8 / int4 and w8a8 quantization of the DiT layer stacks.

Counterpart of the JAX package's `ops/quant.py`. Three cell forms replace a
large stacked "w" leaf, keyed by the dict's keys:

  {"q", "scale"}     w8: per-(layer, out-channel) absmax int8 weights; the
                     scale folds into the matmul output.
  {"qa", "scale"}    w8a8: the same int8 weights, consumed with dynamic
                     per-token int8 activations in an int8 x int8 -> int32
                     product (`int8_matmul`); both scales fold into the
                     output.
  {"q4p", "gscale"}  w4: group-wise absmax int4 along the input axis (group
                     128), two nibbles packed per int8 byte along that axis;
                     the consuming matmul dequantizes one layer's weight.

Rounding follows the JAX package where it runs: the weight quantizers
divide (`amax / 127`, as the JAX package's eager calls do), and the
per-token activation quantizer multiplies by the f32 reciprocal of 127 (what
XLA makes of `amax / 127` inside the jitted forward). Division by a Python
scalar would turn into that multiplication on a CUDA tensor only, so the
weight quantizers divide by a tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

_QKEYS = frozenset({"q", "scale"})
_QKEYS_A8 = frozenset({"qa", "scale"})
_QKEYS_W4 = frozenset({"q4p", "gscale"})

W4_GROUP = 128
INV127 = 0.007874015718698502  # float32(1) / float32(127), exactly
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes M > 16


def resolve_quant_mode(quantize) -> Optional[str]:
    """True / "w8" -> "w8", "w8a8" -> "w8a8", "w4" -> "w4", False / None -> None."""
    if not quantize:
        return None
    if quantize is True:
        return "w8"
    if quantize in ("w8", "w8a8", "w4"):
        return quantize
    raise ValueError(f"unknown quantize mode {quantize!r} (expected True, 'w8', 'w8a8' or 'w4')")


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE x / c on every device."""
    return x / torch.full_like(x, c)


def quantize_activations_per_token(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Dynamic per-token (last-axis) absmax int8. Returns (x_int8, scale), the
    scale f32 shaped like x with last dim 1. Zero rows give zeros, scale 1.
    `amax` (f32, last dim 1) replaces the row's own absmax: a row-parallel
    shard of the row quantizes against the whole row's."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax * INV127)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 @ [K, N] int8 -> [..., N] int32, exact. On a card this
    is `torch._int_mm` (cuBLASLt's int8 GEMM), with fewer than 17 rows padded
    by zero rows, which it refuses. The weight must be column-major there
    (stride 1 along K): a row-major one sends `_int_mm` to a fallback GEMM
    that took 5.5x as long on an H100, so it is refused; the quantizers and
    `int8_gemm_layout` store w8a8 stacks so. On the CPU an int32 matmul."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    if xq.device.type == "cpu":
        y = x2.to(torch.int32) @ wq.to(torch.int32)
    else:
        if k % 8 or wq.shape[-1] % 8:
            raise ValueError(f"int8 GEMM needs K and N multiples of 8, got K={k}, N={wq.shape[-1]}")
        if wq.stride(0) != 1:
            raise ValueError(
                f"int8 GEMM needs a column-major [K, N] weight, got strides {tuple(wq.stride())}; "
                "lay the tree out with ops.quant.int8_gemm_layout"
            )
        m = x2.shape[0]
        if m < _INT_MM_MIN_ROWS:
            x2 = torch.cat([x2, x2.new_zeros(_INT_MM_MIN_ROWS - m, k)])
        y = torch._int_mm(x2.contiguous(), wq)[:m]
    return y.reshape(*lead, wq.shape[-1])


def _absmax_int8(wf: torch.Tensor, axis: int, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), _div(amax, 127.0))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(dtype)}


def quantize_array(w: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """Per-output-channel absmax int8: scale over the input (first) axis."""
    return _absmax_int8(w.float(), 0, compute_dtype)


def _w4_group_sizes(size: int, group_size: int) -> tuple:
    """(n_groups, group): the largest common divisor of `size` and
    `group_size` that is >= 4, else one group spanning the axis."""
    g = math.gcd(size, group_size)
    if g < 4:
        g = size
    return size // g, g


def pack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack int8 values in [-7, 7] two per byte along `axis` (even size):
    byte = (even & 0xF) | (odd << 4)."""
    size = q.shape[axis]
    pairs = q.reshape(*q.shape[:axis], size // 2, 2, *q.shape[axis + 1:])
    even, odd = pairs.select(axis + 1, 0), pairs.select(axis + 1, 1)
    return (even & 0xF) | (odd << 4)


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of `pack_int4`: arithmetic shifts on int8 sign-extend each
    nibble; `axis` doubles."""
    even = (packed << 4) >> 4
    odd = packed >> 4
    st = torch.stack([even, odd], dim=axis + 1)
    return st.reshape(*packed.shape[:axis], packed.shape[axis] * 2, *packed.shape[axis + 1:])


def quantize_array_w4(w: torch.Tensor, axis: int = 0, group_size: int = W4_GROUP):
    """Group-wise absmax int4 along `axis`, symmetric [-7, 7], packed along
    that axis. Returns {"q4p": int8 (axis halved), "gscale": f32 (axis ->
    group count)}."""
    wf = w.float()
    size = wf.shape[axis]
    if size % 2 or size < 4:
        raise ValueError(f"w4 needs an even input axis >= 4, got {size}")
    n_groups, g = _w4_group_sizes(size, group_size)
    wg = wf.reshape(*wf.shape[:axis], n_groups, g, *wf.shape[axis + 1:])
    amax = wg.abs().amax(dim=axis + 1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), _div(amax, 7.0))
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8).reshape(wf.shape)
    return {"q4p": pack_int4(q, axis), "gscale": scale.squeeze(axis + 1)}


def w4_group_axis(q4p: torch.Tensor, gscale: torch.Tensor) -> int:
    """The grouped (input) axis: where the packed shape (size/2) and the
    group-scale shape (size/group) differ."""
    for i in range(q4p.dim()):
        if q4p.shape[i] != gscale.shape[i]:
            return i
    raise ValueError(f"w4 cell has no group axis (q4p {tuple(q4p.shape)} == gscale {tuple(gscale.shape)})")


def w4_dims(cell: Dict[str, torch.Tensor]) -> tuple:
    """(group_axis, input_size, group_size) of a packed w4 cell."""
    ax = w4_group_axis(cell["q4p"], cell["gscale"])
    size = 2 * cell["q4p"].shape[ax]
    return ax, size, size // cell["gscale"].shape[ax]


def dequantize_w4(cell: Dict[str, torch.Tensor], dtype: Optional[torch.dtype] = None):
    """A {"q4p", "gscale"} cell as a dense weight of `dtype` (gscale's by
    default), scaled in gscale's dtype first."""
    qp, s = cell["q4p"], cell["gscale"]
    ax = w4_group_axis(qp, s)
    q = unpack_int4(qp, ax)
    n_groups = s.shape[ax]
    wg = q.reshape(*q.shape[:ax], n_groups, q.shape[ax] // n_groups, *q.shape[ax + 1:])
    w = wg.to(s.dtype) * s.unsqueeze(ax + 1)
    return w.reshape(q.shape).to(dtype or s.dtype)


def dequantize_array(qd: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "q4p" in qd:
        return dequantize_w4(qd)
    q = qd["q"] if "q" in qd else qd["qa"]
    return q.to(qd["scale"].dtype) * qd["scale"]


def _is_quantized(node: Any) -> bool:
    return isinstance(node, dict) and set(node.keys()) in (_QKEYS, _QKEYS_A8, _QKEYS_W4)


def dequantize_tree(tree: Any) -> Any:
    """Quantized cells replaced by dense weights; identity elsewhere."""
    if _is_quantized(tree):
        return dequantize_array(tree)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(dequantize_tree(v) for v in tree)
    return tree


def _input_axis_fastest(q: torch.Tensor) -> torch.Tensor:
    """A [depth, in, out...] stack with the same values, laid out so that
    each layer reshaped to [in, prod(out)] is a column-major view: the
    layout `int8_matmul` hands to the card's int8 GEMM without a copy."""
    return q.movedim(1, -1).contiguous().movedim(-1, 1)


def int8_gemm_layout(tree: Any) -> Any:
    """The tree with every w8a8 stack ("qa") in the layout of
    `_input_axis_fastest`, which `int8_matmul` requires on a card; a stack
    already so is kept without a copy. The pipelines apply it to the trees
    passed in to them."""
    if _is_quantized(tree) and "qa" in tree:
        return {"qa": _input_axis_fastest(tree["qa"]), "scale": tree["scale"]}
    if isinstance(tree, dict):
        return {k: int8_gemm_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(int8_gemm_layout(v) for v in tree)
    return tree


def _quantize_stacked(v: torch.Tensor, mode: str, group_size: int) -> Dict[str, torch.Tensor]:
    """One [depth, in, out...] stack, quantized layer by layer (every scale
    is per layer, so only one layer's f32 copy exists at a time)."""
    if mode == "w4" and v.shape[1] % 2 == 0 and v.shape[1] >= 4:
        cells = [quantize_array_w4(v[i], axis=0, group_size=group_size) for i in range(v.shape[0])]
    else:
        cells = [_absmax_int8(v[i].float(), 0, v.dtype) for i in range(v.shape[0])]
    out = {k: torch.stack([c[k] for c in cells]) for k in cells[0]}
    if mode == "w8a8" and "q" in out:
        out = {"qa": _input_axis_fastest(out.pop("q")), "scale": out["scale"]}
    return out


def quantize_layer_stack(
    stack: Any,
    min_size: int = 1 << 20,
    act_quant: bool = False,
    mode: Optional[str] = None,
    group_size: int = W4_GROUP,
) -> Any:
    """Quantize every "w" leaf of at least `min_size` elements and 3+ dims
    ([depth, in, out...]) of a stacked layer tree. `mode` "w8", "w8a8" or
    "w4" (odd input axes fall back to int8); act_quant=True spells "w8a8"."""
    mode = mode or ("w8a8" if act_quant else "w8")

    def visit(node):
        if isinstance(node, dict):
            return {
                k: _quantize_stacked(v, mode, group_size)
                if k == "w" and torch.is_tensor(v) and v.numel() >= min_size and v.dim() >= 3
                else visit(v)
                for k, v in node.items()
            }
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return node

    return visit(stack)


def quantize_flux_params(params, min_size: int = 1 << 16, act_quant: bool = False,
                         mode: Optional[str] = None, group_size: int = W4_GROUP):
    """The double and single stacks quantized; embedders, norms, biases and
    the final layer stay as they are."""
    out = dict(params)
    for key in ("double", "single"):
        out[key] = quantize_layer_stack(params[key], min_size, act_quant, mode, group_size)
    return out


def quantize_video_dit_params(params, min_size: int = 1 << 16, act_quant: bool = False,
                              mode: Optional[str] = None, group_size: int = W4_GROUP):
    """The CogVideoX blocks quantized; embedders, norms and the head stay."""
    out = dict(params)
    out["blocks"] = quantize_layer_stack(params["blocks"], min_size, act_quant, mode, group_size)
    return out


def _random_quantized_stack(stack, depth: int, mode: str, dtype: torch.dtype,
                            gen: torch.Generator):
    """A depth-1 skeleton stack tiled to `depth`: every "w" leaf of at least
    2**16 elements becomes uniform int8 in [-127, 127] (or packed uniform
    int4 nibbles in [-7, 7]) drawn one layer at a time on the generator's
    device, with a constant scale that gives the bf16 init's 1/sqrt(fan_in)
    std; smaller leaves are copied to every layer."""
    dev = gen.device

    def visit(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = visit(v)
                continue
            shape = (depth, *v.shape[1:])
            if k != "w" or v.numel() < (1 << 16):
                out[k] = v.expand(shape).clone()
                continue
            fan_in = shape[1]
            if mode == "w4" and fan_in % 2 == 0 and fan_in >= 4:
                packed = torch.empty((depth, fan_in // 2, *shape[2:]), dtype=torch.int8, device=dev)
                for i in range(depth):
                    even = torch.empty(packed.shape[1:], dtype=torch.int8, device=dev)
                    odd = torch.empty_like(even)
                    even.random_(-7, 8, generator=gen)
                    odd.random_(-7, 8, generator=gen)
                    packed[i] = (even & 0xF) | (odd << 4)
                n_groups, _ = _w4_group_sizes(fan_in, W4_GROUP)
                # std of a uniform int in [-7, 7] is sqrt((15^2 - 1) / 12)
                out[k] = {"q4p": packed, "gscale": torch.full(
                    (depth, n_groups, *shape[2:]), fan_in**-0.5 / 4.3205, device=dev)}
                continue
            q = torch.empty(shape, dtype=torch.int8, device=dev)
            for i in range(depth):
                q[i].random_(-127, 128, generator=gen)
            if mode == "w8a8":
                q = _input_axis_fastest(q)
            # std of a uniform int in [-127, 127] is about 73.3
            scale = torch.full((depth, 1, *shape[2:]), fan_in**-0.5 / 73.3, dtype=dtype, device=dev)
            out[k] = {("qa" if mode == "w8a8" else "q"): q, "scale": scale}
        return out

    return visit(stack)


def init_flux_params_quantized(generator: torch.Generator, cfg, dtype: torch.dtype = torch.bfloat16,
                               act_quant: bool = False, mode: Optional[str] = None):
    """Random already-quantized Flux parameters on the generator's device:
    a depth-1 skeleton from `init_flux_params`, its stacks tiled to full
    depth with int8 / int4 weights drawn directly, so the bf16 stacks never
    exist."""
    from conceptattention_torch.models.flux.params import init_flux_params

    mode = mode or ("w8a8" if act_quant else "w8")
    skeleton = init_flux_params(
        generator, dataclasses.replace(cfg, depth=1, depth_single_blocks=1), dtype)
    params = {k: v for k, v in skeleton.items() if k not in ("double", "single")}
    params["double"] = _random_quantized_stack(skeleton["double"], cfg.depth, mode, dtype, generator)
    params["single"] = _random_quantized_stack(
        skeleton["single"], cfg.depth_single_blocks, mode, dtype, generator)
    return params


def init_video_dit_params_quantized(generator: torch.Generator, cfg,
                                    dtype: torch.dtype = torch.bfloat16, mode: Optional[str] = None):
    """Random already-quantized CogVideoX DiT parameters, built like
    `init_flux_params_quantized` from a one-layer skeleton."""
    from conceptattention_torch.models.video.dit import init_video_dit_params

    mode = mode or "w8"
    skeleton = init_video_dit_params(generator, dataclasses.replace(cfg, num_layers=1), dtype)
    params = {k: v for k, v in skeleton.items() if k != "blocks"}
    params["blocks"] = _random_quantized_stack(skeleton["blocks"], cfg.num_layers, mode, dtype,
                                               generator)
    return params
