"""LayerNorm of the CogVideoX block in one bf16 pass: CUDA kernel, plain version.

No Pallas kernel stands behind this one: the JAX package leaves the video
DiT's norms to XLA, which fuses each into one pass. Eager PyTorch runs each
as some 14 ATen ops over f32 temporaries, so `csrc/layer_norm.cu` does the
same arithmetic in one pass that reads its bf16 input once and writes its
bf16 output once (its header gives the design).

Two entries, each running its plain version for a CPU tensor and, for a CUDA
tensor, launching the kernel or raising (no fallback):

- `layer_norm`: rows of x [B, L, D], the optional affine, and the optional
  per-batch modulation `* (1 + scale) + shift` of CogVideoXLayerNormZero and
  of the output AdaLayerNorm;
- `qk_layer_norm`: the per-head q and k norms, read from the qkv GEMM's
  output [B, L, 3 * H * hd] through its strides, written as [B, H, L, hd]
  in one launch.

Each has a `launches` attribute.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from conceptattention_torch.kernels import _build
from conceptattention_torch.kernels._autograd import refuse_autograd

MAX_WIDTH = 3072  # the widest row the kernel takes (csrc MAX_WIDTH)


def _ln(x: torch.Tensor, w=None, b=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (population variance), optional affine, in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def layer_norm_plain(x: torch.Tensor, w=None, b=None, eps: float = 1e-5,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`_ln` of x [B, L, D], then, with scale and shift [B, D], the
    modulation `* (1 + scale) + shift` per batch row in x's dtype."""
    out = _ln(x, w, b, eps)
    if scale is not None:
        out = out * (1 + scale[:, None]) + shift[:, None]
    return out


def _heads(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, _ = qkv.shape
    return qkv.reshape(b, l, 3, num_heads, -1)


def qk_layer_norm_plain(qkv: torch.Tensor, num_heads: int, q_w=None, q_b=None, k_w=None,
                        k_b=None, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k of qkv [B, L, 3 * H * hd] (laid out (3, H, hd)), each through
    `_ln` with its own affine: [B, H, L, hd] each."""
    h = _heads(qkv, num_heads).permute(2, 0, 3, 1, 4)
    return _ln(h[0], q_w, q_b, eps), _ln(h[1], k_w, k_b, eps)


def _check(what: str, x: torch.Tensor, *params: Optional[torch.Tensor]) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bf16, got {x.dtype}")
    d = x.shape[-1]
    if d % 8 or d > MAX_WIDTH:
        raise ValueError(f"{what} needs a row width that is a multiple of 8 and at most "
                         f"{MAX_WIDTH}, got {d}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{what} needs contiguous rows at 16-byte aligned offsets, got "
                         f"strides {x.stride()}")
    for t in params:
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise TypeError(f"{what} takes bf16 parameters on {x.device}, got {t.dtype} on "
                            f"{t.device}")
        if (t.shape[-1] != d or t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"{what} needs parameters of width {d} in contiguous rows at "
                             f"16-byte aligned offsets, got {tuple(t.shape)}")


def _launch(streams, scale, shift, batch, m, r, d, x_strides, y_strides, eps, device):
    """One kernel launch over `streams` [(x, y, w, b)] of [batch, m, r] rows."""
    lib = _build.load("layer_norm")
    fn = lib.ca_layer_norm_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, i, p, ll, p, ll, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ctypes.c_float, p]
        fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    ptrs = [ptr(t) for s in streams for t in s] + [None] * 4 * (2 - len(streams))
    with torch.cuda.device(device):
        err = fn(*ptrs, len(streams), ptr(scale), scale.stride(0) if scale is not None else 0,
                 ptr(shift), shift.stride(0) if shift is not None else 0, batch, m, r, d,
                 *x_strides, *y_strides, eps, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "layer_norm launch")


def layer_norm(x: torch.Tensor, w: Optional[torch.Tensor] = None,
               b: Optional[torch.Tensor] = None, eps: float = 1e-5,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm of x [B, L, D] over D in f32 with the optional affine w, b
    [D], in x's dtype; with scale and shift [B, D] (both or neither), then
    `* (1 + scale) + shift` per batch row, each op rounded to x's dtype.
    A CUDA x is bf16 with D % 8 == 0 and D <= 3072; the output is a new
    contiguous [B, L, D]."""
    refuse_autograd("layer_norm", x, w, b, scale, shift)
    if (scale is None) != (shift is None):
        raise ValueError("layer_norm's modulation takes scale and shift together")
    if x.device.type == "cpu":
        return layer_norm_plain(x, w, b, eps, scale, shift)
    if x.dim() != 3:
        raise ValueError(f"layer_norm takes x [B, L, D], got {tuple(x.shape)}")
    _check("layer_norm", x, w, b, scale, shift)
    batch, length, d = x.shape
    if scale is not None and (scale.shape != (batch, d) or shift.shape != (batch, d)):
        raise ValueError(f"layer_norm's scale and shift are [{batch}, {d}], got "
                         f"{tuple(scale.shape)} and {tuple(shift.shape)}")
    y = torch.empty((batch, length, d), dtype=x.dtype, device=x.device)
    _launch([(x, y, w, b)], scale, shift, batch, length, 1, d,
            (x.stride(0), x.stride(1), 0), (y.stride(0), y.stride(1), 0), eps, x.device)
    layer_norm.launches += 1
    return y


def qk_layer_norm(qkv: torch.Tensor, num_heads: int, q_w: Optional[torch.Tensor] = None,
                  q_b: Optional[torch.Tensor] = None, k_w: Optional[torch.Tensor] = None,
                  k_b: Optional[torch.Tensor] = None,
                  eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-head LayerNorm of q and of k, each with its own optional
    affine, read from qkv [B, L, 3 * H * hd] laid out (3, H, hd): (q, k)
    [B, H, L, hd] in qkv's dtype. On a card one launch writes both as new
    contiguous tensors (bf16, hd % 8 == 0)."""
    refuse_autograd("qk_layer_norm", qkv, q_w, q_b, k_w, k_b)
    if qkv.device.type == "cpu":
        return qk_layer_norm_plain(qkv, num_heads, q_w, q_b, k_w, k_b, eps)
    h = _heads(qkv, num_heads)
    _check("qk_layer_norm", h, q_w, q_b, k_w, k_b)
    batch, length, _, heads, d = h.shape
    q, k = (torch.empty((batch, heads, length, d), dtype=qkv.dtype, device=qkv.device)
            for _ in range(2))
    _launch([(h[:, :, 0], q, q_w, q_b), (h[:, :, 1], k, k_w, k_b)], None, None, batch, length,
            heads, d, (h.stride(0), h.stride(1), h.stride(3)),
            (q.stride(0), q.stride(2), q.stride(1)), eps, qkv.device)
    qk_layer_norm.launches += 1
    return q, k


layer_norm.launches = 0
qk_layer_norm.launches = 0
