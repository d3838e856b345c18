"""3x3 stride-1 SAME NHWC convolution: CUDA kernel, plain version, gate.

Counterpart of the JAX package's `kernels/conv3x3.py`. The VAE decoder's
3x3 convs (`models/flux/autoencoder._conv2d_nhwc`) route here when
`use_conv3x3_kernel` says the shape suits the kernel and the tensor is on a
card. `conv3x3_same` runs `conv3x3_same_plain` (nine shifted GEMMs in f32)
for a CPU tensor and, for a CUDA tensor, launches the kernel instance that
`conv3x3_instance` names for its dtype and channels (it never falls back from
one to another):

- `conv3x3_same_hopper`: `csrc/conv3x3_sm90.cu`, the implicit GEMM on TMA,
  an mbarrier ring and wgmma, for bf16 with Cin % 64 == 0 and Cout % 8 == 0
  (every conv the gate admits);
- `conv3x3_same_generic`: `csrc/conv3x3.cu`, the first implicit GEMM
  (mma.sync through wmma, single-buffered), for f32 and for bf16 with
  Cin % 32 == 0 outside the Hopper instance's contract.

Each of the three wrappers has a `launches` attribute; `conv3x3_same`'s
counts every launch, each instance's its own.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from conceptattention_torch.kernels import _build
from conceptattention_torch.kernels._autograd import refuse_autograd

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_same_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, fuse_swish: bool = False
) -> torch.Tensor:
    """x [B, H, W, Cin] * w [3, 3, Cin, Cout] (HWIO) + b -> [B, H, W, Cout] in
    x's dtype, as nine shifted f32 GEMMs; `fuse_swish` applies y*sigmoid(y)
    to the f32 accumulator before the cast."""
    _, h, w_dim, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dr in range(3):
        for dc in range(3):
            part = xp[:, dr : dr + h, dc : dc + w_dim, :] @ wf[dr, dc]
            acc = part if acc is None else acc + part
    acc = acc + b.float()
    if fuse_swish:
        acc = acc * torch.sigmoid(acc)
    return acc.to(x.dtype)


HOPPER_CIN_MULTIPLE = 64  # one tap's 64 channels per K step
_TILE_PIXELS = 128  # output pixels per block of the Hopper instance


def conv3x3_instance(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The kernel that takes a card call of this dtype and channel count:
    "hopper" (bf16, Cin % 64 == 0, Cout % 8 == 0) or "generic"."""
    if dtype == torch.bfloat16 and cin % HOPPER_CIN_MULTIPLE == 0 and cout % 8 == 0:
        return "hopper"
    return "generic"


def hopper_conv_tiles(width: int, cout: int) -> Tuple[int, int]:
    """(bw, bn) of the Hopper instance: a block's 128 output pixels are a bw x
    (128 / bw) rectangle, one 128-wide row segment when W >= 128, else the
    narrowest power-of-two width that covers a row; bn = 256 output channels
    where Cout >= 256, else 128."""
    bw = _TILE_PIXELS if width >= _TILE_PIXELS else 1 << max(width - 1, 0).bit_length()
    return bw, 256 if cout >= 256 else 128


def _check_inputs(x, w, b):
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"conv3x3 kernel takes f32 or bf16 x/w/b of one dtype, got "
                        f"{x.dtype}/{w.dtype}/{b.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]) or b.shape != w.shape[3:]:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def conv3x3_same_generic(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, fuse_swish: bool = False
) -> torch.Tensor:
    """`conv3x3_same` through `csrc/conv3x3.cu`: f32 or bf16, Cin % 32 == 0,
    Cout % 8 == 0."""
    refuse_autograd("conv3x3_same_generic", x, w, b)
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, b, fuse_swish)
    _check_inputs(x, w, b)
    batch, h, w_dim, cin = x.shape
    cout = w.shape[3]
    if cin % 32 or cout % 8:
        raise ValueError(f"conv3x3 kernel needs Cin % 32 == 0 and Cout % 8 == 0, got {cin}, {cout}")
    out = torch.empty((batch, h, w_dim, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv3x3")
    fn = lib.ca_conv3x3_same
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[x.dtype], batch, h, w_dim, cin, cout, int(fuse_swish), _stream(x))
    _build.check(lib, err, "conv3x3 launch")
    conv3x3_same_generic.launches += 1
    return out


def conv3x3_same_hopper(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, fuse_swish: bool = False
) -> torch.Tensor:
    """`conv3x3_same` through `csrc/conv3x3_sm90.cu`: bf16, Cin % 64 == 0,
    Cout % 8 == 0, every tensor 16-byte aligned (TMA's rule)."""
    refuse_autograd("conv3x3_same_hopper", x, w, b)
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, b, fuse_swish)
    _check_inputs(x, w, b)
    batch, h, w_dim, cin = x.shape
    cout = w.shape[3]
    if conv3x3_instance(x.dtype, cin, cout) != "hopper":
        raise ValueError(f"the Hopper conv3x3 takes bf16 with Cin % 64 == 0 and Cout % 8 == 0, "
                         f"got {x.dtype}, {cin}, {cout}")
    out = torch.empty((batch, h, w_dim, cout), dtype=x.dtype, device=x.device)
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for TMA")
    bw, bn = hopper_conv_tiles(w_dim, cout)
    lib = _build.load("conv3x3_sm90")
    fn = lib.ca_conv3x3_sm90_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), batch, h, w_dim, cin,
                 cout, bw, bn, int(fuse_swish), _stream(x))
    _build.check(lib, err, "conv3x3_sm90 launch")
    conv3x3_same_hopper.launches += 1
    return out


def conv3x3_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, fuse_swish: bool = False
) -> torch.Tensor:
    """3x3 stride-1 SAME NHWC convolution: x [B, H, W, Cin] * w [3, 3, Cin,
    Cout] + b [Cout] -> [B, H, W, Cout] in x's dtype."""
    refuse_autograd("conv3x3_same", x, w, b)
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, b, fuse_swish)
    instance = conv3x3_instance(x.dtype, x.shape[-1], w.shape[-1])
    run = conv3x3_same_hopper if instance == "hopper" else conv3x3_same_generic
    out = run(x, w, b, fuse_swish)
    conv3x3_same.launches += 1
    return out


conv3x3_same.launches = 0
conv3x3_same_generic.launches = 0
conv3x3_same_hopper.launches = 0


def use_conv3x3_kernel(x: torch.Tensor, cin: int, cout: int) -> bool:
    """Gate: lane-friendly channel counts, H divisible into row tiles, and a
    tensor on a card (the JAX gate's TPU-backend check). Everything else stays
    on `F.conv2d`."""
    _, h, w_dim, _ = x.shape
    return (
        cin % 128 == 0
        and cout % 128 == 0
        and h % 8 == 0
        and w_dim >= 8
        and x.device.type == "cuda"
    )
