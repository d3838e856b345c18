"""Invisible DWT-DCT watermark: embedding and extraction (host-side numpy/scipy).

The same quantization-index-modulation scheme as
the JAX package's `utils/watermark.py`: Haar DWT level 1, 8x8 DCT blocks
of the LL subband of the U (chroma) channel, one payload bit per block.
"""

from __future__ import annotations

import numpy as np

# The 48-bit watermark the Flux stack embeds.
WATERMARK_MESSAGE = 0b001010101111111010000111100111001111010100101110
WATERMARK_BITS = [int(b) for b in bin(WATERMARK_MESSAGE)[2:].zfill(48)]

_RGB2YUV = np.array(
    [[0.299, 0.587, 0.114], [-0.14713, -0.28886, 0.436], [0.615, -0.51499, -0.10001]]
)
_YUV2RGB = np.linalg.inv(_RGB2YUV)
_COEF = (3, 4)  # mid-frequency DCT coefficient carrying the bit


def _haar_dwt(x):
    a = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) / 2.0
    h = (x[0::2, 0::2] - x[0::2, 1::2] + x[1::2, 0::2] - x[1::2, 1::2]) / 2.0
    v = (x[0::2, 0::2] + x[0::2, 1::2] - x[1::2, 0::2] - x[1::2, 1::2]) / 2.0
    d = (x[0::2, 0::2] - x[0::2, 1::2] - x[1::2, 0::2] + x[1::2, 1::2]) / 2.0
    return a, h, v, d


def _haar_idwt(a, h, v, d):
    hh, ww = a.shape
    x = np.empty((hh * 2, ww * 2), a.dtype)
    x[0::2, 0::2] = (a + h + v + d) / 2.0
    x[0::2, 1::2] = (a - h + v - d) / 2.0
    x[1::2, 0::2] = (a + h - v - d) / 2.0
    x[1::2, 1::2] = (a - h - v + d) / 2.0
    return x


def _qim(coef: float, bit: int, delta: float) -> float:
    """Snap to an even (bit 0) or odd (bit 1) multiple of delta."""
    k = np.floor(coef / delta)
    if (int(k) & 1) != bit:
        k = k + 1 if coef - k * delta > delta / 2 else k - 1
    return (k + 0.5) * delta


def embed_watermark(image: np.ndarray, bits=None, delta: float = 8.0) -> np.ndarray:
    """Embed the watermark into an RGB uint8 or [0, 1] float HWC image;
    returns the watermarked image in the input dtype."""
    from scipy.fft import dctn, idctn

    bits = WATERMARK_BITS if bits is None else list(bits)
    arr = np.asarray(image)
    in_dtype = arr.dtype
    rgb = arr.astype(np.float64)
    if not np.issubdtype(in_dtype, np.integer):
        rgb = rgb * 255.0
    yuv = rgb @ _RGB2YUV.T
    u = yuv[..., 1]
    h2, w2 = (u.shape[0] // 2) * 2, (u.shape[1] // 2) * 2
    a, hh, vv, dd = _haar_dwt(u[:h2, :w2])
    idx = 0
    for i in range(a.shape[0] // 8):
        for j in range(a.shape[1] // 8):
            block = a[i * 8 : (i + 1) * 8, j * 8 : (j + 1) * 8]
            dct = dctn(block, norm="ortho")
            dct[_COEF] = _qim(dct[_COEF], bits[idx % len(bits)], delta)
            a[i * 8 : (i + 1) * 8, j * 8 : (j + 1) * 8] = idctn(dct, norm="ortho")
            idx += 1
    u[:h2, :w2] = _haar_idwt(a, hh, vv, dd)
    yuv[..., 1] = u
    out = np.clip(yuv @ _YUV2RGB.T, 0, 255)
    if np.issubdtype(in_dtype, np.integer):
        return out.round().astype(in_dtype)
    return (out / 255.0).astype(in_dtype)


def extract_watermark(image: np.ndarray, num_bits: int = 48, delta: float = 8.0):
    """The embedded bits, each by a majority vote over the blocks that carry it."""
    from scipy.fft import dctn

    arr = np.asarray(image)
    rgb = arr.astype(np.float64)
    if not np.issubdtype(arr.dtype, np.integer):
        rgb = rgb * 255.0
    u = (rgb @ _RGB2YUV.T)[..., 1]
    h2, w2 = (u.shape[0] // 2) * 2, (u.shape[1] // 2) * 2
    a = _haar_dwt(u[:h2, :w2])[0]
    votes = np.zeros((num_bits, 2), np.int64)
    idx = 0
    for i in range(a.shape[0] // 8):
        for j in range(a.shape[1] // 8):
            coef = dctn(a[i * 8 : (i + 1) * 8, j * 8 : (j + 1) * 8], norm="ortho")[_COEF]
            votes[idx % num_bits, int(np.floor(coef / delta)) & 1] += 1
            idx += 1
    return [int(b) for b in np.argmax(votes, axis=1)]
