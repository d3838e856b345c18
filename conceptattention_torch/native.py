"""ctypes bindings of the eval harnesses' host ops (`csrc/eval_ops.cpp`).

The library is compiled with g++ at first use into
`<checkout>/build/torch_kernels/libeval_ops-<hash>.so`, beside the CUDA
libraries (the hash covers the source and the flags, so an edit rebuilds).
A failed build raises: nothing falls back to numpy. The numpy versions
(`*_plain`) are the plain versions the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from conceptattention_torch.kernels._build import BUILD_DIR, CSRC
from conceptattention_torch.utils.plotting import upsample_nearest

SOURCE = CSRC / "eval_ops.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libeval_ops-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; raises if the compiler fails
    or is missing."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def get_lib() -> ctypes.CDLL:
    """The built library, compiled first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.nearest_resize_f32.argtypes = [f32p, i64, i64, f32p, i64, i64]
        lib.hist_iou_i64.argtypes = [i64p, i64p, i64, i64, i64p, i64p]
        lib.pix_acc_i64.argtypes = [i64p, i64p, i64, i64p]
        lib.gaussian_blur3_f32.argtypes = [f32p, i64, i64, ctypes.c_float, f32p]
        for fn in (lib.nearest_resize_f32, lib.hist_iou_i64, lib.pix_acc_i64,
                   lib.gaussian_blur3_f32):
            fn.restype = None
        _lib = lib
    return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _label_pair(pred, target) -> Tuple[np.ndarray, np.ndarray]:
    p = np.ascontiguousarray(pred, dtype=np.int64).ravel()
    t = np.ascontiguousarray(target, dtype=np.int64).ravel()
    if p.size != t.size:
        raise ValueError(f"prediction of {p.size} pixels against a target of {t.size}")
    return p, t


def nearest_resize(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """[h, w] -> [oh, ow] f32, nearest neighbour: row i reads row i * h // oh."""
    src32 = np.ascontiguousarray(src, dtype=np.float32)
    if src32.ndim != 2 or min(oh, ow) < 0:
        raise ValueError(f"nearest_resize takes a [h, w] map to a size >= 0, got "
                         f"{src32.shape} -> ({oh}, {ow})")
    dst = np.empty((oh, ow), np.float32)
    get_lib().nearest_resize_f32(_f32p(src32), src32.shape[0], src32.shape[1], _f32p(dst), oh, ow)
    return dst


def nearest_resize_plain(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    return upsample_nearest(np.asarray(src, dtype=np.float32), oh, ow)


def hist_iou(pred: np.ndarray, target: np.ndarray, nclass: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class (intersection, union) pixel counts over bins 1..nclass of
    the +1-shifted maps; predictions where target < 0 are dropped."""
    if nclass < 1:
        raise ValueError(f"nclass must be at least 1, got {nclass}")
    p, t = _label_pair(pred, target)
    inter = np.zeros(nclass, np.int64)
    uni = np.zeros(nclass, np.int64)
    get_lib().hist_iou_i64(_i64p(p), _i64p(t), p.size, nclass, _i64p(inter), _i64p(uni))
    return inter, uni


def hist_iou_plain(pred: np.ndarray, target: np.ndarray, nclass: int) -> Tuple[np.ndarray, np.ndarray]:
    predict = np.asarray(pred).astype(np.int64) + 1
    target = np.asarray(target).astype(np.int64) + 1
    predict = predict * (target > 0)
    intersection = predict * (predict == target)
    area_inter, _ = np.histogram(intersection, bins=nclass, range=(1, nclass))
    area_pred, _ = np.histogram(predict, bins=nclass, range=(1, nclass))
    area_lab, _ = np.histogram(target, bins=nclass, range=(1, nclass))
    return area_inter, area_pred + area_lab - area_inter


def pix_acc(pred: np.ndarray, target: np.ndarray) -> Tuple[int, int]:
    """(correct, labelled) pixel counts over target >= 0."""
    p, t = _label_pair(pred, target)
    out = np.zeros(2, np.int64)
    get_lib().pix_acc_i64(_i64p(p), _i64p(t), p.size, _i64p(out))
    return int(out[0]), int(out[1])


def pix_acc_plain(pred: np.ndarray, target: np.ndarray) -> Tuple[int, int]:
    predict = np.asarray(pred).astype(np.int64) + 1
    target = np.asarray(target).astype(np.int64) + 1
    labeled = int(np.sum(target > 0))
    return int(np.sum((predict == target) * (target > 0))), labeled


def gaussian_blur3(src: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """3x3 gaussian blur over the last two axes (reflect padding), f32; the
    leading axes are a batch of maps. Plain version:
    `evals.segmentation.gaussian_blur_3x3`."""
    src32 = np.ascontiguousarray(src, dtype=np.float32)
    if src32.ndim < 2:
        raise ValueError(f"gaussian_blur3 takes [..., h, w] maps, got {src32.shape}")
    h, w = src32.shape[-2:]
    flat = src32.reshape(-1, h, w)
    dst = np.empty_like(flat)
    lib = get_lib()
    for i in range(flat.shape[0]):
        lib.gaussian_blur3_f32(_f32p(flat[i]), h, w, ctypes.c_float(sigma), _f32p(dst[i]))
    return dst.reshape(src32.shape)
