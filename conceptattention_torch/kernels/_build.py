"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `csrc/<name>.cu` is compiled on first use into
`<checkout>/build/torch_kernels/lib<name>-<hash>.so` (the hash covers the
source, the shared `csrc/*.cuh` headers and the flags, so an edit rebuilds)
and exposes a plain C interface: pointers and the stream are passed as
`c_void_p`, every entry point returns a `cudaError_t`. Nothing here runs at
import time, so the CPU tests import the kernel modules where no `nvcc`
exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # shared headers
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library of `names`, one nvcc per source, all
    started together. Returns each source's compiler log (ptxas register and
    shared-memory report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library `name`, compiled first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.ca_error_string.argtypes = [ctypes.c_int]
        lib.ca_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ca_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
