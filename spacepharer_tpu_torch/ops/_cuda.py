"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

Each kernel source compiles with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into csrc/_build/<source hash>/.
The build writes to a temporary name and os.replace()s it into place, so
concurrent processes never load a half-written library and a changed
source can never load a stale one. Nothing here runs at import time.
A build runs in the span kernel_build and adds one to kernel_builds;
upload() copies a host array to the card and counts its bytes.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..logging import count, span

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_ROOT = os.path.join(_CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
lib_paths = {}      # the built library of each loaded kernel source
build_seconds = {}
build_log = {}      # nvcc/ptxas output: registers, spills per kernel


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME); the CUDA kernels cannot be built")


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (built if needed)."""
    if name in _libs:
        return _libs[name]
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, digest)
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        with span("kernel_build"):
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
        count("kernel_builds")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = proc.stderr
    _libs[name] = ctypes.CDLL(lib_path)
    lib_paths[name] = lib_path
    return _libs[name]


def upload(x, device):
    """x (a numpy array or a tensor) on `device`; a copy from the host to
    a card adds its bytes to the h2d_bytes counter."""
    import torch
    dev = torch.device(device)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
    if dev.type == "cuda" and t.device.type == "cpu":
        count("h2d_bytes", t.numel() * t.element_size())
    return t.to(dev)
