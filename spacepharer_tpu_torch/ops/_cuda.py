"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

Each kernel source compiles with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into csrc/_build/<source hash>/.
The build writes to a temporary name and os.replace()s it into place, so
concurrent processes never load a half-written library and a changed
source can never load a stale one. Nothing here runs at import time.
A build runs in the span kernel_build and adds one to kernel_builds;
upload() copies a host array to the card and counts its bytes.

Every launch of a kernel crosses into its library here, through an Entry:
the launch function's C signature declared once beside the wrapper that
calls it, the tensors passed as pointers, the current stream appended,
a CUDA error raised, the launch counted. check() and on_card() are the
wrappers' input checks, expect() holds a module's constants to its
library's.
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


# argtypes of a launch function's arguments: a pointer (pass a tensor), an
# int, a long long, and a short int array (pass a tuple of ints)
PTR, INT, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
INTS = ctypes.POINTER(ctypes.c_int)


def on_card(who: str, x) -> bool:
    """True where tensor x lies on a CUDA card, False where it lies on the
    CPU (the plain version's device); ValueError on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")
    return x.device.type == "cuda"


def check(who: str, name: str, x, dtype, device, numel=None):
    """Raise ValueError unless x is a contiguous `dtype` tensor on
    `device` (of `numel` elements, where given)."""
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {x.dtype} on {x.device}")
    if numel is not None and x.numel() != numel:
        raise ValueError(f"{who}: {name} must have {numel} elements, got "
                         f"{x.numel()}")


def expect(lib, who: str, constants: dict):
    """Raise RuntimeError unless every function of lib named in
    `constants` reports the value given: an int function's return, or,
    for a tuple, the ints that a void function writes to its one array
    argument."""
    for name, want in constants.items():
        fn = getattr(lib, name)
        if isinstance(want, tuple):
            out = (ctypes.c_int * len(want))()
            fn(out)
            got = tuple(out)
        else:
            got = fn()
        if got != want:
            raise RuntimeError(f"{who}: the kernel's {name} is {got}, this "
                               f"module's {want}")


def current_stream(device) -> int:
    """The handle of `device`'s current CUDA stream."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


class Entry:
    """One launch function of a kernel library: `<name>_launch` of
    csrc/<lib>.cu, whose arguments are `argtypes` and then the stream
    (every launch function takes it last and returns a CUDA error code).
    `constants` ({function: value}, for expect) are checked when the
    library is first loaded here.

    Calling it with the arguments in declared order (a tensor for each
    PTR, a tuple for each INTS, an int for the rest) launches on the
    current stream of the first tensor's device, raises RuntimeError on a
    non-zero return, and adds one to the registry's `<counter>_launches`
    and `cells` to the counter named `cells_counter` (logging.count),
    where those are given."""

    def __init__(self, lib: str, name: str, argtypes, counter=None,
                 cells_counter=None, constants=None):
        self.lib, self.name, self.argtypes = lib, name, tuple(argtypes)
        self.counter, self.cells_counter = counter, cells_counter
        self.constants = constants or {}
        self._fn = None

    def function(self):
        """The launch function, its library loaded (built if needed) and
        its constants checked at the first call."""
        if self._fn is None:
            lib = library(self.lib)
            expect(lib, self.name, self.constants)
            fn = getattr(lib, self.name + "_launch")
            fn.argtypes = [*self.argtypes, PTR]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args, cells: int = 0):
        import torch
        if len(args) != len(self.argtypes):
            raise TypeError(f"{self.name}: {len(self.argtypes)} arguments "
                            f"declared, {len(args)} given")
        fn = self.function()
        device, c_args = None, []
        for a in args:
            if isinstance(a, torch.Tensor):
                if device is None:
                    device = a.device
                c_args.append(a.data_ptr())
            elif isinstance(a, tuple):
                c_args.append((ctypes.c_int * len(a))(*a))
            else:
                c_args.append(a)
        err = fn(*c_args, current_stream(device))
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        if self.counter:
            count(self.counter + "_launches")
        if self.cells_counter:
            count(self.cells_counter, cells)
