"""Build and load the CUDA kernels at first use.

``kernels/csrc/<name>.cu`` has a plain C interface.  The first call on a
CUDA tensor compiles it with ``nvcc`` for Hopper (``sm_90a``) into
``kernels/build/`` (listed in ``.gitignore``), under a name keyed by a hash
of the source and the flags, loads it with ``ctypes`` and reuses it for the
life of the process.  A CPU tensor never reaches this module: the kernel
wrappers import it inside their CUDA branch.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``launch`` raises when that is not 0, so a refused launch never passes in
silence.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
BUILD_LOG: dict = {}        # source name -> nvcc's output (ptxas register
#                             and spill report) when this process built it
BUILD_SECONDS: dict = {}    # source name -> seconds nvcc took, or 0.0 if the
#                             library was already built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library(name: str = "commit_kernels") -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    BUILD_SECONDS[name] = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, so)        # atomic: a reader never sees half a file
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.commit_kernels_error_string.argtypes = [ctypes.c_int]
    lib.commit_kernels_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def launch(symbol: str, argtypes: list, *args, device=None) -> None:
    """Call C entry ``symbol`` with ``args`` on the current CUDA stream of
    ``device``; raise if the launch was refused."""
    lib = library()
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.commit_kernels_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")
