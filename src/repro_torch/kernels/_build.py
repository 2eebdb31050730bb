"""Build and load the CUDA kernels at first use.

Each ``kernels/csrc/<name>.cu`` is one library with a plain C interface
(the ``*.cuh`` headers beside it are shared).  The first call on a CUDA
tensor compiles it with ``nvcc`` for Hopper (``sm_90a``) into
``kernels/build/`` (listed in ``.gitignore``), under a name keyed by a hash
of the sources and the flags, loads it with ``ctypes`` and reuses it for
the life of the process.  ``build_all`` starts one ``nvcc`` per ``.cu``
file, all at once, and waits for them together, so a caller that needs
every library pays for the slowest build, not the sum.  A CPU tensor never reaches this
module: the kernel wrappers import it inside their CUDA branch.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
every library exports ``<name>_error_string``; ``launch`` raises when the
code is not 0, so a refused launch never passes in silence.

``SIGNATURES`` holds each C entry point's arguments.  Their ctypes
``argtypes`` are set once, when the library loads, and the function objects
are kept, so a launch costs one dictionary lookup, the current stream's
handle and the ctypes call; the device is switched only when the operands
are not on the current one.  The handle comes from
``torch._C._cuda_getCurrentRawStream``, the pointer behind
``torch.cuda.current_stream(device).cuda_stream`` without the ``Stream``
object that call builds on every launch (``chip_compare.py --host`` times
both).
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
LIBRARIES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

_P, _F, _I, _U, _LL = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                       ctypes.c_uint, ctypes.c_longlong)
# library -> C entry point -> its arguments before the trailing stream
SIGNATURES = {
    "commit_kernels": {
        "fused_accum": [_P, _P, _P, _F, _P, _I, _LL],
        "plain_commit": [_P, _P, _P, _F, _P, _I, _LL, _I, _I, _I],
        "quantize_rows": [_P, _P, _LL, _I, _I],
        "topk_rows": [_P, _P, _LL, _I, _I],
    },
    "secure_commit": {
        "secure_commit": [_P, _P, _P, _P, _U, _P, _P, _P, _P, _P, _I, _LL,
                          _I, _I, _I],
        "secure_fold": [_P, _P, _P, _I],
    },
    "fedprox_update": {
        "fedprox_update": [_P, _P, _P, _P, _F, _F, _I, _LL],
    },
    "selective_scan": {
        "selective_scan": [_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _LL],
        "selective_scan_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL,
                               _LL, _LL, _LL],
    },
}

_LIBS: dict = {}
_FUNCS: dict = {}           # C entry point name -> its bound ctypes function
BUILD_LOG: dict = {}        # library name -> nvcc's output (ptxas register
#                             and spill report) when this process built it
BUILD_SECONDS: dict = {}    # library name -> seconds nvcc took, or 0.0 if
#                             the library was already built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _target(name: str) -> Path:
    """The library's file: keyed by its source, the shared headers and the
    flags, so any change to them builds anew."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu``, or return None when the library is
    already built."""
    so = _target(name)
    BUILD_SECONDS.setdefault(name, 0.0)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so, t0 = started
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {CSRC / f'{name}.cu'}:\n{out}")
    os.replace(tmp, so)        # atomic: a reader never sees half a file
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = out


def build_all() -> None:
    """Build every library that is not built yet, one nvcc each, all
    started together."""
    started = {name: _start(name) for name in LIBRARIES
               if name not in _LIBS}
    for name, s in started.items():
        _finish(name, s)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``, with the
    ``argtypes`` of its entry points (``SIGNATURES``) set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _finish(name, _start(name))
    lib = ctypes.CDLL(str(_target(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    for symbol, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    _LIBS[name] = lib
    return lib


def launch(lib: str, symbol: str, *args, device: torch.device) -> None:
    """Call C entry ``symbol`` of library ``lib`` with ``args`` on the
    current CUDA stream of ``device``; raise if the launch was refused."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        library(lib)
        fn = _FUNCS[symbol]
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err:
        msg = getattr(_LIBS[lib], f"{lib}_error_string")(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")
