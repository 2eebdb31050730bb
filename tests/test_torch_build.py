"""The port's kernel libraries as ``kernels/_build.py`` binds them, checked
on the CPU (nvcc and the card are not needed): every C entry point of every
``csrc/*.cu`` has its ctypes signature in ``SIGNATURES``, argument for
argument, so that ctypes never passes a pointer as a 32-bit int or drops
the stream; and ``chip_smoke.py``'s report of nvcc's register and spill
counts names each kernel."""
import ctypes
import re
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

C_TYPES = {"float": ctypes.c_float, "int": ctypes.c_int,
           "unsigned": ctypes.c_uint, "long long": ctypes.c_longlong}


def c_entry_points(lib: str) -> dict:
    """name -> ctypes types of the arguments of each ``int name(...)`` in the
    ``extern "C"`` block of ``csrc/<lib>.cu``."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    block = src[src.index('extern "C" {'):]
    entries = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
        types = []
        for param in params.split(","):
            decl = " ".join(param.split()[:-1]).replace("const ", "")
            types.append(ctypes.c_void_p if "*" in param
                         else C_TYPES[decl])
        entries[name] = types
    return entries


@pytest.mark.parametrize("lib", _build.LIBRARIES)
def test_signatures_match_the_c_entry_points(lib):
    entries = c_entry_points(lib)
    assert set(entries) == set(_build.SIGNATURES[lib])
    for name, types in entries.items():
        # the wrapper's arguments, then the stream
        assert types == [*_build.SIGNATURES[lib][name], ctypes.c_void_p], name


def test_every_library_has_its_signatures():
    assert set(_build.SIGNATURES) == set(_build.LIBRARIES)


@pytest.mark.parametrize("mangled,name", [
    ("_ZN49_GLOBAL__N__867494a8_16_secure_commit_cu_646e33d520secure_commit_"
     "kernelILi2EEEvPKfS2_PKjjS2_Pfixiii", "secure_commit_kernel<2>"),
    ("_ZN12_GLOBAL__N_118fused_accum_kernelEPK6float4PKfS4_fPS0_ix",
     "fused_accum_kernel"),
    ("_Z21fedprox_update_kernelPKfS0_S0_Pfffx", "fedprox_update_kernel"),
    ("not_mangled", "not_mangled"),
])
def test_ptxas_report_names_the_kernels(mangled, name):
    assert chip_smoke.kernel_name(mangled) == name
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\n    328 bytes stack frame, 456 bytes spill stores, "
           f"616 bytes spill loads\nptxas info    : Used 64 registers, used "
           f"0 barriers\n")
    assert chip_smoke.ptxas_report(log) == (
        f"{name} spills (328 bytes stack frame, 456 bytes spill stores, 616 "
        f"bytes spill loads); {name} 64 registers")
