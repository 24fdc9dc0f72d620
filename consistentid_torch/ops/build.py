"""Builds the port's CUDA kernels from the sources in the checkout.

Each library is compiled by `nvcc` for sm_90a into a plain-C shared object
under `build/kernels/` beside the package, named by a hash of its sources,
the shared headers and the compile command, and loaded with ctypes.
A library is built at first use in a process and reused afterwards; a
missing `nvcc` or a failed build raises. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# every library of the port: name -> its csrc sources
LIBRARIES: Dict[str, Sequence[str]] = {
    "flash_attention": ("flash_attention.cu",),        # K1, K2
    "flash_attention_bwd": ("flash_attention_bwd.cu",),  # K3, K4
    "fused_bn_act": ("fused_bn_act.cu",),                # K5, K6
}

_loaded: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (absent when cached)
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be "
                           "built")
    return nvcc


def nvcc_command(nvcc: str, sources: Sequence[Path], out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources)]


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, source_names: Sequence[str]) -> Path:
    sources = [CSRC_DIR / s for s in source_names]
    return BUILD_DIR / f"lib{name}-{_digest(sources)}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library `name` of LIBRARIES. Calls for
    different libraries may run in parallel threads: each runs its own
    nvcc."""
    if name in _loaded:
        return _loaded[name]
    out = library_path(name, LIBRARIES[name])
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                nvcc_command(nvcc, [CSRC_DIR / s for s in LIBRARIES[name]],
                             Path(tmp)), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
