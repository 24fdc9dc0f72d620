"""Builds the port's CUDA kernels from the sources in the checkout.

Each library is compiled by `nvcc` for sm_90a into a plain-C shared object
under `build/kernels/` beside the package, named by a hash of its sources,
the shared headers and the compile command, and loaded with ctypes.
A library is built at first use in a process and reused afterwards; a
missing `nvcc` or a failed build raises. Nothing here runs at import time.
nvcc runs with `-Xptxas -v`; its report (registers, shared memory and
spills of every kernel) is kept beside the library as `<library>.ptxas.txt`
and read by `ptxas_report`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every library of the port: name -> its csrc sources
LIBRARIES: Dict[str, Sequence[str]] = {
    "flash_attention": ("flash_attention.cu",),        # K1, K2 (mma, f32)
    "flash_attention_sm90": ("flash_attention_sm90.cu",),  # K1, K2 (sm90)
    "flash_attention_bwd": ("flash_attention_bwd.cu",),  # K3, K4 (mma, f32)
    "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90.cu",),  # K3 + K4
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


def report_path(library: Path) -> Path:
    return library.with_suffix(".ptxas.txt")


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?, (\d+) bytes smem)?")


def ptxas_report(text: str) -> List[Dict]:
    """Per kernel of an `nvcc -Xptxas -v` report: its (mangled) name, the
    registers a thread uses, its static shared memory (bytes), stack frame
    and spill stores and loads (bytes), in the order ptxas compiled them."""
    kernels: List[Dict] = []
    for line in text.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            kernels.append(dict(function=entry.group(1), registers=None,
                                shared_bytes=0, stack_bytes=0,
                                spill_stores=0, spill_loads=0))
            continue
        if not kernels:
            continue
        spills = _SPILLS.search(line)
        used = _USED.search(line)
        if spills:
            kernels[-1].update(stack_bytes=int(spills.group(1)),
                               spill_stores=int(spills.group(2)),
                               spill_loads=int(spills.group(3)))
        elif used:
            kernels[-1]["registers"] = int(used.group(1))
            if used.group(2):
                kernels[-1]["shared_bytes"] = int(used.group(2))
    return kernels


def load_report(name: str) -> Optional[str]:
    """The kept ptxas report of library `name`, or None when it has not
    been built here."""
    path = report_path(library_path(name, LIBRARIES[name]))
    return path.read_text() if path.exists() else None


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
            report_path(out).write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
