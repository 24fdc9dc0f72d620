"""ctypes binding of the native FGID image loader (native/fgid_loader.cpp):
the port's counterpart of the JAX package's io/native_loader.py, over the
same C++ source.

The library is built on first use with g++ (libjpeg, libpng, pthread) into
build/native/ of the checkout, never into native/: the source stays as it
is, and the JAX package builds its own copy there. The build writes a
temporary file and renames it into place, so processes that build at once
each see a whole library; a library that will not load (built on another
machine, say) is rebuilt once. Where the compiler or a library is
missing, `get_lib()` returns None and `BUILD_ERROR` holds the compiler's
last error line (or the loader's); `route()` names the route taken, for
the caller to log.

  - NativeImageLoader: a threaded, prefetching batch loader that delivers
    batches in path order;
  - decode_resize_normalize: the single-image path.
Both decode JPEG and PNG and resize with the C++ half-pixel bilinear.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import List, NamedTuple, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "fgid_loader.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
LIBRARY = os.path.join(BUILD_DIR, "libfgid_loader.so")

_lib = None
HAS_NATIVE: Optional[bool] = None
BUILD_ERROR: Optional[str] = None


def _build() -> bool:
    """g++ into a temporary file beside LIBRARY, then an atomic rename."""
    global BUILD_ERROR
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp,
           "-ljpeg", "-lpng", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:                     # no compiler at all
        BUILD_ERROR = f"{cmd[0]}: {e}"
        os.unlink(tmp)
        return False
    if proc.returncode != 0:
        lines = [ln for ln in proc.stderr.splitlines() if ln.strip()]
        errors = [ln for ln in lines if "error" in ln]
        BUILD_ERROR = (errors or lines or [f"exit {proc.returncode}"])[-1]
        os.unlink(tmp)
        return False
    os.replace(tmp, LIBRARY)
    return True


def _load():
    """ctypes.CDLL of LIBRARY, None (BUILD_ERROR set) if it will not load."""
    global BUILD_ERROR
    try:
        return ctypes.CDLL(LIBRARY)
    except OSError as e:
        BUILD_ERROR = str(e)
        return None


def get_lib():
    global _lib, HAS_NATIVE
    if _lib is not None or HAS_NATIVE is False:
        return _lib
    built = False
    if not os.path.exists(LIBRARY) or (
            os.path.getmtime(SOURCE) > os.path.getmtime(LIBRARY)):
        built = _build()
        if not built:
            HAS_NATIVE = False
            return None
    lib = _load()
    if lib is None and not built and _build():
        lib = _load()       # a library built elsewhere: rebuilt here once
    if lib is None:
        HAS_NATIVE = False
        return None
    lib.fgid_loader_create.restype = ctypes.c_void_p
    lib.fgid_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    lib.fgid_loader_next.restype = ctypes.c_int
    lib.fgid_loader_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.POINTER(ctypes.c_uint8)]
    lib.fgid_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.fgid_decode_resize.restype = ctypes.c_int
    lib.fgid_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    HAS_NATIVE = True
    return _lib


def route() -> str:
    """"native (<library>)" or "numpy (...)" with the reason, building the
    library first if it has not been tried."""
    if get_lib() is not None:
        return f"native ({os.path.relpath(LIBRARY, _REPO_ROOT)})"
    return ("numpy (PNG only, PIL-exact BILINEAR): the native loader did not "
            f"build: {BUILD_ERROR}")


def _fvec3(v) -> ctypes.Array:
    return (ctypes.c_float * 3)(*[float(x) for x in v])


def decode_resize_normalize(path: str, height: int, width: int,
                            mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                            center_crop: bool = False
                            ) -> Optional[np.ndarray]:
    """JPEG/PNG -> (H, W, 3) fp32 normalized; None on decode failure."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width, 3), np.float32)
    rc = lib.fgid_decode_resize(
        path.encode(), height, width, _fvec3(mean), _fvec3(std),
        int(center_crop),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


class LoaderBatch(NamedTuple):
    """One decoded batch, delivered strictly in path order.

    start:  index into the constructor's path list of images[0]
    images: (batch, H, W, 3) fp32; failed/padded slots are all-zero
    ok:     (batch,) bool decode-success flags for safe label pairing
    """
    start: int
    images: np.ndarray
    ok: np.ndarray


class NativeImageLoader:
    """Iterate LoaderBatch tuples decoded by the C++ worker pool, in path
    order whatever order the workers finish in."""

    def __init__(self, paths: List[str], height: int, width: int,
                 batch: int, threads: int = 4,
                 mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                 center_crop: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {BUILD_ERROR}")
        self._lib = lib
        self.batch, self.height, self.width = batch, height, width
        c_paths = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._handle = lib.fgid_loader_create(
            c_paths, len(paths), height, width, batch, threads,
            _fvec3(mean), _fvec3(std), int(center_crop))
        self._exhausted = False

    def __iter__(self):
        return self

    def __next__(self) -> LoaderBatch:
        if self._exhausted:
            raise StopIteration
        out = np.empty((self.batch, self.height, self.width, 3), np.float32)
        start = ctypes.c_longlong(-1)
        ok = np.zeros((self.batch,), np.uint8)
        rc = self._lib.fgid_loader_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(start),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc < 0:
            self._exhausted = True
            raise StopIteration
        if rc == 0:
            self._exhausted = True
        return LoaderBatch(int(start.value), out, ok.astype(bool))

    def close(self):
        if self._handle:
            self._lib.fgid_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
