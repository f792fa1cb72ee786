"""ctypes binding of the port's host-side augment library.

``lsps_tpu_torch/csrc/lsps_native.cpp`` (the port's copy of the JAX
package's ``native/lsps_native.cpp``) is compiled on first use with

    g++ -O3 -fPIC -shared -fopenmp -o build/lsps_native-<hash>.so
        lsps_tpu_torch/csrc/lsps_native.cpp

into ``build/`` at the root of the checkout (listed in ``.gitignore``),
keyed by a hash of the source and the flags, as ``ops/kernels/build.py``
builds the CUDA kernels; the ``native`` augment backend calls its
``fused_recrop_normalize_batch``.  Its two other entries, the nearest
perspective warp of one image (``warp_perspective_nn``) and the batched
depth normalization (``normalize_batch``), are bound as the JAX package
binds them.  The flags are the JAX package's, so the two
libraries give the same bits.  Where the compiler has no OpenMP runtime
(no ``libgomp``), the library is built without ``-fopenmp``, as the JAX
package builds it there: the same arithmetic, one thread over the
samples; ``BUILT_FLAGS`` records the flags each build took.  There is no
numpy fallback: a failed build raises, and the ``native`` augment backend
is then unavailable.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "lsps_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ("-O3", "-fPIC", "-shared")
OPENMP = "-fopenmp"

BUILT_FLAGS = {}   # library path -> the flags its build in this process took
_LIBS = {}
_LOCK = threading.Lock()


def library_path(build_dir=None) -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join((*FLAGS, OPENMP)).encode()).hexdigest()
    return Path(build_dir or BUILD_DIR) / f"lsps_native-{digest[:16]}.so"


def build(build_dir=None) -> Path:
    """Compile the library into ``build_dir`` (default ``build/``) unless
    it is built already; returns its path.  The library is written to a
    temporary name and renamed into place."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    compiler = os.environ.get("CXX") or shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the native augment library of "
                           "lsps_tpu_torch needs a C++ compiler")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    errors = []
    try:
        for flags in ((*FLAGS, OPENMP), FLAGS):
            res = subprocess.run([compiler, *flags, "-o", tmp, str(SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode == 0:
                os.replace(tmp, lib)
                BUILT_FLAGS[lib] = flags
                return lib
            errors.append(f"{' '.join(flags)} ({res.returncode}):\n"
                          f"{res.stderr}")
        raise RuntimeError(f"{compiler} failed for {SOURCE.name} with "
                           + "; with ".join(errors))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib(build_dir=None) -> ctypes.CDLL:
    """The loaded library, built on first use."""
    path = library_path(build_dir)
    with _LOCK:
        if path not in _LIBS:
            lib = ctypes.CDLL(str(build(build_dir)))
            d = ctypes.POINTER(ctypes.c_double)
            f = ctypes.POINTER(ctypes.c_float)
            i = ctypes.c_int
            fused = lib.fused_recrop_normalize_batch
            fused.argtypes = [f, i, i, i, d, f, f, f, f, f, ctypes.c_float,
                              ctypes.c_float, f]
            fused.restype = None
            lib.warp_perspective_nn.argtypes = [f, i, i, d, f, i, i,
                                                ctypes.c_float]
            lib.warp_perspective_nn.restype = None
            lib.normalize_batch.argtypes = [f, i, i, f, f, f]
            lib.normalize_batch.restype = None
            _LIBS[path] = lib
        return _LIBS[path]


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def warp_perspective_nn(src, M_dst_to_src, dsize, border=0.0) -> np.ndarray:
    """Nearest-neighbour perspective warp of one float32 image into
    ``dsize`` = (height, width); ``M_dst_to_src`` maps destination to
    source coordinates (cv2's ``WARP_INVERSE_MAP``).  Coordinates are
    double and round half away from zero; pixels that fall outside the
    source get ``border``."""
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 2:
        raise ValueError(f"src must be one (H, W) image, not {src.shape}")
    m = np.ascontiguousarray(M_dst_to_src, np.float64).reshape(9)
    dh, dw = (int(v) for v in dsize)
    out = np.empty((dh, dw), np.float32)
    get_lib().warp_perspective_nn(_fptr(src), src.shape[0], src.shape[1],
                                  _dptr(m), _fptr(out), dh, dw,
                                  ctypes.c_float(border))
    return out


def fused_recrop_normalize_batch(src, minv, com_z, cube_z, premax, zstart,
                                 zend, pad_value=0.0,
                                 nv_val=32000.0) -> np.ndarray:
    """The raw tuple of ``FastAugmenter.raw_batch`` (float32 mm sources)
    -> (B, H, W) normalized crops: warp, NV sentinel, z clamp, premax and
    background to the far plane, normalize (see ``lsps_native.cpp``)."""
    src = np.ascontiguousarray(src, np.float32)
    n, h, w = src.shape
    minv = np.ascontiguousarray(minv, np.float64).reshape(n, 9)
    args = [np.ascontiguousarray(a, np.float32)
            for a in (com_z, cube_z, premax, zstart, zend)]
    out = np.empty_like(src)
    get_lib().fused_recrop_normalize_batch(
        _fptr(src), n, h, w, _dptr(minv), _fptr(args[0]), _fptr(args[1]),
        _fptr(args[2]), _fptr(args[3]), _fptr(args[4]),
        ctypes.c_float(pad_value), ctypes.c_float(nv_val), _fptr(out))
    return out


def normalize_batch(src, com_z, cube_z) -> np.ndarray:
    """(B, ...) depth in mm -> normalized depth, one pass: background (0)
    to the far plane, then ``(d - com_z) / (cube_z / 2)`` per sample
    (``data.augment.normalize``, batched)."""
    src = np.ascontiguousarray(src, np.float32)
    n = src.shape[0]
    hw = int(np.prod(src.shape[1:]))
    com_z = np.ascontiguousarray(com_z, np.float32).reshape(-1)
    cube_z = np.ascontiguousarray(cube_z, np.float32).reshape(-1)
    if com_z.shape != (n,) or cube_z.shape != (n,):
        raise ValueError(f"{n} samples, {com_z.shape[0]} com_z, "
                         f"{cube_z.shape[0]} cube_z")
    out = np.empty_like(src)
    get_lib().normalize_batch(_fptr(src), n, hw, _fptr(com_z), _fptr(cube_z),
                              _fptr(out.reshape(n, hw)))
    return out
