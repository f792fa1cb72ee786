"""Build a CUDA source of ``lsps_tpu_torch/csrc`` and load it with ctypes.

Each source is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into ``build/`` at the root of the checkout (listed in ``.gitignore``),
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  ``compile_source`` also
takes preprocessor definitions, for a variant of a source built beside the
one the package loads (``warp_sweep.py`` builds the crop warp's block
shapes so).  The sources have a plain C interface; no PyTorch header is
compiled.  Nothing here runs at import.
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit that PyTorch finds, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lsps_tpu_torch need the CUDA toolkit")
    return found


def _flags(defines: Sequence[str]) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def compile_source(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` for each of ``defines``,
    such as ``"LSPS_WARP_THREADS=256"``) unless its library is already
    built; returns the library's path.  Safe to run in several processes:
    the library is written to a temporary name and renamed into place."""
    lib = library_path(name, defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *_flags(defines), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(compile_source(name)))
        return _LOADED[name]
