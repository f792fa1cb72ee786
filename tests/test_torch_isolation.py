"""The PyTorch port stands alone: no module of ``lsps_tpu_torch`` and not
``chip_smoke.py`` imports JAX or ``lsps_tpu``.  Checked in a fresh
interpreter, since this test process already holds JAX.  Also holds the
warp wrapper to its contract: CPU tensors run the plain version, a launch
counter exists and only kernel launches move it, other devices raise.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lsps_tpu_torch.ops.kernels import warp as W

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import lsps_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lsps_tpu_torch.__path__,
                                                "lsps_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lsps_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_lsps_tpu():
    res = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(maxsplit=1)
    assert int(n_modules) >= 15
    assert bad.strip() == "[]"


def _inputs():
    rs = np.random.RandomState(0)
    frames = torch.from_numpy(rs.uniform(0, 1000, (2, 20, 30))
                              .astype(np.float32))
    iy = torch.from_numpy(rs.randint(-1, 20, (2, 8)).astype(np.int32))
    ix = torch.from_numpy(rs.randint(-1, 30, (2, 8)).astype(np.int32))
    par = torch.tensor([[400.0, 700.0, 550.0, 150.0]] * 2)
    return frames, iy, ix, par


def test_cpu_tensors_take_the_plain_version():
    args = _inputs()
    before = W.warp_normalize.launches
    assert torch.equal(W.warp_normalize(*args),
                       W.warp_normalize_reference(*args))
    assert isinstance(W.warp_normalize.launches, int)
    assert W.warp_normalize.launches == before


def test_other_devices_raise():
    frames, iy, ix, par = (t.to("meta") for t in _inputs())
    with pytest.raises(ValueError, match="meta"):
        W.warp_normalize(frames, iy, ix, par)


def test_kernel_source_and_build_flags():
    """The kernel is built for sm_90a from the package's own source, with
    no fast-math flag (the tail's division must stay IEEE)."""
    from lsps_tpu_torch.ops.kernels import build

    assert (build.CSRC / "warp.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast" in f for f in build.NVCC_FLAGS)
    assert build.library_path("warp").parent == ROOT / "build"
