"""The PyTorch port stands alone: no module of ``lsps_tpu_torch`` and none
of the root scripts that drive it on the card (``chip_smoke.py``,
``warp_sweep.py``) imports JAX or ``lsps_tpu``, nor
any of ``cv2``, ``PIL``, ``matplotlib``, ``tensorboardX`` and ``orbax``,
which the card's machine lacks (the PNG reader and the augment warps are
numpy; the native augment library is the port's own build).  Checked in
a fresh interpreter, since this test process already holds JAX and cv2.  Also holds the kernel
wrappers (the two warp entries and the four norm kernels) to their
contract: CPU tensors run the plain version, a launch counter exists and
only kernel launches move it, other devices raise; and the crop warp is
the registered op ``lsps::crop_normalize``, whose fake implementation
gives the shapes for a symbolic batch; detection's wrapper
(``serve/detect.py``, the op ``lsps::detect_coms``) to the same contract.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lsps_tpu_torch.ops.kernels import norm_act as N
from lsps_tpu_torch.ops.kernels import warp as W
from lsps_tpu_torch.serve import detect as D

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import lsps_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lsps_tpu_torch.__path__,
                                                "lsps_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, warp_sweep
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "lsps_tpu"))
absent = sorted(m for m in sys.modules if m.split(".")[0] in (
    "cv2", "PIL", "matplotlib", "tensorboardX", "orbax"))
print(json.dumps({"names": names, "bad": bad, "absent": absent}))
"""


def test_port_imports_no_jax_and_no_lsps_tpu():
    res = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out["names"]) >= 58
    # the training augment, the checkpoints, the CLIs, the loader, the
    # daemon, the export, the latent walk, the checkpoint loader, the PNG
    # reader, the real-data importers and datasets, the native augment
    # library's bindings, data parallelism, the contour and colour code,
    # the legacy stacks, the live frame and the three tools are among the
    # modules held
    assert {"lsps_tpu_torch.scripts.realtime_demo",
            "lsps_tpu_torch.scripts.eval_checkpoints",
            "lsps_tpu_torch.scripts.parity_gate",
            "lsps_tpu_torch.data.png",
            "lsps_tpu_torch.data.contours",
            "lsps_tpu_torch.data.color",
            "lsps_tpu_torch.data.stacks",
            "lsps_tpu_torch.utils.realtime",
            "lsps_tpu_torch.data.importers",
            "lsps_tpu_torch.data.datasets",
            "lsps_tpu_torch.data.detector",
            "lsps_tpu_torch.data.fast_augment",
            "lsps_tpu_torch.native",
            "lsps_tpu_torch.data.augment",
            "lsps_tpu_torch.train.checkpoint",
            "lsps_tpu_torch.cli.depth_train",
            "lsps_tpu_torch.cli.pose_train",
            "lsps_tpu_torch.data.loader",
            "lsps_tpu_torch.serve.server",
            "lsps_tpu_torch.serve.export",
            "lsps_tpu_torch.train.torch_convert",
            "lsps_tpu_torch.cli.export_model",
            "lsps_tpu_torch.cli.latent_walk",
            "lsps_tpu_torch.parallel",
            "lsps_tpu_torch.parallel.mesh",
            "lsps_tpu_torch.parallel.multihost",
            "lsps_tpu_torch.ops.common_net",
            "lsps_tpu_torch.utils.raster",
            "lsps_tpu_torch.utils.pdf",
            "lsps_tpu_torch.eval.handpose_evaluation"} <= set(out["names"])
    assert out["bad"] == []
    assert out["absent"] == []


@pytest.mark.parametrize("backend", ["jax", "step"])
def test_loader_without_a_named_device_needs_the_card(backend, monkeypatch):
    """The loader's device augment runs on the card unless a device is
    named; with no card it raises rather than run on the CPU."""
    from lsps_tpu_torch.data import loader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LSPS_AUGMENT", backend)
    ds = loader.get_dataset({
        "seed": 1, "root": "", "subset": "train", "docom": False,
        "augment": True, "sample_poses": 0, "joint_subset": "NYU",
        "n_frames": 4, "n_joints": 36, "class_name": "dataset_hand_synth"})
    if backend == "jax":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loader.get_data_loader(ds, 2, shuffle=True)
    else:
        # warp parameters only until the loader must make images
        lp = loader.get_data_loader(ds, 2, shuffle=True)
        assert lp.raw
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lp.disable_raw()
    named = loader.get_data_loader(ds, 2, shuffle=True, device="cpu")
    assert named.fast and named.raw == (backend == "step")


def test_ranks_without_a_named_device_need_the_card(monkeypatch):
    """``parallel.initialize`` and ``make_mesh`` put the ranks on the card
    unless the CPU is named; with no card they raise rather than fall back
    to the CPU and gloo."""
    import torch.distributed as dist

    from lsps_tpu_torch.parallel import initialize, make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device == torch.device("cpu")
    assert (mesh.data.rank, mesh.data.world) == (0, 1)


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


def _crop_inputs(device="cpu"):
    rs = np.random.RandomState(2)
    frames = torch.from_numpy(rs.uniform(0, 1000, (2, 40, 50))
                              .astype(np.float32))
    coms = torch.tensor([[25.0, 20.0, 600.0], [0.0, 0.0, 0.0]])
    cubes = torch.full((2, 3), 300.0)
    return tuple(t.to(device) for t in (frames, coms, cubes))


def test_crop_cpu_tensors_take_the_plain_version():
    args = _crop_inputs()
    before = W.crop_normalize.launches
    crops, Ms = W.crop_normalize(*args, 588.0, 587.0, (16, 12))
    want, want_M = W.crop_normalize_reference(*args, 588.0, 587.0, (16, 12))
    assert crops.shape == (2, 12, 16) and torch.equal(crops, want)
    assert torch.equal(Ms.isnan(), want_M.isnan())
    assert torch.equal(Ms.nan_to_num(), want_M.nan_to_num())
    assert isinstance(W.crop_normalize.launches, int)
    assert W.crop_normalize.launches == before


def test_crop_other_devices_raise():
    with pytest.raises(ValueError, match="meta"):
        W.crop_normalize(*_crop_inputs("meta"), 588.0, 587.0)


_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "int": "c_int",
            "float": "c_float"}


def _c_entries(src):
    """{name: [ctypes type name per parameter]} of each ``extern "C"``
    function of a CUDA source."""
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        types = []
        for p in params.split(","):
            ctype = " ".join(p.split()[:-1]).replace(" *", "*")
            types.append(_C_TYPES[ctype])
        entries[name] = types
    return entries


def test_warp_entries_match_the_wrapper_signatures():
    """Each entry of warp.cu (the loaded-index and the computed-index
    warp) takes what its ctypes signature passes."""
    from lsps_tpu_torch.ops.kernels import build

    entries = _c_entries((build.CSRC / "warp.cu").read_text())
    assert set(entries) == {"lsps_warp_normalize", "lsps_crop_normalize"}
    for name, argtypes in W._SIGNATURES.items():
        assert entries[name] == [t.__name__ for t in argtypes], name


def test_kernel_source_and_build_flags():
    """The kernel is built for sm_90a from the package's own source, with
    no fast-math flag (the tail's division must stay IEEE)."""
    from lsps_tpu_torch.ops.kernels import build

    assert (build.CSRC / "warp.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast" in f for f in build.NVCC_FLAGS)
    assert build.library_path("warp").parent == ROOT / "build"


def _norm_inputs(device="cpu"):
    rs = np.random.RandomState(1)
    x, res, g = (torch.from_numpy(rs.randn(2, 3, 5, 4).astype(np.float32))
                 .to(device) for _ in range(3))
    stats = torch.ones(2, 3, 1, 1, device=device)
    return {
        "in_act_forward": ((x, N.SLOPE), N.in_act_forward_reference),
        "in_act_backward": ((g, x, stats, N.SLOPE),
                            N.in_act_backward_reference),
        "in_res_forward": ((x, res), N.in_res_forward_reference),
        "in_res_backward": ((g, x, stats, stats),
                            N.in_res_backward_reference),
    }


@pytest.mark.parametrize("name", sorted(N.KERNELS))
def test_norm_cpu_tensors_take_the_plain_version(name):
    args, plain = _norm_inputs()[name]
    wrapper = N.KERNELS[name]
    before = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert isinstance(wrapper.launches, int)
    assert wrapper.launches == before


@pytest.mark.parametrize("name", sorted(N.KERNELS))
def test_norm_other_devices_raise(name):
    args, _ = _norm_inputs("meta")[name]
    with pytest.raises(ValueError, match="meta"):
        N.KERNELS[name](*args)


def test_norm_kernel_source_is_built():
    from lsps_tpu_torch.ops.kernels import SOURCES, build

    assert "norm_act" in SOURCES
    assert (build.CSRC / "norm_act.cu").is_file()
    src = (build.CSRC / "norm_act.cu").read_text()
    for name in ("lsps_in_act_fwd", "lsps_in_act_bwd", "lsps_in_res_fwd",
                 "lsps_in_res_bwd"):
        assert f'extern "C" int {name}(' in src
        assert name in N._SIGNATURES


def test_crop_is_a_registered_op_with_a_fake():
    """``crop_normalize`` goes through ``torch.ops.lsps.crop_normalize``:
    on the CPU its implementation is the plain version, and under a fake
    tensor mode with a symbolic batch its fake gives (B, dh, dw) crops and
    (B, 3, 3) affines in float32, with no launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    frames, coms, cubes = _crop_inputs()
    crops, Ms = torch.ops.lsps.crop_normalize(frames, coms, cubes, 588.0,
                                              587.0, 16, 12)
    want, _ = W.crop_normalize_reference(frames, coms, cubes, 588.0, 587.0,
                                         (16, 12))
    assert torch.equal(crops, want)
    before = W.crop_normalize.launches
    with FakeTensorMode(shape_env=ShapeEnv()) as mode:
        fake = [mode.from_tensor(t, static_shapes=False)
                for t in (frames, coms, cubes)]
        c, m = W.crop_normalize(*fake, 588.0, 587.0, (16, 12))
        assert c.dtype == m.dtype == torch.float32
        assert not isinstance(c.shape[0], int)
        assert tuple(c.shape[1:]) == (12, 16) and tuple(m.shape[1:]) == (3, 3)
        assert c.shape[0] == fake[0].shape[0] == m.shape[0]
    assert W.crop_normalize.launches == before


def _detect_inputs(device="cpu"):
    rs = np.random.RandomState(3)
    frames = torch.from_numpy(rs.randint(0, 1200, (2, 30, 40))
                              .astype(np.uint16))
    frames[:, 8:22, 10:30] = 700
    cubes = torch.full((2, 3), 300.0)
    return frames.to(device), cubes.to(device)


def test_detect_cpu_tensors_take_the_plain_version():
    frames, cubes = _detect_inputs()
    before = D.device_detect_batch.launches
    got = D.device_detect_batch(frames, cubes, 588.0, 587.0,
                                interior_min=20)
    want = D.device_detect_batch_reference(frames, cubes, 588.0, 587.0,
                                           interior_min=20)
    assert torch.equal(got, want) and bool(want[:, 2].gt(0).all())
    assert isinstance(D.device_detect_batch.launches, int)
    assert D.device_detect_batch.launches == before


def test_detect_other_devices_raise():
    with pytest.raises(ValueError, match="meta"):
        D.device_detect_batch(*_detect_inputs("meta"), 588.0, 587.0)


def test_detect_entries_match_the_wrapper_signatures():
    """Each entry of detect.cu (the workspace size and the launch) takes
    what its ctypes signature passes."""
    from lsps_tpu_torch.ops.kernels import build

    entries = _c_entries((build.CSRC / "detect.cu").read_text())
    assert set(entries) == {"lsps_detect_workspace", "lsps_detect_coms"}
    for name, argtypes in D._SIGNATURES.items():
        assert entries[name] == [t.__name__ for t in argtypes], name


def test_detect_kernel_source_is_built():
    """The detection kernel is one of the package's sources, built for
    sm_90a into the checkout's ``build/`` like the others, and no entry of
    it is a fast-math intrinsic of a division."""
    from lsps_tpu_torch.ops.kernels import SOURCES, build

    assert "detect" in SOURCES
    src = (build.CSRC / "detect.cu").read_text()
    assert "__fdividef" not in src and "__frcp" not in src
    assert build.library_path("detect").parent == ROOT / "build"
